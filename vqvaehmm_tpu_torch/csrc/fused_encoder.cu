// Fused encoder of the VAE-HMM for Hopper (sm_90a):
//   conv3+ReLU -> mask -> conv3+ReLU -> 1x1 -> regime logits
// in one launch, x read once and the logits written once; and the pack
// kernel that lays out the weights of this kernel and of the evidence
// kernel (fused_decode.cu) in staging order.
//
// Replaces the TPU kernel
// vqvaehmm_tpu/ops/pallas_encoder.py::_encoder_kernel.  The Python wrapper,
// its launch plan, the packed-weight cache and the plain PyTorch version
// are in vqvaehmm_tpu_torch/ops/fused_encoder.py; the stages are the device
// functions of encoder_fma.cuh, which the evidence kernel shares.
//
// Layout: x (B, C, T), logits (B, K, T), float32, contiguous along T;
// valid_to (B,) int32; the weights packed once a model by
// vqhmm_encoder_pack (tile_fma.cuh's order), the biases the torch tensors.
//
// Design.  One block computes `tile` steps of one sequence, tile one of
// 16, 32 or 64 chosen by the wrapper from the waves of resident blocks,
// so the grid is B * ceil(T / tile) blocks: the bulk scorer's stack of
// many short windows and a whole panel of one long sequence both spread
// over the card.  The three layers go through tile_fma.cuh's register
// tile (4 output channels x 4 steps a thread for the two convolutions, a
// (step, regime) a thread for the 1x1), the weights through the two
// double-buffered cp.async slabs; the first slab is in flight while x is
// staged.  All intermediates stay in shared memory.
//
// Bound.  A token costs about 14.4 kFLOP (fp32 FMA on the CUDA cores)
// against 32 bytes of input and output at the published widths, so the
// kernel is bound by arithmetic and by the shared-memory loads that feed
// it, not by device memory; at small B, by one block's chain of three
// layers and their barriers.
//
// The bfloat16-operand mode (the TPU kernel's highest=False, taken by a
// float32 model whose matmul_precision is not "highest"):
// fused_encoder_bf16_kernel, the same grid of (sequence, tile) blocks,
// each layer an implicit GEMM of mma.sync.m16n8k16 through
// encoder_mma.cuh (tile_mma.cuh), the weights packed once a model in mma
// fragment order by encoder_pack_bf16_kernel and read from L2, x rounded
// to bfloat16 as it is staged, and the logits written from the last
// layer's epilogue.  Its bound is the card's dense bf16 rate, 989
// TFLOP/s, against which 14.4 kFLOP a token leaves it bound by bytes at
// every shape; what holds it there is one block's chain of three layers
// and their barriers.

#include <cuda_runtime.h>
#include <climits>
#include <cstddef>

#include "encoder_fma.cuh"
#include "encoder_mma.cuh"

namespace {

using encfma::Dims;

constexpr int NPACK = 5;
struct PackJobs {
  tilefma::PackJob j[NPACK];
};

__global__ void __launch_bounds__(256) encoder_pack_kernel(PackJobs jobs,
                                                           int njobs,
                                                           float* __restrict__ dst) {
  tilefma::pack_weights(jobs.j, njobs, dst);
}

__global__ void __launch_bounds__(encfma::MAX_THREADS, 2) fused_encoder_kernel(
    const float* __restrict__ x, const int* __restrict__ valid_to,
    encfma::Weights W, float* __restrict__ logits, Dims d, int T, int tile,
    int tiles) {
  extern __shared__ __align__(16) float smem[];
  const int WS = encfma::row_stride(tile);
  const encfma::Rows s = encfma::carve(smem, d, WS);
  tilefma::Pipe pipe{smem, 0, false};
  const int b = blockIdx.x / tiles;
  const int t0 = (blockIdx.x - b * tiles) * tile;
  const int n = min(tile, T - t0);
  encfma::encoder_stage(x + (size_t)b * d.C * T, W, d, T, t0, n, WS,
                        valid_to[b], s, pipe, tilefma::no_next());
  for (int idx = threadIdx.x; idx < d.K * n; idx += blockDim.x) {
    const int k = idx / n, jj = idx - k * n;
    logits[((size_t)b * d.K + k) * T + t0 + jj] =
        s.lg[k * WS + encfma::HALO + jj] + __ldg(W.eb3 + k);
  }
}

struct MmaPackJobs {
  tilemma::PackJob j[NPACK];
};

__global__ void __launch_bounds__(256) encoder_pack_bf16_kernel(
    MmaPackJobs jobs, int njobs, tilemma::bf16* __restrict__ dst) {
  tilemma::pack_fragments(jobs.j, njobs, dst);
}

__global__ void __launch_bounds__(encmma::THREADS, encmma::BLOCKS_PER_SM)
    fused_encoder_bf16_kernel(const float* __restrict__ x,
                              const int* __restrict__ valid_to,
                              const tilemma::bf16* __restrict__ wp,
                              const float* __restrict__ eb1,
                              const float* __restrict__ eb2,
                              const float* __restrict__ eb3,
                              float* __restrict__ logits, Dims d, int T,
                              int tile, int tiles) {
  extern __shared__ __align__(16) unsigned char smem_b[];
  const encmma::Ops s = encmma::carve(smem_b, d, tile);
  const int b = blockIdx.x / tiles;
  const int t0 = (blockIdx.x - b * tiles) * tile;
  const int n = min(tile, T - t0);
  // the logits of the tile's own steps, biased, straight to the output
  const tilemma::Out out{eb3, false, false, 0, nullptr,
                         logits + (size_t)b * d.K * T, nullptr, 0, nullptr,
                         0};
  encmma::encoder_stage(x + (size_t)b * d.C * T, wp, eb1, eb2, d, T, t0, n,
                        valid_to[b], s, out);
}

}  // namespace

// Values of the packed weights (floats; bf16: the bfloat16 mode's bfloat16
// values in mma fragment order, encoder_mma.cuh): the encoder's three
// layers, then, where HP > 0, the prior's two.
extern "C" long long vqhmm_encoder_packed_floats(int C, int H1, int H2, int K,
                                                 int U, int HP, int bf16) {
  const Dims d{C, H1, H2, K, U, HP};
  return bf16 ? encmma::packed(d).total : encfma::packed(d).total;
}

// Pack the torch weights (Conv1d (O, I, 3) / (K, H2, 1), Linear (HP, U) /
// (K*K, HP); pw1 and pw2 unused where HP = 0) into dst: floats, or with
// bf16 rounded to bfloat16 in mma fragment order
// (tile_mma.cuh::pack_fragments).
extern "C" int vqhmm_encoder_pack(const float* ew1, const float* ew2,
                                  const float* ew3, const float* pw1,
                                  const float* pw2, void* dst, int C, int H1,
                                  int H2, int K, int U, int HP, int bf16,
                                  void* stream) {
  const Dims d{C, H1, H2, K, U, HP};
  const long long total = vqhmm_encoder_packed_floats(C, H1, H2, K, U, HP,
                                                      bf16);
  if (total <= 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((total + 255) / 256);
  if (bf16) {
    MmaPackJobs jobs;
    const int njobs = encmma::pack_jobs(d, ew1, ew2, ew3, pw1, pw2, jobs.j);
    encoder_pack_bf16_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
        jobs, njobs, reinterpret_cast<tilemma::bf16*>(dst));
  } else {
    PackJobs jobs;
    const int njobs = encfma::pack_jobs(d, ew1, ew2, ew3, pw1, pw2, jobs.j);
    encoder_pack_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
        jobs, njobs, reinterpret_cast<float*>(dst));
  }
  return (int)cudaGetLastError();
}

// Dynamic shared memory of a block at tile width `tile`; bf16: the
// bfloat16-operand mode's.
extern "C" int vqhmm_fused_encode_smem_bytes(int C, int H1, int H2, int K,
                                             int tile, int bf16) {
  const Dims d{C, H1, H2, K, 0, 0};
  return bf16 ? encmma::smem_bytes(d, tile) : encfma::smem_bytes(d, tile);
}

// packed_weights as vqhmm_encoder_pack lays them out in the same mode (HP
// = 0, or the evidence's, whose first three layers are these).  bf16: the
// bfloat16-operand mode, which stages no weights (no weight-buffer bound).
extern "C" int vqhmm_fused_encode(
    const float* x, const int* valid_to, const void* packed_weights,
    const float* eb1, const float* eb2, const float* eb3, float* logits,
    int B, int C, int T, int H1, int H2, int K, int tile, int bf16,
    void* stream) {
  const Dims d{C, H1, H2, K, 0, 0};
  const int smem = vqhmm_fused_encode_smem_bytes(C, H1, H2, K, tile, bf16);
  if (!encfma::tile_ok(tile) || B <= 0 || T <= 0 || K <= 0 ||
      !(bf16 || encfma::layers_fit(d)) || smem > encfma::SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const int tiles = (T + tile - 1) / tile;
  const long long blocks = (long long)tiles * B;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const void* kernel = bf16 ? (const void*)fused_encoder_bf16_kernel
                            : (const void*)fused_encoder_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    fused_encoder_bf16_kernel<<<(unsigned)blocks, encmma::THREADS, smem,
                                st>>>(
        x, valid_to, reinterpret_cast<const tilemma::bf16*>(packed_weights),
        eb1, eb2, eb3, logits, d, T, tile, tiles);
  } else {
    const encfma::Weights W{reinterpret_cast<const float*>(packed_weights),
                            eb1, eb2, eb3, nullptr, nullptr};
    const int G = H1 > H2 ? H1 : H2;
    fused_encoder_kernel<<<(unsigned)blocks, encfma::block_threads(tile, G),
                           smem, st>>>(x, valid_to, W, logits, d, T, tile,
                                       tiles);
  }
  return (int)cudaGetLastError();
}
