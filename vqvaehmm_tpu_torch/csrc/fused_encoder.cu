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
// and their barriers, and in each layer its weights, read from L2 on the
// chain's critical path (PERF.md, chip_smoke.py --scan-clocks).  Its
// second design, fused_encoder_bf16_staged_kernel, stages the three
// layers' weights in shared memory ahead of the chain
// (tile_mma.cuh::staged_layer: resident, by TMA bulk copies; a ring of
// slots for a model whose weights do not fit beside the operands) and
// walks the items on a persistent grid of the blocks that stay resident,
// each staging its weights once and fetching its next item's x while the
// item before it computes (fused_infer.cu's walk).  The sums are the
// first design's, so are the logits, bit for bit.  The wrapper's plan
// (ops/fused_encoder.py::encode_design) takes the second where a block
// computes few steps, whose layers wait on their weights, and the first
// where a block computes 64, whose mma hide that wait (PERF.md), and
// where not even two ring slots fit.

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

// Kernel 8's second design in the mode: after the operands
// (encmma::smem_bytes), where the weights are RESIDENT the next item's raw
// x window (C rows of op_rows(tile) floats), then the control region and
// the three layers' packed values, as tile_mma.cuh::stage_plan places
// them (RING: the control region and the slots; DIRECT: the operands
// alone, the first design's block).
__host__ __device__ inline tilemma::StagePlan encode_stage(const Dims& d,
                                                           int tile) {
  return tilemma::stage_plan(encmma::smem_bytes(d, tile),
                             4LL * d.C * encmma::op_rows(tile),
                             encmma::packed(d).total, encfma::SMEM_LIMIT);
}

// Blocks of the second design an SM at most: __launch_bounds__(THREADS,
// 2), up to 128 registers a thread (at 3 an SM, 80, it spilled).
constexpr int STAGED_BLOCKS_PER_SM = 2;

// The items (sequence, tile) blockIdx.x, blockIdx.x + gridDim.x, ... of a
// grid of `items` at most, the weights staged once a block ahead of its
// chain of three layers (tile_mma.cuh::staged_layer; RESIDENT or RING, one
// instance each) and, where RESIDENT, each item's raw x window fetched
// with cp.async while the item before it computes; each item's layers
// and sums are fused_encoder_bf16_kernel's.
template <int KIND>
__global__ void __launch_bounds__(encmma::THREADS, STAGED_BLOCKS_PER_SM)
    fused_encoder_bf16_staged_kernel(const float* __restrict__ x,
                                     const int* __restrict__ valid_to,
                                     const tilemma::bf16* __restrict__ wp,
                                     const float* __restrict__ eb1,
                                     const float* __restrict__ eb2,
                                     const float* __restrict__ eb3,
                                     float* __restrict__ logits, Dims d,
                                     int T, int tile, int tiles, int items) {
  extern __shared__ __align__(16) unsigned char smem_b[];
  using tilemma::ChainLayer;
  using tilemma::Out;
  const encmma::Ops s = encmma::carve(smem_b, d, tile);
  constexpr bool prefetch = KIND == tilemma::RESIDENT;
  unsigned char* after = smem_b + encmma::smem_bytes(d, tile);
  float* xraw = reinterpret_cast<float*>(after);  // C rows of NR floats
  if (prefetch) after += sizeof(float) * d.C * s.NR;
  tilemma::Staged st;
  st.slots = encode_stage(d, tile).slots;
  st.wp = wp;
  st.bar = reinterpret_cast<uint64_t*>(after);
  st.ring_chain = reinterpret_cast<ChainLayer*>(
      after + 8 * 2 * tilemma::RING_SLOTS);
  st.sw = reinterpret_cast<tilemma::bf16*>(after + tilemma::CTRL_BYTES);
  st.l0 = 0;
  st.l1 = 3;
  // each layer computed from the widths where it is asked for, so that
  // nothing of the chain stays live in registers across the walk
  const auto chain = [&](int l) {
    const encmma::Packed at = encmma::packed(d);
    switch (l) {
      case 0: return ChainLayer{at.w1, d.H1, d.C, 3, 1, 1};
      case 1: return ChainLayer{at.w2, d.H2, d.H1, 3, 2, 2};
      case 2: return ChainLayer{at.w3, d.K, d.H2, 1, 2, 2};
      default: return ChainLayer{0, 0, 0, 0, 0, 0};
    }
  };

  // the raw x window of an item into xraw, the steps inside [0, T) and
  // before valid_to alone (the staging zeroes the rest): one cp.async
  // group
  auto fetch_x = [&](int item) {
    const int b = item / tiles;
    const int t0 = (item - b * tiles) * tile;
    const int W = min(tile, T - t0) + 2 * encfma::HALO;
    const int vt = valid_to[b];
    const float* xb = x + (size_t)b * d.C * T;
    for (int idx = threadIdx.x; idx < d.C * W; idx += blockDim.x) {
      const int c = idx / W, j = idx - c * W;
      const int p = t0 - encfma::HALO + j;
      if (!encfma::outside(p, T, vt))
        tilefma::cp_async4_zfill(xraw + c * s.NR + j, xb + (size_t)c * T + p,
                                 true);
    }
    tilefma::cp_async_commit();
  };

  // the weights: the first layers' bulk copies in flight (RESIDENT) while
  // x is staged
  tilemma::stage_start<KIND>(st, chain);
  bool fetched = false;     // this item's raw x prefetched into xraw
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int b = item / tiles;
    const int t0 = (item - b * tiles) * tile;
    const int n = min(tile, T - t0);
    const int W = n + 2 * encfma::HALO;
    const int p0 = t0 - encfma::HALO;
    const int vt = valid_to[b];
    const float* xb = x + (size_t)b * d.C * T;
    const tilemma::Win win{p0, T, t0, n};
    tilemma::stage_item<KIND>(st, chain, W, p0);
    // x on the whole window, zero outside [0, T) and past valid_to and in
    // the padding channels, rounded to bfloat16 (encoder_stage's)
    if (fetched) {
      tilefma::cp_async_wait<0>();
      __syncthreads();
    }
    const int C16 = tilemma::round16(d.C);
    for (int idx = threadIdx.x; idx < C16 * W; idx += blockDim.x) {
      const int c = idx / W, j = idx - c * W;
      const int p = p0 + j;
      float v = 0.f;
      if (c < d.C && !encfma::outside(p, T, vt))
        v = fetched ? xraw[c * s.NR + j] : xb[(size_t)c * T + p];
      s.xo[j * s.RC + c] = __float2bfloat16_rn(v);
    }
    __syncthreads();
    // the next item's x in flight while this one computes
    fetched = prefetch && item + (int)gridDim.x < items;
    if (fetched) fetch_x(item + gridDim.x);
    // h1 = relu(conv1(x)), zero outside the sequence and past valid_to;
    // h2 = relu(conv2(h1)) on the tile, not masked; the logits of the
    // tile's own steps, biased, straight to the output
    tilemma::staged_layer<3, KIND>(st, chain, 0, s.xo, s.RC, s.NR,
                                   Out{eb1, true, true, vt, nullptr, nullptr,
                                       nullptr, 0, s.a, s.RG}, win);
    tilemma::staged_layer<3, KIND>(st, chain, 1, s.a, s.RG, s.NR,
                                   Out{eb2, true, false, T, nullptr, nullptr,
                                       nullptr, 0, s.b, s.RG}, win);
    tilemma::staged_layer<1, KIND>(st, chain, 2, s.b, s.RG, s.NR,
                                   Out{eb3, false, false, 0, nullptr,
                                       logits + (size_t)b * d.K * T, nullptr,
                                       0, nullptr, 0}, win);
  }
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
// bfloat16-operand mode's, staged: its second design's (encode_stage).
extern "C" int vqhmm_fused_encode_smem_bytes(int C, int H1, int H2, int K,
                                             int tile, int bf16, int staged) {
  const Dims d{C, H1, H2, K, 0, 0};
  if (!bf16) return encfma::smem_bytes(d, tile);
  return staged ? encode_stage(d, tile).bytes : encmma::smem_bytes(d, tile);
}

// packed_weights as vqhmm_encoder_pack lays them out in the same mode (HP
// = 0, or the evidence's, whose first three layers are these).  bf16: the
// bfloat16-operand mode (no weight-buffer bound); grid 0 its first design
// (a block an item, the weights read from L2; the float32 mode passes 0),
// 1 to B * ceil(T / tile) its second, on that many blocks, the weights
// where encode_stage puts them (an error where that is L2).
extern "C" int vqhmm_fused_encode(
    const float* x, const int* valid_to, const void* packed_weights,
    const float* eb1, const float* eb2, const float* eb3, float* logits,
    int B, int C, int T, int H1, int H2, int K, int tile, int bf16, int grid,
    void* stream) {
  const Dims d{C, H1, H2, K, 0, 0};
  const int smem = vqhmm_fused_encode_smem_bytes(C, H1, H2, K, tile, bf16,
                                                 grid > 0);
  if (!encfma::tile_ok(tile) || B <= 0 || T <= 0 || K <= 0 ||
      !(bf16 || encfma::layers_fit(d)) || smem > encfma::SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const int tiles = (T + tile - 1) / tile;
  const long long blocks = (long long)tiles * B;
  if (blocks > INT_MAX || grid < 0 || grid > blocks || (grid && !bf16))
    return (int)cudaErrorInvalidValue;
  const int kind = grid ? encode_stage(d, tile).kind : tilemma::DIRECT;
  if (grid && kind == tilemma::DIRECT) return (int)cudaErrorInvalidValue;
  const void* kernel =
      !bf16 ? (const void*)fused_encoder_kernel
      : kind == tilemma::RESIDENT
          ? (const void*)fused_encoder_bf16_staged_kernel<tilemma::RESIDENT>
      : kind == tilemma::RING
          ? (const void*)fused_encoder_bf16_staged_kernel<tilemma::RING>
          : (const void*)fused_encoder_bf16_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const tilemma::bf16* wp =
      reinterpret_cast<const tilemma::bf16*>(packed_weights);
  if (bf16 && kind == tilemma::RESIDENT) {
    fused_encoder_bf16_staged_kernel<tilemma::RESIDENT>
        <<<(unsigned)grid, encmma::THREADS, smem, st>>>(
            x, valid_to, wp, eb1, eb2, eb3, logits, d, T, tile, tiles,
            (int)blocks);
  } else if (bf16 && kind == tilemma::RING) {
    fused_encoder_bf16_staged_kernel<tilemma::RING>
        <<<(unsigned)grid, encmma::THREADS, smem, st>>>(
            x, valid_to, wp, eb1, eb2, eb3, logits, d, T, tile, tiles,
            (int)blocks);
  } else if (bf16) {
    fused_encoder_bf16_kernel<<<(unsigned)blocks, encmma::THREADS, smem,
                                st>>>(x, valid_to, wp, eb1, eb2, eb3, logits,
                                      d, T, tile, tiles);
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
