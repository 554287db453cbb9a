// Fused encoder of the VAE-HMM for Hopper (sm_90a):
//   conv3+ReLU -> mask -> conv3+ReLU -> 1x1 -> regime logits
// in one launch, x read once and the logits written once.
//
// Replaces the TPU kernel
// vqvaehmm_tpu/ops/pallas_encoder.py::_encoder_kernel.  The Python wrapper
// and its plain PyTorch version are in
// vqvaehmm_tpu_torch/ops/fused_encoder.py; the stages themselves are the
// device functions of encoder_tile.cuh, which the evidence and decode
// kernels share.
//
// Layout: x (B, C, T), logits (B, K, T), float32, contiguous along T;
// valid_to (B,) int32; the weights are the torch modules' own tensors.
//
// Design.  One block computes TILE steps of one sequence, so the grid is
// B * ceil(T / TILE) blocks: the bulk scorer's stack of many short windows
// and a whole panel of one long sequence both spread over the card, and
// nothing depends on B.  x is staged with a halo of 2 steps a side, h1 and
// h2 stay in shared memory (about 17 KB a block at the published widths),
// the weights (about 29 KB) come through the read-only cache.
//
// Bound.  A token costs about 14.4 kFLOP (fp32 FMA on the CUDA cores)
// against 32 bytes of input and output at the published widths, so the
// kernel is bound by arithmetic and by the shared-memory loads that feed
// it, not by device memory.  A thread computes 4 neighbouring steps of one
// output channel, so a weight feeds 4 FMAs and neighbouring taps share
// their loads.

#include <cuda_runtime.h>
#include <climits>
#include <cstddef>

#include "encoder_tile.cuh"

namespace {

using namespace vqhmm;

// TILE, WS and THREADS are encoder_tile.cuh's

__global__ void __launch_bounds__(THREADS) fused_encoder_kernel(
    const float* __restrict__ x, const int* __restrict__ valid_to,
    EncoderWeights W, float* __restrict__ logits, int C, int T, int H1,
    int H2, int K, int tiles) {
  extern __shared__ float smem[];
  float* xs = smem;               // C rows
  float* h1 = xs + C * WS;        // H1 rows
  float* h2 = h1 + H1 * WS;       // H2 rows
  float* lg = h2 + H2 * WS;       // K rows

  const int b = blockIdx.x / tiles;
  const int t0 = (blockIdx.x - b * tiles) * TILE;
  const int n = min(TILE, T - t0);
  encoder_tile(x + (size_t)b * C * T, W, C, T, H1, H2, K, t0, n, WS,
               valid_to[b], xs, h1, h2, lg);
  for (int idx = threadIdx.x; idx < K * n; idx += blockDim.x) {
    const int k = idx / n, jj = idx - k * n;
    logits[((size_t)b * K + k) * T + t0 + jj] = lg[k * WS + ENC_HALO + jj];
  }
}

}  // namespace

extern "C" int vqhmm_fused_encode_smem_bytes(int C, int H1, int H2, int K) {
  return (int)(sizeof(float) * WS * (C + H1 + H2 + K));
}

extern "C" int vqhmm_fused_encode(
    const float* x, const int* valid_to, const float* ew1, const float* eb1,
    const float* ew2, const float* eb2, const float* ew3, const float* eb3,
    float* logits, int B, int C, int T, int H1, int H2, int K, void* stream) {
  const int smem = vqhmm_fused_encode_smem_bytes(C, H1, H2, K);
  const int tiles = (T + TILE - 1) / TILE;
  const long long blocks = (long long)tiles * B;
  if (B <= 0 || T <= 0 || blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_encoder_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  EncoderWeights W{ew1, eb1, ew2, eb2, ew3, eb3};
  fused_encoder_kernel<<<(unsigned)blocks, THREADS, smem,
                         (cudaStream_t)stream>>>(x, valid_to, W, logits, C, T,
                                                 H1, H2, K, tiles);
  return (int)cudaGetLastError();
}
