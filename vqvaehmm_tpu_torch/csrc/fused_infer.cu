// Fused serving forward of the VAE-HMM for Hopper (sm_90a):
//   encoder  conv3+ReLU -> conv3+ReLU -> 1x1 -> logits
//   softmax  q over the K regimes
//   codebook e = E^T q
//   decoder  conv3+ReLU -> conv3+ReLU -> 1x1 -> (mu, logvar)
//
// Replaces the TPU kernel vqvaehmm_tpu/ops/pallas_infer.py::_kernel.  The
// Python wrapper and its plain PyTorch version are in
// vqvaehmm_tpu_torch/ops/fused_infer.py.
//
// Layout: x (B, C, T), outputs mu/logvar (B, C, T) and q (B, K, T), all
// float32 and contiguous along T; the weights are the torch modules' own
// tensors (Conv1d (O, I, W), Embedding (K, D)).
//
// Design.  One block computes TILE output steps of one sequence.  It
// stages x with a HALO of 4 steps on each side in shared memory: each of
// the four k=3 convolutions consumes one step of halo.  Every
// intermediate stays in shared memory, in two ping-pong buffers of
// max(H1, H2, D) rows; the weights (about 130 KB at the published widths)
// are read through the read-only cache and L2.  Arithmetic is fp32 FMA on
// the CUDA cores: at the published widths a token costs about 65 kFLOP
// against 72 bytes of input and output, so the kernel is bound by
// arithmetic and by shared-memory loads, not by device memory.  Each
// thread computes JB neighbouring time steps of one output channel, so a
// weight loaded once feeds JB FMAs and neighbouring taps share loads.
//
// Semantics that must hold (vqvaehmm_tpu/models/vae_hmm.py encode/decode):
//  * every convolution pads its own input with zeros at the sequence
//    ends, so h1, e and hd1 are zero outside [0, T), not values computed
//    from zero-padded x (e there would be E^T softmax(bias));
//  * valid_to[b] zeroes x, h1, e and hd1 at t >= valid_to[b], and nothing
//    else: h2, hd2 and the outputs past valid_to are computed and written;
//  * the softmax clamps the row max at -1e30 before the exp
//    (vqvaehmm_tpu/ops/pallas_infer.py:79-84);
//  * nothing depends on B or on another row: the tiling follows T alone
//    and each output's summation order is fixed, so a row of a batch is
//    bit-identical to the same row computed alone.

#include <cuda_runtime.h>
#include <climits>
#include <cstddef>

namespace {

constexpr int TILE = 64;               // output time steps per block
constexpr int HALO = 4;                // one step per k=3 convolution
constexpr int WIN = TILE + 2 * HALO;   // staged window
constexpr int JB = 4;                  // time steps per thread in a conv
constexpr int WS = WIN + JB;           // row stride: room for over-reads
constexpr int THREADS = 256;
constexpr float NEG = -1e30f;

__device__ __forceinline__ bool outside(int p, int T, int vt) {
  return p < 0 || p >= T || p >= vt;
}

// out[o][j] = act(b[o] + sum_{i,k} w[o][i][k] * in[i][j - 1 + k]) for j in
// [lo, hi); zero where `mask` and the step lies outside the sequence or
// past valid_to.  Window index j is time p0 + j.
__device__ __forceinline__ void conv3(
    const float* __restrict__ w, const float* __restrict__ bias,
    const float* in, int I, float* out, int O, int lo, int hi,
    int p0, int T, int vt, bool mask) {
  const int groups = (hi - lo + JB - 1) / JB;
  for (int idx = threadIdx.x; idx < O * groups; idx += blockDim.x) {
    const int o = idx / groups;
    const int j0 = lo + (idx - o * groups) * JB;
    const float* wo = w + (size_t)o * I * 3;
    float acc[JB];
#pragma unroll
    for (int r = 0; r < JB; ++r) acc[r] = 0.f;
    for (int i = 0; i < I; ++i) {
      const float w0 = __ldg(wo + 3 * i);
      const float w1 = __ldg(wo + 3 * i + 1);
      const float w2 = __ldg(wo + 3 * i + 2);
      const float* row = in + i * WS + j0 - 1;
      float v[JB + 2];
#pragma unroll
      for (int r = 0; r < JB + 2; ++r) v[r] = row[r];
#pragma unroll
      for (int r = 0; r < JB; ++r)
        acc[r] = fmaf(w2, v[r + 2], fmaf(w1, v[r + 1], fmaf(w0, v[r], acc[r])));
    }
    const float bo = __ldg(bias + o);
#pragma unroll
    for (int r = 0; r < JB; ++r) {
      const int j = j0 + r;
      if (j < hi) {
        float val = fmaxf(acc[r] + bo, 0.f);
        if (mask && outside(p0 + j, T, vt)) val = 0.f;
        out[o * WS + j] = val;
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS) fused_infer_kernel(
    const float* __restrict__ x, const int* __restrict__ valid_to,
    const float* __restrict__ ew1, const float* __restrict__ eb1,
    const float* __restrict__ ew2, const float* __restrict__ eb2,
    const float* __restrict__ ew3, const float* __restrict__ eb3,
    const float* __restrict__ emb,
    const float* __restrict__ dw1, const float* __restrict__ db1,
    const float* __restrict__ dw2, const float* __restrict__ db2,
    const float* __restrict__ dw3, const float* __restrict__ db3,
    float* __restrict__ mu, float* __restrict__ logvar,
    float* __restrict__ q_out,
    int C, int T, int H1, int H2, int K, int D, int tiles, int maxH) {
  extern __shared__ float smem[];
  float* xs = smem;                  // C rows
  float* bufA = xs + C * WS;         // maxH rows
  float* bufB = bufA + maxH * WS;    // maxH rows
  float* qs = bufB + maxH * WS;      // K rows

  const int b = blockIdx.x / tiles;
  const int t0 = (blockIdx.x - b * tiles) * TILE;
  const int p0 = t0 - HALO;
  const int vt = valid_to[b];
  const float* xb = x + (size_t)b * C * T;

  // 1. x on the whole window, zero outside [0, T) and past valid_to
  for (int idx = threadIdx.x; idx < C * WIN; idx += blockDim.x) {
    const int c = idx / WIN, j = idx - c * WIN;
    const int p = p0 + j;
    xs[c * WS + j] = outside(p, T, vt) ? 0.f : xb[(size_t)c * T + p];
  }
  __syncthreads();
  // 2. h1 = relu(conv1(x)), masked
  conv3(ew1, eb1, xs, C, bufA, H1, 1, WIN - 1, p0, T, vt, true);
  __syncthreads();
  // 3. h2 = relu(conv2(h1)), not masked
  conv3(ew2, eb2, bufA, H1, bufB, H2, 2, WIN - 2, p0, T, vt, false);
  __syncthreads();
  // 4. logits = W3 h2 + b3, q = softmax over K (row max clamped at -1e30)
  for (int j = 2 + threadIdx.x; j < WIN - 2; j += blockDim.x) {
    float m = -INFINITY;
    for (int k = 0; k < K; ++k) {
      const float* wk = ew3 + (size_t)k * H2;
      float acc = 0.f;
      for (int i = 0; i < H2; ++i) acc = fmaf(__ldg(wk + i), bufB[i * WS + j], acc);
      const float l = acc + __ldg(eb3 + k);
      qs[k * WS + j] = l;
      m = fmaxf(m, l);
    }
    const float msafe = fmaxf(m, NEG);
    float z = 0.f;
    for (int k = 0; k < K; ++k) {
      const float e = expf(qs[k * WS + j] - msafe);
      qs[k * WS + j] = e;
      z += e;
    }
    for (int k = 0; k < K; ++k) qs[k * WS + j] = qs[k * WS + j] / z;
  }
  __syncthreads();
  // 5. e = E^T q, masked
  for (int idx = threadIdx.x; idx < D * (WIN - 4); idx += blockDim.x) {
    const int d = idx / (WIN - 4), j = 2 + idx - d * (WIN - 4);
    float acc = 0.f;
    for (int k = 0; k < K; ++k) acc = fmaf(qs[k * WS + j], __ldg(emb + (size_t)k * D + d), acc);
    bufA[d * WS + j] = outside(p0 + j, T, vt) ? 0.f : acc;
  }
  __syncthreads();
  // 6. hd1 = relu(dconv1(e)), masked
  conv3(dw1, db1, bufA, D, bufB, D, 3, WIN - 3, p0, T, vt, true);
  __syncthreads();
  // 7. hd2 = relu(dconv2(hd1)), not masked
  conv3(dw2, db2, bufB, D, bufA, D, HALO, WIN - HALO, p0, T, vt, false);
  __syncthreads();
  // 8. (mu, logvar) = W hd2 + b on the tile; q on the tile
  const int n = min(TILE, T - t0);
  for (int idx = threadIdx.x; idx < 2 * C * n; idx += blockDim.x) {
    const int o = idx / n, jj = idx - o * n;
    const float* wo = dw3 + (size_t)o * D;
    float acc = 0.f;
    for (int i = 0; i < D; ++i) acc = fmaf(__ldg(wo + i), bufA[i * WS + HALO + jj], acc);
    const float val = acc + __ldg(db3 + o);
    float* dst = o < C ? mu + ((size_t)b * C + o) * T
                       : logvar + ((size_t)b * C + (o - C)) * T;
    dst[t0 + jj] = val;
  }
  for (int idx = threadIdx.x; idx < K * n; idx += blockDim.x) {
    const int k = idx / n, jj = idx - k * n;
    q_out[((size_t)b * K + k) * T + t0 + jj] = qs[k * WS + HALO + jj];
  }
}

}  // namespace

extern "C" int vqhmm_fused_infer_smem_bytes(int C, int H1, int H2, int K,
                                            int D) {
  const int maxH = H1 > H2 ? (H1 > D ? H1 : D) : (H2 > D ? H2 : D);
  return (int)(sizeof(float) * WS * (C + 2 * maxH + K));
}

extern "C" int vqhmm_fused_infer(
    const float* x, const int* valid_to,
    const float* ew1, const float* eb1, const float* ew2, const float* eb2,
    const float* ew3, const float* eb3, const float* emb,
    const float* dw1, const float* db1, const float* dw2, const float* db2,
    const float* dw3, const float* db3,
    float* mu, float* logvar, float* q,
    int B, int C, int T, int H1, int H2, int K, int D, void* stream) {
  const int maxH = H1 > H2 ? (H1 > D ? H1 : D) : (H2 > D ? H2 : D);
  const int smem = vqhmm_fused_infer_smem_bytes(C, H1, H2, K, D);
  const int tiles = (T + TILE - 1) / TILE;
  const long long blocks = (long long)tiles * B;
  if (B <= 0 || T <= 0 || blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_infer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  fused_infer_kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
      x, valid_to, ew1, eb1, ew2, eb2, ew3, eb3, emb, dw1, db1, dw2, db2, dw3,
      db3, mu, logvar, q, C, T, H1, H2, K, D, tiles, maxH);
  return (int)cudaGetLastError();
}

extern "C" const char* vqhmm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
