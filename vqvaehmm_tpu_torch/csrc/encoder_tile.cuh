// Device functions of the one-kernel Viterbi decode
// (fused_decode.cu::fused_decode_kernel, kernel 10), its only user: the
// VAE-HMM's encoder stack and prior MLP on one chunk of time steps of one
// sequence, every intermediate in shared memory, a thread an output channel
// and 4 steps, the weights read through the read-only cache.  The encoder
// and evidence kernels (8 and 11) moved to encoder_fma.cuh, on
// tile_fma.cuh's register tile; this header goes when kernel 10 is
// redesigned (ROADMAP.md, queue 2b).
//
// A chunk is n output steps starting at time t0.  The encoder stages x on
// the window [t0 - 2, t0 + n + 2): each of the two k=3 convolutions
// consumes one step of halo on each side.  Window index j is time p0 + j
// with p0 = t0 - ENC_HALO; rows have a stride of ws floats, at least
// n + 2 * ENC_HALO + ENC_JB so that a thread's JB-wide read stays in its
// row.
//
// Semantics (vqvaehmm_tpu/models/vae_hmm.py::encode, prior):
//  * every convolution pads its own input with zeros outside [0, T);
//  * x is zeroed at t >= valid_to before conv1 (conv1 at valid_to - 1
//    reads x[valid_to]); h1 is zeroed at t >= valid_to after its ReLU; h2
//    is not masked;
//  * each output is one fixed chain of FMAs (input channel outer, tap
//    inner, bias last), whatever the tile, the block or the batch: a row
//    of a batched call is bit-equal to the row alone, and two kernels
//    that tile differently give the same bits.

#pragma once

#include <cuda_runtime.h>
#include <cstddef>

namespace vqhmm {

constexpr int ENC_HALO = 2;   // one step per k=3 convolution
constexpr int ENC_JB = 4;     // time steps per thread in a convolution
constexpr float NEG_CLAMP = -1e30f;

struct EncoderWeights {
  const float *w1, *b1, *w2, *b2, *w3, *b3;   // Conv1d (O, I, 3), (K, H2, 1)
};

struct PriorWeights {
  const float *w1, *b1, *w2, *b2;             // Linear (HP, U), (K*K, HP)
};

__device__ __forceinline__ bool enc_outside(int p, int T, int vt) {
  return p < 0 || p >= T || p >= vt;
}

// out[o][j] = relu(b[o] + sum_{i,k} w[o][i][k] * in[i][j - 1 + k]) for j in
// [lo, hi); zero where `mask` and the step lies outside the sequence or
// past valid_to.
__device__ __forceinline__ void enc_conv3(
    const float* __restrict__ w, const float* __restrict__ bias,
    const float* in, int I, float* out, int O, int lo, int hi, int ws,
    int p0, int T, int vt, bool mask) {
  const int groups = (hi - lo + ENC_JB - 1) / ENC_JB;
  for (int idx = threadIdx.x; idx < O * groups; idx += blockDim.x) {
    const int o = idx / groups;
    const int j0 = lo + (idx - o * groups) * ENC_JB;
    if (mask) {
      bool any_inside = false;
#pragma unroll
      for (int r = 0; r < ENC_JB; ++r)
        any_inside |= j0 + r < hi && !enc_outside(p0 + j0 + r, T, vt);
      if (!any_inside) {
#pragma unroll
        for (int r = 0; r < ENC_JB; ++r)
          if (j0 + r < hi) out[o * ws + j0 + r] = 0.f;
        continue;
      }
    }
    const float* wo = w + (size_t)o * I * 3;
    float acc[ENC_JB];
#pragma unroll
    for (int r = 0; r < ENC_JB; ++r) acc[r] = 0.f;
    for (int i = 0; i < I; ++i) {
      const float w0 = __ldg(wo + 3 * i);
      const float w1 = __ldg(wo + 3 * i + 1);
      const float w2 = __ldg(wo + 3 * i + 2);
      const float* row = in + i * ws + j0 - 1;
      float v[ENC_JB + 2];
#pragma unroll
      for (int r = 0; r < ENC_JB + 2; ++r) v[r] = row[r];
#pragma unroll
      for (int r = 0; r < ENC_JB; ++r)
        acc[r] = fmaf(w2, v[r + 2], fmaf(w1, v[r + 1], fmaf(w0, v[r], acc[r])));
    }
    const float bo = __ldg(bias + o);
#pragma unroll
    for (int r = 0; r < ENC_JB; ++r) {
      const int j = j0 + r;
      if (j < hi) {
        float val = fmaxf(acc[r] + bo, 0.f);
        if (mask && enc_outside(p0 + j, T, vt)) val = 0.f;
        out[o * ws + j] = val;
      }
    }
  }
}

// The encoder on one tile: regime logits of the n steps from t0, left in
// lg[k * ws + ENC_HALO + jj], jj < n.  xs, h1, h2 and lg are C, H1, H2 and
// K rows of ws floats.  Called by every thread of the block; ends with a
// __syncthreads.
__device__ __forceinline__ void encoder_tile(
    const float* __restrict__ xb, const EncoderWeights& W, int C, int T,
    int H1, int H2, int K, int t0, int n, int ws, int vt, float* xs,
    float* h1, float* h2, float* lg) {
  const int p0 = t0 - ENC_HALO;
  const int win = n + 2 * ENC_HALO;
  for (int idx = threadIdx.x; idx < C * win; idx += blockDim.x) {
    const int c = idx / win, j = idx - c * win;
    const int p = p0 + j;
    xs[c * ws + j] = enc_outside(p, T, vt) ? 0.f : xb[(size_t)c * T + p];
  }
  __syncthreads();
  enc_conv3(W.w1, W.b1, xs, C, h1, H1, 1, win - 1, ws, p0, T, vt, true);
  __syncthreads();
  enc_conv3(W.w2, W.b2, h1, H1, h2, H2, ENC_HALO, ENC_HALO + n, ws, p0, T, vt,
            false);
  __syncthreads();
  for (int idx = threadIdx.x; idx < K * n; idx += blockDim.x) {
    const int k = idx / n, j = ENC_HALO + idx - k * n;
    const float* wk = W.w3 + (size_t)k * H2;
    float acc = 0.f;
    for (int i = 0; i < H2; ++i) acc = fmaf(__ldg(wk + i), h2[i * ws + j], acc);
    lg[k * ws + j] = acc + __ldg(W.b3 + k);
  }
  __syncthreads();
}

// The prior MLP on one tile: transition logits W2 relu(W1 u_t + b1) + b2 of
// the n steps from t0, left in ap[r * ws + jj], r < K * K, jj < n.  u is
// read through its (channel, time) strides.  us, hp and ap are U, HP and
// K * K rows of ws floats.  Ends with a __syncthreads.
__device__ __forceinline__ void prior_tile(
    const float* __restrict__ ub, long long u_sc, long long u_st,
    const PriorWeights& W, int U, int HP, int KK, int t0, int n, int ws,
    float* us, float* hp, float* ap) {
  for (int idx = threadIdx.x; idx < U * n; idx += blockDim.x) {
    const int c = idx / n, j = idx - c * n;
    us[c * ws + j] = ub[c * u_sc + (long long)(t0 + j) * u_st];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < HP * n; idx += blockDim.x) {
    const int h = idx / n, j = idx - h * n;
    const float* wh = W.w1 + (size_t)h * U;
    float acc = 0.f;
    for (int c = 0; c < U; ++c) acc = fmaf(__ldg(wh + c), us[c * ws + j], acc);
    hp[h * ws + j] = fmaxf(acc + __ldg(W.b1 + h), 0.f);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < KK * n; idx += blockDim.x) {
    const int r = idx / n, j = idx - r * n;
    const float* wr = W.w2 + (size_t)r * HP;
    float acc = 0.f;
    for (int h = 0; h < HP; ++h) acc = fmaf(__ldg(wr + h), hp[h * ws + j], acc);
    ap[r * ws + j] = acc + __ldg(W.b2 + r);
  }
  __syncthreads();
}

// In place log-softmax of the `rows` values p[r * stride]: expf and logf
// with the maximum subtracted, the maximum clamped at -1e30 as the TPU
// kernel clamps it (vqvaehmm_tpu/ops/pallas_decode.py:81-84).
__device__ __forceinline__ void log_softmax_strided(float* p, int rows,
                                                    int stride) {
  float m = -INFINITY;
  for (int r = 0; r < rows; ++r) m = fmaxf(m, p[r * stride]);
  m = fmaxf(m, NEG_CLAMP);
  float z = 0.f;
  for (int r = 0; r < rows; ++r) z += expf(p[r * stride] - m);
  const float lse = m + logf(z);
  for (int r = 0; r < rows; ++r) p[r * stride] -= lse;
}

// Evidence of one tile in place: lg -> log_softmax over the K regimes at
// each step, ap -> log_softmax over each row of K transitions.  Ends with
// a __syncthreads.
__device__ __forceinline__ void evidence_log_softmax(float* lg, float* ap,
                                                     int K, int n, int ws) {
  for (int idx = threadIdx.x; idx < n * (K + 1); idx += blockDim.x) {
    const int j = idx / (K + 1), r = idx - j * (K + 1);
    if (r == K)
      log_softmax_strided(lg + ENC_HALO + j, K, ws);
    else
      log_softmax_strided(ap + (size_t)r * K * ws + j, K, ws);
  }
  __syncthreads();
}

}  // namespace vqhmm
