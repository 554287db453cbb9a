// The VAE-HMM's encoder stack and prior MLP on one time tile of one
// sequence through tile_fma.cuh's register-tiled layer: the stages the
// encoder kernel (fused_encoder.cu, kernel 8) and the evidence kernel
// (fused_decode.cu::fused_evidence_kernel, kernel 11) and the one-kernel
// decode (fused_decode.cu::fused_decode_kernel, kernel 10) share, and
// the packing of their weights.
//
//   encoder  x -> conv3 C->H1 + ReLU, masked -> conv3 H1->H2 + ReLU
//            -> 1x1 H2->K (raw regime logits)
//   prior    u -> dense U->HP + ReLU -> dense HP->K*K (raw transition
//            logits)
//
// A tile is n <= tile output steps from time t0.  Window index j is time
// p0 + j with p0 = t0 - HALO: x is staged on [0, n + 2 HALO), h1 computed
// on [1, n + 2 HALO - 1), h2, the logits, u, hp and the transition logits
// on the tile's own steps [HALO, HALO + n).  Rows are row_stride(tile)
// floats apart, a multiple of 4, as tile_fma.cuh's 16-byte window loads
// need.
//
// Shared memory of a block: the two weight buffers (2 WBUF floats), a pad,
// then the stage region (x, h1, h2 while the encoder runs; u, hp while the
// prior runs: max(C + H1 + H2, U + HP) rows), then K rows of regime logits
// and, for the evidence, K * K rows of transition logits, which outlive
// their stages.  Each stage's output has rows of its own width, so no
// width (HP, K * K, H2 above H1) can overrun another stage's rows.
//
// Semantics (vqvaehmm_tpu/models/vae_hmm.py::encode, prior):
//  * every convolution pads its own input with zeros outside [0, T), so
//    h1 outside the sequence is 0, not relu(b1);
//  * x is zeroed at t >= valid_to before conv1 and h1 at t >= valid_to
//    after its ReLU; h2 is not masked;
//  * each output is one fixed chain of FMAs, tile_fma.cuh's: input
//    channels ascending, taps 0, 1, 2 nested, from 0, the bias added last
//    (kernel 10 computes its evidence with these same stages, so it
//    equals kernel 11's bit for bit).  A row of a batch is bit-equal to
//    the row alone, at any tile width, split or not.

#pragma once

#include <cuda_runtime.h>
#include <cstddef>

#include "tile_fma.cuh"

namespace encfma {

constexpr int HALO = 2;           // one step per k=3 convolution
constexpr int JB = 4;             // steps a thread in a register tile
constexpr int MAX_THREADS = 512;
constexpr float NEG_CLAMP = -1e30f;
// shared memory a Hopper block may use (227 KB, NVIDIA H100 data sheet)
constexpr int SMEM_LIMIT = 232448;

__host__ __device__ inline int row_stride(int tile) {
  return tile + 2 * HALO + JB;    // window plus room for over-reads
}

inline bool tile_ok(int tile) { return tile == 16 || tile == 32 || tile == 64; }

// Threads of a block: the (4 output channels, JB steps) tiles of the
// widest register-tiled layer (G outputs) over the widest convolution's
// range, spread evenly over the fewest rounds of at most `most` threads;
// four warps at least (fused_infer.cu's rule).
inline int block_threads(int tile, int G, int most = MAX_THREADS) {
  const int items = (G + 3) / 4 * (tile / JB + 2);
  const int rounds = (items + most - 1) / most;
  const int t = ((items + rounds - 1) / rounds + 31) / 32 * 32;
  return t < 128 ? 128 : t;
}

// Widths; U = HP = 0 for the encoder alone.
struct Dims {
  int C, H1, H2, K, U, HP;
};

__host__ __device__ inline int region_rows(const Dims& d) {
  const int e = d.C + d.H1 + d.H2, p = d.U + d.HP;
  return e > p ? e : p;
}

__host__ __device__ inline int window_rows(const Dims& d) {
  return region_rows(d) + d.K + (d.HP > 0 ? d.K * d.K : 0);
}

__host__ __device__ inline int smem_bytes(const Dims& d, int tile) {
  return (int)(sizeof(float) *
               (2 * tilefma::WBUF + tilefma::ROW_PAD +
                (size_t)row_stride(tile) * window_rows(d)));
}

// Every layer's slab of one input channel fits a weight buffer.
inline bool layers_fit(const Dims& d) {
  using tilefma::round4;
  using tilefma::WBUF;
  return 3 * round4(d.H1) <= WBUF && 3 * round4(d.H2) <= WBUF &&
         round4(d.K) <= WBUF && round4(d.HP) <= WBUF &&
         round4(d.K * d.K) <= WBUF;
}

// First float of each layer in the packed weights (tile_fma.cuh's order).
struct Packed {
  long long w1, w2, w3, p1, p2, total;
};

__host__ __device__ inline Packed packed(const Dims& d) {
  Packed p;
  long long at = 0;
  p.w1 = at; at += tilefma::packed_floats(d.H1, d.C, 3);
  p.w2 = at; at += tilefma::packed_floats(d.H2, d.H1, 3);
  p.w3 = at; at += tilefma::packed_floats(d.K, d.H2, 1);
  p.p1 = at; at += tilefma::packed_floats(d.HP, d.U, 1);
  p.p2 = at; at += tilefma::packed_floats(d.K * d.K, d.HP, 1);
  p.total = at;
  return p;
}

// The packed layers and the torch biases (pb1, pb2 null for the encoder
// alone).
struct Weights {
  const float* wp;
  const float *eb1, *eb2, *eb3, *pb1, *pb2;
};

struct Rows {
  float *xs, *h1, *h2, *us, *hp, *lg, *ap;
};

__device__ __forceinline__ Rows carve(float* smem, const Dims& d, int WS) {
  float* r = tilefma::first_row(smem + 2 * tilefma::WBUF);
  Rows s;
  s.xs = r;
  s.h1 = s.xs + d.C * WS;
  s.h2 = s.h1 + d.H1 * WS;
  s.us = r;
  s.hp = s.us + d.U * WS;
  s.lg = r + region_rows(d) * WS;
  s.ap = s.lg + d.K * WS;
  return s;
}

__device__ __forceinline__ bool outside(int p, int T, int vt) {
  return p < 0 || p >= T || p >= vt;
}

// The encoder on one tile: raw logits (no bias) of the n steps from t0 in
// s.lg[k * WS + HALO + jj].  The first layer's weights go in flight before
// x is staged; `after` is the layer whose first slab the last layer
// stages.  Every thread of the block calls it; ends with a __syncthreads.
__device__ __forceinline__ void encoder_stage(
    const float* __restrict__ xb, const Weights& W, const Dims& d, int T,
    int t0, int n, int WS, int vt, const Rows& s, tilefma::Pipe& pipe,
    const tilefma::Next& after) {
  using tilefma::Next;
  const Packed at = packed(d);
  const float *w1 = W.wp + at.w1, *w2 = W.wp + at.w2, *w3 = W.wp + at.w3;
  if (!pipe.staged) {
    tilefma::stage_first(Next{w1, d.H1, d.C, 3}, pipe.wbuf + pipe.cur * tilefma::WBUF);
    pipe.staged = true;
  }
  const int win = n + 2 * HALO;
  const int p0 = t0 - HALO;
  for (int idx = threadIdx.x; idx < d.C * win; idx += blockDim.x) {
    const int c = idx / win, j = idx - c * win;
    const int p = p0 + j;
    s.xs[c * WS + j] = outside(p, T, vt) ? 0.f : xb[(size_t)c * T + p];
  }
  __syncthreads();
  // h1 = relu(conv1(x)), zero outside the sequence and past valid_to
  tilefma::layer<3, 4, JB>(w1, d.H1, d.C, s.xs, s.h1, WS, 1, win - 1, pipe,
                           Next{w2, d.H2, d.H1, 3});
  tilefma::finish<true>(s.h1, d.H1, WS, 1, win - 1, W.eb1, true, p0, T, vt,
                        nullptr, nullptr, 0, 0);
  // h2 = relu(conv2(h1)) on the tile, not masked
  tilefma::layer<3, 4, JB>(w2, d.H2, d.H1, s.h1, s.h2, WS, HALO, HALO + n,
                           pipe, Next{w3, d.K, d.H2, 1});
  tilefma::finish<true>(s.h2, d.H2, WS, HALO, HALO + n, W.eb2, false, p0, T,
                        vt, nullptr, nullptr, 0, 0);
  // raw logits, a (step, regime) a thread (fused_infer.cu's to_logits)
  tilefma::layer<1, 1, 1>(w3, d.K, d.H2, s.h2, s.lg, WS, HALO, HALO + n, pipe,
                          after);
}

// The first slab of the prior's first layer, as encoder_stage's `after`.
__device__ __forceinline__ tilefma::Next prior_first(const Weights& W,
                                                     const Dims& d) {
  return tilefma::Next{W.wp + packed(d).p1, d.HP, d.U, 1};
}

// The prior MLP on one tile: raw transition logits (no bias) of the n
// steps from t0 in s.ap[r * WS + HALO + jj], r < K * K.  u is read
// through its (channel, time) strides.  Ends with a __syncthreads.
__device__ __forceinline__ void prior_stage(
    const float* __restrict__ ub, long long u_sc, long long u_st,
    const Weights& W, const Dims& d, int t0, int n, int WS, const Rows& s,
    tilefma::Pipe& pipe) {
  using tilefma::Next;
  const Packed at = packed(d);
  const float *p1 = W.wp + at.p1, *p2 = W.wp + at.p2;
  if (!pipe.staged) {
    tilefma::stage_first(prior_first(W, d), pipe.wbuf + pipe.cur * tilefma::WBUF);
    pipe.staged = true;
  }
  for (int idx = threadIdx.x; idx < d.U * n; idx += blockDim.x) {
    const int c = idx / n, j = idx - c * n;
    s.us[c * WS + HALO + j] = ub[c * u_sc + (long long)(t0 + j) * u_st];
  }
  __syncthreads();
  tilefma::layer<1, 4, JB>(p1, d.HP, d.U, s.us, s.hp, WS, HALO, HALO + n,
                           pipe, Next{p2, d.K * d.K, d.HP, 1});
  tilefma::finish<true>(s.hp, d.HP, WS, HALO, HALO + n, W.pb1, false, 0, 0, 0,
                        nullptr, nullptr, 0, 0);
  // a (step, 4 transitions) a thread (fused_infer.cu's to_params)
  tilefma::layer<1, 4, 1>(p2, d.K * d.K, d.HP, s.hp, s.ap, WS, HALO, HALO + n,
                          pipe, tilefma::no_next());
}

// In place over the `rows` values p[r * stride]: v = p + bias[r], then
// v - logsumexp(v), with expf and logf and the maximum clamped at -1e30 as
// the TPU kernel clamps it (vqvaehmm_tpu/ops/pallas_decode.py:81-84).
__device__ __forceinline__ void log_softmax_biased(
    float* p, const float* __restrict__ bias, int rows, int stride) {
  float m = -INFINITY;
  for (int r = 0; r < rows; ++r) {
    const float v = p[r * stride] + __ldg(bias + r);
    p[r * stride] = v;
    m = fmaxf(m, v);
  }
  m = fmaxf(m, NEG_CLAMP);
  float z = 0.f;
  for (int r = 0; r < rows; ++r) z += expf(p[r * stride] - m);
  const float lse = m + logf(z);
  for (int r = 0; r < rows; ++r) p[r * stride] -= lse;
}

// One packing job a layer of the encoder (and the prior where d.HP > 0);
// returns the number of jobs.
inline int pack_jobs(const Dims& d, const float* ew1, const float* ew2,
                     const float* ew3, const float* pw1, const float* pw2,
                     tilefma::PackJob* jobs) {
  const Packed at = packed(d);
  jobs[0] = tilefma::PackJob{ew1, d.H1, d.C, 3, 0, at.w1};
  jobs[1] = tilefma::PackJob{ew2, d.H2, d.H1, 3, 0, at.w2};
  jobs[2] = tilefma::PackJob{ew3, d.K, d.H2, 1, 0, at.w3};
  if (d.HP <= 0) return 3;
  jobs[3] = tilefma::PackJob{pw1, d.HP, d.U, 1, 0, at.p1};
  jobs[4] = tilefma::PackJob{pw2, d.K * d.K, d.HP, 1, 0, at.p2};
  return 5;
}

}  // namespace encfma
