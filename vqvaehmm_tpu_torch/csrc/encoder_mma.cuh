// The VAE-HMM's encoder stack and prior MLP on one time tile of one
// sequence, each layer an implicit GEMM on the tensor cores
// (tile_mma.cuh::layer): the bfloat16-operand mode of the encoder kernel
// (fused_encoder.cu, kernel 8), the evidence kernel
// (fused_decode.cu::fused_evidence_bf16_kernel, kernel 11) and the
// one-kernel decode (fused_decode.cu::fused_decode_kernel<K, true>, kernel
// 10), and the packing of their weights.
//
// The mode is the TPU kernels' `highest=False` (vqvaehmm_tpu/ops/
// pallas_encoder.py:32, pallas_decode.py:54): both operands of every
// product rounded to the nearest bfloat16 and the sums float32; the bias,
// the ReLU, the masks and the log-softmax stay float32.  Its plain version
// is VAEHMM.encode/prior(bf16_operands=True) (ops/nn.py::bf16_matmul).
//
// The window is encoder_fma.cuh's: window index j is time p0 + j with p0
// = t0 - HALO; x on [0, n + 2 HALO), h1 on [1, n + 2 HALO - 1), h2, the
// logits, u, hp and the transition logits on the tile's own steps [HALO,
// HALO + n).  The operands are bfloat16, time-major, op_stride values a
// row (tile_mma.cuh), op_rows(tile) rows: x (zero outside [0, T) and past
// valid_to, rounded as it is staged), u (the own steps), and two ping-pong
// buffers of the widest of h1, h2 and hp; after them, the float32 rows of
// the regime logits (K) and the transition logits (K * K) where the
// caller wants them in shared memory (the evidence, the decode), row
// stride encfma::row_stride(tile).  The encoder's logits layer takes the
// caller's epilogue: kernel 8 writes its own steps, biased, straight to
// the (B, K, T) output.
//
// Semantics are encoder_fma.cuh's (VAEHMM.encode, prior): every
// convolution pads its own input with zeros outside [0, T); x and h1 are
// zero at t >= valid_to, h2 is not masked.  Each output is one fixed
// sequence of chunk sums (tile_mma.cuh), so a row of a batch is bit-equal
// to the row alone, at any tile width, split or not, and kernel 10's
// evidence equals kernel 11's bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <cstddef>

#include "encoder_fma.cuh"
#include "tile_mma.cuh"

namespace encmma {

using encfma::Dims;
using encfma::HALO;
using tilemma::bf16;
using tilemma::op_stride;

// a block of the mode: 8 warps, at most 3 an SM (__launch_bounds__(THREADS,
// 3): 85 registers a thread)
constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 3;

__host__ __device__ inline int op_rows(int tile) { return tile + 2 * HALO; }

// the widest operand of the ping-pong buffers: h1, h2 and, for the
// evidence, hp
__host__ __device__ inline int widest(const Dims& d) {
  const int h = d.H1 > d.H2 ? d.H1 : d.H2;
  return h > d.HP ? h : d.HP;
}

// float32 rows after the operands: K + K * K for the evidence (HP > 0),
// none for the encoder alone
__host__ __device__ inline int f32_rows(const Dims& d) {
  return d.HP > 0 ? d.K + d.K * d.K : 0;
}

__host__ __device__ inline int smem_bytes(const Dims& d, int tile) {
  const int ru = d.HP > 0 ? op_stride(d.U) : 0;
  return 2 * op_rows(tile) * (op_stride(d.C) + ru + 2 * op_stride(widest(d))) +
         4 * encfma::row_stride(tile) * f32_rows(d);
}

// First bfloat16 value of each layer in the packed weights (tile_mma.cuh's
// fragment order), the prior's where HP > 0.
struct Packed {
  long long w1, w2, w3, p1, p2, total;
};

__host__ __device__ inline Packed packed(const Dims& d) {
  using tilemma::packed_elems;
  Packed p;
  long long at = 0;
  p.w1 = at; at += packed_elems(d.H1, d.C, 3);
  p.w2 = at; at += packed_elems(d.H2, d.H1, 3);
  p.w3 = at; at += packed_elems(d.K, d.H2, 1);
  p.p1 = at; at += d.HP > 0 ? packed_elems(d.HP, d.U, 1) : 0;
  p.p2 = at; at += d.HP > 0 ? packed_elems(d.K * d.K, d.HP, 1) : 0;
  p.total = at;
  return p;
}

// One packing job a layer, as encoder_fma.cuh::pack_jobs; returns the
// number of jobs.
inline int pack_jobs(const Dims& d, const float* ew1, const float* ew2,
                     const float* ew3, const float* pw1, const float* pw2,
                     tilemma::PackJob* jobs) {
  const Packed at = encmma::packed(d);
  jobs[0] = tilemma::PackJob{ew1, d.H1, d.C, 3, 0, at.w1};
  jobs[1] = tilemma::PackJob{ew2, d.H2, d.H1, 3, 0, at.w2};
  jobs[2] = tilemma::PackJob{ew3, d.K, d.H2, 1, 0, at.w3};
  if (d.HP <= 0) return 3;
  jobs[3] = tilemma::PackJob{pw1, d.HP, d.U, 1, 0, at.p1};
  jobs[4] = tilemma::PackJob{pw2, d.K * d.K, d.HP, 1, 0, at.p2};
  return 5;
}

// A block's shared memory: the operands, then the float32 rows (lg, ap
// null for the encoder alone).
struct Ops {
  bf16 *xo, *uo, *a, *b;
  int RC, RU, RG, NR, WS;
  float *lg, *ap;
};

__device__ __forceinline__ Ops carve(unsigned char* smem, const Dims& d,
                                     int tile) {
  Ops s;
  s.NR = op_rows(tile);
  s.RC = op_stride(d.C);
  s.RU = d.HP > 0 ? op_stride(d.U) : 0;
  s.RG = op_stride(widest(d));
  s.WS = encfma::row_stride(tile);
  s.xo = reinterpret_cast<bf16*>(smem);
  s.uo = s.xo + s.NR * s.RC;
  s.a = s.uo + s.NR * s.RU;
  s.b = s.a + s.NR * s.RG;
  float* f = reinterpret_cast<float*>(s.b + s.NR * s.RG);
  s.lg = d.HP > 0 ? f : nullptr;
  s.ap = d.HP > 0 ? f + d.K * s.WS : nullptr;
  return s;
}

// The encoder on one tile, the logits layer through the caller's epilogue
// `logits`.  wp: the packed weights; b1, b2 the convolutions' biases.
// Every thread of the block calls it; it ends with a __syncthreads.
__device__ __forceinline__ void encoder_stage(
    const float* __restrict__ xb, const bf16* __restrict__ wp,
    const float* __restrict__ b1, const float* __restrict__ b2,
    const Dims& d, int T, int t0, int n, int vt, const Ops& s,
    const tilemma::Out& logits) {
  using tilemma::Out;
  const Packed at = encmma::packed(d);
  const int W = n + 2 * HALO;
  const int p0 = t0 - HALO;
  const tilemma::Win win{p0, T, t0, n};
  // x on the whole window, zero outside [0, T) and past valid_to, and in
  // the padding channels
  const int C16 = tilemma::round16(d.C);
  for (int idx = threadIdx.x; idx < C16 * W; idx += blockDim.x) {
    const int c = idx / W, j = idx - c * W;
    const int p = p0 + j;
    const float v = (c < d.C && !encfma::outside(p, T, vt))
                        ? xb[(size_t)c * T + p] : 0.f;
    s.xo[j * s.RC + c] = __float2bfloat16_rn(v);
  }
  __syncthreads();
  // h1 = relu(conv1(x)), zero outside the sequence and past valid_to
  tilemma::layer<3>(wp + at.w1, d.H1, d.C, s.xo, s.RC, s.NR, 1, W - 1,
                    Out{b1, true, true, vt, nullptr, nullptr, nullptr, 0, s.a,
                        s.RG}, win);
  // h2 = relu(conv2(h1)) on the tile, not masked
  tilemma::layer<3>(wp + at.w2, d.H2, d.H1, s.a, s.RG, s.NR, HALO, HALO + n,
                    Out{b2, true, false, T, nullptr, nullptr, nullptr, 0, s.b,
                        s.RG}, win);
  tilemma::layer<1>(wp + at.w3, d.K, d.H2, s.b, s.RG, s.NR, HALO, HALO + n,
                    logits, win);
}

// The encoder's logits without their bias into s.lg (the evidence adds it
// in its log-softmax, as encoder_fma.cuh's stages leave it).
__device__ __forceinline__ tilemma::Out raw_logits(const Ops& s) {
  return tilemma::Out{nullptr, false, false, 0, nullptr, nullptr, s.lg,
                      s.WS, nullptr, 0};
}

// The prior MLP on one tile: raw transition logits (no bias) of the n
// steps from t0 in s.ap[r * WS + HALO + jj], r < K * K.  u is read through
// its (channel, time) strides.  Ends with a __syncthreads.
__device__ __forceinline__ void prior_stage(
    const float* __restrict__ ub, long long u_sc, long long u_st,
    const bf16* __restrict__ wp, const float* __restrict__ pb1,
    const Dims& d, int T, int t0, int n, const Ops& s) {
  using tilemma::Out;
  const Packed at = encmma::packed(d);
  const tilemma::Win win{t0 - HALO, T, t0, n};
  const int U16 = tilemma::round16(d.U);
  for (int idx = threadIdx.x; idx < U16 * n; idx += blockDim.x) {
    const int c = idx / n, j = idx - c * n;
    const float v = c < d.U ? ub[c * u_sc + (long long)(t0 + j) * u_st] : 0.f;
    s.uo[(HALO + j) * s.RU + c] = __float2bfloat16_rn(v);
  }
  __syncthreads();
  // hp = relu(fc1(u)) on the tile
  tilemma::layer<1>(wp + at.p1, d.HP, d.U, s.uo, s.RU, s.NR, HALO, HALO + n,
                    Out{pb1, true, false, T, nullptr, nullptr, nullptr, 0,
                        s.a, s.RG}, win);
  tilemma::layer<1>(wp + at.p2, d.K * d.K, d.HP, s.a, s.RG, s.NR, HALO,
                    HALO + n,
                    Out{nullptr, false, false, T, nullptr, nullptr, s.ap,
                        s.WS, nullptr, 0}, win);
}

}  // namespace encmma
