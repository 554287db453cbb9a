// The HMM evidence, and the one-kernel Viterbi decode from raw (x, u) to
// states, of the VAE-HMM for Hopper (sm_90a).
//
// Replaces two TPU kernels of vqvaehmm_tpu/ops/pallas_decode.py:
//   _evidence_kernel -> fused_evidence_kernel: encoder -> log-softmax over
//     the K regimes (log_obs); prior MLP -> log-softmax over each row of K
//     transitions (log_A);
//   _kernel -> fused_decode_kernel: the same evidence, inert padding past
//     each sequence's length, the max-plus recursion and the backtrace.
// The Python wrappers and their plain PyTorch versions are in
// vqvaehmm_tpu_torch/ops/fused_decode.py; the encoder and prior stages are
// the device functions of encoder_tile.cuh.
//
// Layout: x (B, C, T) float32 contiguous; u (B, U, T) or (B, T, U), read
// through its strides; valid_to (B,) int32, every entry max(lengths) (the
// evidence bounds the encoder at one scalar); lengths (B,) int32 or null;
// log_obs (B, T, K) and log_A (B, T, K, K) float32 contiguous, the layouts
// ops/hmm.py and the Viterbi kernel read; states (B, T) int32.
//
// Semantics.  The evidence applies no length masking: ops/hmm.py masks
// downstream.  The decode makes a step t >= L inert (a zero observation
// and an identity transition), so the path freezes at t = L - 1; delta_0 =
// log_pi + obs_0 and log_A at t = 0 is unused; scores[i][j] = delta[i] +
// A[i][j], the first maximum over i wins (strict >), then delta[j] = best +
// obs[j]: the order of vqvaehmm_tpu_torch/ops/hmm.py::viterbi and of
// csrc/viterbi.cu.  Where two paths tie to float rounding the decoded
// states may differ from a decode fed by another evidence computation;
// their scores agree.
//
// Design, evidence.  One block a tile of TILE steps of one sequence, B *
// ceil(T / TILE) blocks.  Both outputs of a tile are contiguous in device
// memory (n * K and n * K * K floats), so they are written coalesced from
// shared memory with no transpose pass after.
//
// Design, decode.  One block of 512 threads a sequence walks the time
// axis in chunks of CH steps.  All threads compute the chunk's evidence
// into shared memory (parallel along T and the channels); then one
// thread runs the recursion over the chunk with delta in registers,
// reading log_A and log_obs from shared memory: they never reach device
// memory.  Only the int8 backpointers do (B * T * K bytes, a scratch the
// wrapper allocates), and the backtrace reads them back chunk by chunk,
// as csrc/viterbi.cu does.
//
// Bound.  A token costs about 17.7 kFLOP of fp32 FMA (the encoder 14.4,
// the prior MLP 3.3) against 36 bytes read and 48 written by the evidence
// kernel, or 4 written by the decode: both are bound by arithmetic and
// its shared-memory loads, and the decode at small B also by the serial
// recursion (K * K adds and compares a step on one thread) and by the
// single SM a sequence occupies.

#include <cuda_runtime.h>
#include <climits>
#include <cstddef>
#include <cstdint>

#include "encoder_tile.cuh"

namespace {

using namespace vqhmm;

// evidence: TILE, WS and THREADS are encoder_tile.cuh's

constexpr int CH = 64;                               // decode: steps a chunk
constexpr int DWS = CH + 2 * ENC_HALO + ENC_JB;
constexpr int DTHREADS = 512;

struct Dims {
  int C, T, U, H1, H2, K, HP;
};

__host__ __device__ inline int evidence_rows(const Dims& d) {
  return d.C + d.H1 + d.H2 + d.K + d.U + d.HP + d.K * d.K;
}

struct Buffers {
  float *xs, *h1, *h2, *lg, *us, *hp, *ap;
};

__device__ __forceinline__ Buffers carve(float* smem, const Dims& d, int ws) {
  Buffers s;
  s.xs = smem;
  s.h1 = s.xs + d.C * ws;
  s.h2 = s.h1 + d.H1 * ws;
  s.lg = s.h2 + d.H2 * ws;
  s.us = s.lg + d.K * ws;
  s.hp = s.us + d.U * ws;
  s.ap = s.hp + d.HP * ws;
  return s;
}

__global__ void __launch_bounds__(THREADS) fused_evidence_kernel(
    const float* __restrict__ x, const float* __restrict__ u, long long u_sb,
    long long u_sc, long long u_st, const int* __restrict__ valid_to,
    EncoderWeights EW, PriorWeights PW, float* __restrict__ log_obs,
    float* __restrict__ log_A, Dims d, int tiles) {
  extern __shared__ float smem[];
  const Buffers s = carve(smem, d, WS);
  const int K = d.K, KK = d.K * d.K, T = d.T;
  const int b = blockIdx.x / tiles;
  const int t0 = (blockIdx.x - b * tiles) * TILE;
  const int n = min(TILE, T - t0);

  encoder_tile(x + (size_t)b * d.C * T, EW, d.C, T, d.H1, d.H2, K, t0, n, WS,
               valid_to[b], s.xs, s.h1, s.h2, s.lg);
  prior_tile(u + b * u_sb, u_sc, u_st, PW, d.U, d.HP, KK, t0, n, WS, s.us,
             s.hp, s.ap);
  evidence_log_softmax(s.lg, s.ap, K, n, WS);

  float* ob = log_obs + ((size_t)b * T + t0) * K;
  for (int idx = threadIdx.x; idx < n * K; idx += blockDim.x) {
    const int j = idx / K, k = idx - j * K;
    ob[idx] = s.lg[k * WS + ENC_HALO + j];
  }
  float* ab = log_A + ((size_t)b * T + t0) * KK;
  for (int idx = threadIdx.x; idx < n * KK; idx += blockDim.x) {
    const int j = idx / KK, r = idx - j * KK;
    ab[idx] = s.ap[r * WS + j];
  }
}

template <int K>
__global__ void __launch_bounds__(DTHREADS) fused_decode_kernel(
    const float* __restrict__ x, const float* __restrict__ u, long long u_sb,
    long long u_sc, long long u_st, const int* __restrict__ valid_to,
    const int* __restrict__ lengths, const float* __restrict__ log_pi,
    EncoderWeights EW, PriorWeights PW, int8_t* __restrict__ bp,
    int* __restrict__ states, Dims d) {
  extern __shared__ float smem[];
  __shared__ int8_t sB[CH * K];
  __shared__ int sS[CH];
  const Buffers s = carve(smem, d, DWS);
  constexpr int KK = K * K;
  const int T = d.T;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int L = lengths ? lengths[b] : T;
  const int vt = valid_to[b];
  const float* xb = x + (size_t)b * d.C * T;
  const float* ub = u + b * u_sb;
  int8_t* bpb = bp + (size_t)b * T * K;
  int* sb = states + (size_t)b * T;

  float delta[K];
#pragma unroll
  for (int k = 0; k < K; ++k) delta[k] = 0.f;

  for (int c0 = 0; c0 < T; c0 += CH) {
    const int n = min(CH, T - c0);
    encoder_tile(xb, EW, d.C, T, d.H1, d.H2, K, c0, n, DWS, vt, s.xs, s.h1,
                 s.h2, s.lg);
    prior_tile(ub, u_sc, u_st, PW, d.U, d.HP, KK, c0, n, DWS, s.us, s.hp,
               s.ap);
    evidence_log_softmax(s.lg, s.ap, K, n, DWS);
    if (tid == 0) {
      for (int tt = 0; tt < n; ++tt) {
        const int t = c0 + tt;
        const bool valid = t < L;
        const float* obs = s.lg + ENC_HALO + tt;     // obs[j * DWS]
        const float* a = s.ap + tt;                  // a[(i * K + j) * DWS]
        if (t == 0) {
#pragma unroll
          for (int j = 0; j < K; ++j) {
            delta[j] = log_pi[j] + (valid ? obs[j * DWS] : 0.f);
            sB[j] = 0;
          }
          continue;
        }
        float nd[K];
#pragma unroll
        for (int j = 0; j < K; ++j) {
          float best =
              delta[0] + (valid ? a[j * DWS] : (j == 0 ? 0.f : -INFINITY));
          int arg = 0;
#pragma unroll
          for (int i = 1; i < K; ++i) {
            const float sc =
                delta[i] +
                (valid ? a[(i * K + j) * DWS] : (i == j ? 0.f : -INFINITY));
            if (sc > best) { best = sc; arg = i; }
          }
          nd[j] = best + (valid ? obs[j * DWS] : 0.f);
          sB[tt * K + j] = (int8_t)arg;
        }
#pragma unroll
        for (int j = 0; j < K; ++j) delta[j] = nd[j];
      }
    }
    __syncthreads();
    for (int idx = tid; idx < n * K; idx += DTHREADS)
      bpb[(size_t)c0 * K + idx] = sB[idx];
    __syncthreads();
  }

  // The backtrace is one warp's work, as in csrc/viterbi.cu.  The
  // __syncthreads above ordered every backpointer store before these loads.
  if (tid >= 32) return;
  int st = 0;
  if (tid == 0) {
    float best = delta[0];
#pragma unroll
    for (int k = 1; k < K; ++k)
      if (delta[k] > best) { best = delta[k]; st = k; }
    sb[T - 1] = st;
  }
  __syncwarp();
  for (int hi = T; hi > 1; hi -= CH) {
    const int lo = max(1, hi - CH);
    const int n = hi - lo;
    for (int idx = tid; idx < n * K; idx += 32)
      sB[idx] = bpb[(size_t)lo * K + idx];
    __syncwarp();
    if (tid == 0) {
      for (int t = hi - 1; t >= lo; --t) {
        st = sB[(t - lo) * K + st];
        sS[t - lo] = st;   // state at t - 1
      }
    }
    __syncwarp();
    for (int idx = tid; idx < n; idx += 32) sb[lo - 1 + idx] = sS[idx];
    __syncwarp();
  }
}

template <int K>
cudaError_t launch_decode(const float* x, const float* u, long long u_sb,
                          long long u_sc, long long u_st, const int* valid_to,
                          const int* lengths, const float* log_pi,
                          EncoderWeights EW, PriorWeights PW, int8_t* bp,
                          int* states, Dims d, int B, int smem,
                          cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_decode_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  fused_decode_kernel<K><<<B, DTHREADS, smem, stream>>>(
      x, u, u_sb, u_sc, u_st, valid_to, lengths, log_pi, EW, PW, bp, states,
      d);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vqhmm_fused_evidence_smem_bytes(int C, int H1, int H2, int K,
                                               int U, int HP) {
  const Dims d{C, 0, U, H1, H2, K, HP};
  return (int)(sizeof(float) * WS * evidence_rows(d));
}

extern "C" int vqhmm_fused_decode_smem_bytes(int C, int H1, int H2, int K,
                                             int U, int HP) {
  const Dims d{C, 0, U, H1, H2, K, HP};
  return (int)(sizeof(float) * DWS * evidence_rows(d));
}

extern "C" int vqhmm_fused_evidence(
    const float* x, const float* u, long long u_sb, long long u_sc,
    long long u_st, const int* valid_to, const float* ew1, const float* eb1,
    const float* ew2, const float* eb2, const float* ew3, const float* eb3,
    const float* pw1, const float* pb1, const float* pw2, const float* pb2,
    float* log_obs, float* log_A, int B, int C, int T, int U, int H1, int H2,
    int K, int HP, void* stream) {
  const Dims d{C, T, U, H1, H2, K, HP};
  const int smem = vqhmm_fused_evidence_smem_bytes(C, H1, H2, K, U, HP);
  const int tiles = (T + TILE - 1) / TILE;
  const long long blocks = (long long)tiles * B;
  if (B <= 0 || T <= 0 || blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_evidence_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  const EncoderWeights EW{ew1, eb1, ew2, eb2, ew3, eb3};
  const PriorWeights PW{pw1, pb1, pw2, pb2};
  fused_evidence_kernel<<<(unsigned)blocks, THREADS, smem,
                          (cudaStream_t)stream>>>(
      x, u, u_sb, u_sc, u_st, valid_to, EW, PW, log_obs, log_A, d, tiles);
  return (int)cudaGetLastError();
}

// K is bounded by the int8 backpointers and by the template instances.
extern "C" int vqhmm_fused_decode(
    const float* x, const float* u, long long u_sb, long long u_sc,
    long long u_st, const int* valid_to, const int* lengths,
    const float* log_pi, const float* ew1, const float* eb1, const float* ew2,
    const float* eb2, const float* ew3, const float* eb3, const float* pw1,
    const float* pb1, const float* pw2, const float* pb2, int8_t* bp,
    int* states, int B, int C, int T, int U, int H1, int H2, int K, int HP,
    void* stream) {
  if (B <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  const Dims d{C, T, U, H1, H2, K, HP};
  const int smem = vqhmm_fused_decode_smem_bytes(C, H1, H2, K, U, HP);
  const EncoderWeights EW{ew1, eb1, ew2, eb2, ew3, eb3};
  const PriorWeights PW{pw1, pb1, pw2, pb2};
  cudaStream_t st = (cudaStream_t)stream;
#define VQHMM_DECODE_CASE(KV)                                               \
  case KV:                                                                  \
    return (int)launch_decode<KV>(x, u, u_sb, u_sc, u_st, valid_to,         \
                                  lengths, log_pi, EW, PW, bp, states, d,   \
                                  B, smem, st);
  switch (K) {
    VQHMM_DECODE_CASE(1)
    VQHMM_DECODE_CASE(2)
    VQHMM_DECODE_CASE(3)
    VQHMM_DECODE_CASE(4)
    VQHMM_DECODE_CASE(5)
    VQHMM_DECODE_CASE(6)
    VQHMM_DECODE_CASE(7)
    VQHMM_DECODE_CASE(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef VQHMM_DECODE_CASE
}
