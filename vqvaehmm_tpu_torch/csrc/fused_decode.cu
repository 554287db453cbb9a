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
// vqvaehmm_tpu_torch/ops/fused_decode.py.  The evidence kernel's encoder
// and prior stages are the device functions of encoder_fma.cuh (shared
// with the encoder kernel, on tile_fma.cuh's register tile); the decode
// kernel's are those of encoder_tile.cuh, which computes the same FMA
// chains, so the two kernels' evidence is bit-equal.
//
// Layout: x (B, C, T) float32 contiguous; u (B, U, T) or (B, T, U), read
// through its strides; lengths (B,) int32 or null (the evidence kernel
// bounds the encoder at one scalar, max(lengths), T where null, which each
// warp reduces for itself); valid_to (B,) int32 (the decode: every entry
// max(lengths));
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
// Design, evidence.  One block a tile of `tile` steps of one sequence
// (16, 32 or 64, chosen by the wrapper from the waves of resident
// blocks), B * ceil(T / tile) blocks; with `split`, two blocks a tile,
// one for the encoder and its log-softmax, one for the prior's, which
// write disjoint outputs: twice the blocks and half the chain of layers a
// block, for grids that leave most SMs idle.  The five layers go through
// tile_fma.cuh's register tile, the packed weights through its
// double-buffered cp.async slabs (the prior's first slab is in flight
// while the encoder's last layer runs).  Both outputs of a tile are
// contiguous in device memory (n * K and n * K * K floats), so they are
// written coalesced from shared memory with no transpose pass after.
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
// its shared-memory loads, and at small B by one block's chain of layers
// (the evidence) or by the serial recursion (K * K adds and compares a
// step on one thread) and the single SM a sequence occupies (the decode).

#include <cuda_runtime.h>
#include <climits>
#include <cstddef>
#include <cstdint>

#include "encoder_fma.cuh"
#include "encoder_tile.cuh"

namespace {

using namespace vqhmm;

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

// max(lengths[0..B)), or T where lengths is null: every lane of a warp
// gets it, with no barrier (every lane of the block calls it).
__device__ __forceinline__ int batch_bound(const int* __restrict__ lengths,
                                           int B, int T) {
  if (lengths == nullptr) return T;
  int m = INT_MIN;
  for (int i = threadIdx.x & 31; i < B; i += 32) m = max(m, lengths[i]);
  for (int o = 16; o > 0; o >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

__global__ void __launch_bounds__(encfma::MAX_THREADS, 2)
    fused_evidence_kernel(const float* __restrict__ x,
                          const float* __restrict__ u, long long u_sb,
                          long long u_sc, long long u_st,
                          const int* __restrict__ lengths, encfma::Weights W,
                          float* __restrict__ log_obs,
                          float* __restrict__ log_A, encfma::Dims d, int B,
                          int T, int tile, int tiles, int split) {
  extern __shared__ __align__(16) float smem[];
  constexpr int H = encfma::HALO;
  const int WS = encfma::row_stride(tile);
  const encfma::Rows s = encfma::carve(smem, d, WS);
  tilefma::Pipe pipe{smem, 0, false};
  const int K = d.K, KK = d.K * d.K;
  // stage 0: the encoder, 1: the prior, 2: both
  const int unit = split ? (int)(blockIdx.x >> 1) : (int)blockIdx.x;
  const int stage = split ? (int)(blockIdx.x & 1) : 2;
  const int b = unit / tiles;
  const int t0 = (unit - b * tiles) * tile;
  const int n = min(tile, T - t0);

  if (stage != 1)
    encfma::encoder_stage(x + (size_t)b * d.C * T, W, d, T, t0, n, WS,
                          batch_bound(lengths, B, T), s, pipe,
                          stage == 2 ? encfma::prior_first(W, d)
                                     : tilefma::no_next());
  if (stage != 0)
    encfma::prior_stage(u + b * u_sb, u_sc, u_st, W, d, t0, n, WS, s, pipe);
  // a (step, row) a thread: row K the regimes, row r < K the transitions
  // out of regime r
  const int rlo = stage == 0 ? K : 0, rhi = stage == 1 ? K : K + 1;
  const int per = rhi - rlo;
  for (int idx = threadIdx.x; idx < n * per; idx += blockDim.x) {
    const int j = idx / per, r = rlo + idx - j * per;
    if (r == K)
      encfma::log_softmax_biased(s.lg + H + j, W.eb3, K, WS);
    else
      encfma::log_softmax_biased(s.ap + (size_t)r * K * WS + H + j,
                                 W.pb2 + r * K, K, WS);
  }
  __syncthreads();

  if (stage != 1) {
    float* ob = log_obs + ((size_t)b * T + t0) * K;
    for (int idx = threadIdx.x; idx < n * K; idx += blockDim.x) {
      const int j = idx / K, k = idx - j * K;
      ob[idx] = s.lg[k * WS + H + j];
    }
  }
  if (stage != 0) {
    float* ab = log_A + ((size_t)b * T + t0) * KK;
    for (int idx = threadIdx.x; idx < n * KK; idx += blockDim.x) {
      const int j = idx / KK, r = idx - j * KK;
      ab[idx] = s.ap[r * WS + H + j];
    }
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

// Dynamic shared memory of an evidence block at tile width `tile`.
extern "C" int vqhmm_fused_evidence_smem_bytes(int C, int H1, int H2, int K,
                                               int U, int HP, int tile) {
  return encfma::smem_bytes(encfma::Dims{C, H1, H2, K, U, HP}, tile);
}

extern "C" int vqhmm_fused_decode_smem_bytes(int C, int H1, int H2, int K,
                                             int U, int HP) {
  const Dims d{C, 0, U, H1, H2, K, HP};
  return (int)(sizeof(float) * DWS * evidence_rows(d));
}

// packed_weights: vqhmm_encoder_pack's layout with the prior (HP > 0);
// lengths may be null.
extern "C" int vqhmm_fused_evidence(
    const float* x, const float* u, long long u_sb, long long u_sc,
    long long u_st, const int* lengths, const float* packed_weights,
    const float* eb1, const float* eb2, const float* eb3, const float* pb1,
    const float* pb2, float* log_obs, float* log_A, int B, int C, int T,
    int U, int H1, int H2, int K, int HP, int tile, int split, void* stream) {
  const encfma::Dims d{C, H1, H2, K, U, HP};
  const int smem = encfma::smem_bytes(d, tile);
  if (!encfma::tile_ok(tile) || B <= 0 || T <= 0 || U <= 0 || HP <= 0 ||
      !encfma::layers_fit(d) || smem > encfma::SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const int tiles = (T + tile - 1) / tile;
  const long long blocks = (long long)tiles * B * (split ? 2 : 1);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_evidence_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const encfma::Weights W{packed_weights, eb1, eb2, eb3, pb1, pb2};
  int G = H1 > H2 ? H1 : H2;
  G = G > HP ? G : HP;
  fused_evidence_kernel<<<(unsigned)blocks, encfma::block_threads(tile, G),
                          smem, (cudaStream_t)stream>>>(
      x, u, u_sb, u_sc, u_st, lengths, W, log_obs, log_A, d, B, T, tile,
      tiles, split ? 1 : 0);
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
