// Viterbi MAP decode (path and score) for Hopper (sm_90a): the segmented
// max-plus scan of maxplus_scan.cuh, parallel in time.
//
// Replaces the three TPU kernels of vqvaehmm_tpu/ops/pallas_hmm.py: the
// monolithic doubling-scan kernel (_viterbi_kernel, :103) and the chunked
// pair (_viterbi_fwd_tiled_kernel, :274; _viterbi_bwd_tiled_kernel, :333).
// Like them it is parallel in T; it walks T in rounds, so one kernel covers
// every T the shared-memory bound of the plan allows.  The Python wrapper,
// its launch plan and its plain PyTorch versions (the sequential decode and
// the segmented scan operation for operation) are in
// vqvaehmm_tpu_torch/ops/fused_viterbi.py.
//
// Bound.  A decode moves (K * K + K) * 4 bytes a step in and 4 out
// (0.0002 ms at B = 64, T = 200 over 3.35 TB/s) and does 2 K * K adds and
// compares a step: neither bounds it.  What does is the serial depth: the
// recursion is a chain of T steps, each K adds and compares deep, and one
// thread took 0.17 us a step on the card.  The scan cuts the chain to
// S steps of a segment's product, the fold (G = T / S steps up to G = 64,
// then about G / 8 + 16 in two levels), S of the rerun, about 3 sqrt(G)
// lookups of the reverse pass and S of the backtrace (maxplus_scan.cuh);
// and to one launch.  At (1, 2327) the staging of the round, one SM
// fetching 112 KB, is then the longest phase.
//
// Design.  A group of `lanes` threads decodes a sequence, one thread a
// segment, a round of lanes * S steps at a time; a block holds `seqs`
// groups (short T: many sequences a block, as at (460, 20); long T: many
// warps a sequence, as at (1, 2327)).  The plan (ops/fused_viterbi.py::
// viterbi_plan) sizes both from the shapes; neither changes a bit.  Each
// round the block stages its sequences' log_obs and log_A steps into shared
// memory with coalesced cp.async copies, log_A read through its strides:
// per sequence and step, shared by the batch (a_sb = 0), or one stationary
// matrix (a_st = 0).  The copies are of 4 bytes, into a layout padded one
// word a segment: a thread reads its own segment's steps, and with the
// segments an even S * K (* K) words apart the 32 threads of a warp fell
// on 2 banks of shared memory, 16-way conflicts that the card measured as
// time growing with T (0.34 us a segment of 16 steps at K = 3); the
// 16-byte copies of tile_fma.cuh need a layout the pad breaks.  Then
// phase (a), a barrier, the fold (b) (chunk products on the threads of
// their first segments, a barrier, the chunks' deltas on the group's
// first thread, a barrier, each chunk's deltas on the thread of its first
// segment in the round), a barrier, the rerun (c).  After the last round
// the final state on the first thread, the reverse pass (d) on about
// sqrt(G) threads, the backtrace (e).  The products, incoming deltas,
// selector maps and end states stay in shared memory.  The
// backpointers (one 32-bit word a step) go to a (B, T) scratch in device
// memory, each word written and read back by the one thread that owns its
// segment, so no barrier orders them; kept there, not in shared memory,
// they do not bound T (a sequence keeps G * 5 bytes of maps and end
// states in shared memory, G = T / S: T up to about 180k steps at K = 8).

#include <cuda_runtime.h>
#include <cstddef>

#include "maxplus_scan.cuh"
#include "tile_fma.cuh"

namespace {

constexpr int MAX_LANES = 256;      // threads a block at most
// shared memory a Hopper block may use (227 KB, NVIDIA H100 data sheet)
constexpr int SMEM_LIMIT = 232448;

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// A sequence's shared memory, in 4-byte words, each part 16-byte aligned:
// the staged obs and log_A of a round, a segment's steps after another's
// with one word of pad between (S * K + 1 and S * K * K + 1 words a
// segment: odd, so the threads of a warp, one a segment, read 32
// different banks), the products and incoming deltas of a round, the
// chunk products and chunk incoming deltas of the fold's two levels (a
// round holds at most lanes / 8 + 2 chunks), the delta a chunk carries
// into the next round, the end delta (delta_0 until the fold takes it,
// then delta_{T-1}), the reverse pass's scratch, the selector maps and the
// end states (a byte each) of every segment.
struct Layout {
  int obs, a, prod, in, q, cin, carry, fin, rev, sel, end, words;
};

__host__ __device__ inline Layout layout(int K, int T, int lanes,
                                         bool stationary) {
  const int S = mpscan::seg_len(T), G = mpscan::num_segments(T);
  const int chunks = lanes / 8 + 2;
  Layout ly;
  int at = 0;
  ly.obs = at; at += round4(lanes * (S * K + 1));
  ly.a = at; at += round4(stationary ? K * K : lanes * (S * K * K + 1));
  ly.prod = at; at += round4(lanes * K * K);
  ly.in = at; at += round4(lanes * K);
  ly.q = at; at += round4(chunks * K * K);
  ly.cin = at; at += round4(chunks * K);
  ly.carry = at; at += round4(K);
  ly.fin = at; at += round4(K);
  ly.rev = at; at += round4(2 * lanes + 1);
  ly.sel = at; at += round4(G);
  ly.end = at; at += round4((G + 3) / 4);
  ly.words = at;
  return ly;
}

inline long long smem_bytes(int K, int T, int lanes, int seqs,
                            bool stationary) {
  return 4LL * seqs * layout(K, T, lanes, stationary).words;
}

// n floats from src into dst, the steps of a segment (`seg` floats) after
// another's with one float of pad between, 4 bytes a copy: neighbouring
// threads on neighbouring addresses of the source.  The destination is
// stepped along with the source, not divided out of it (an integer
// division an element cost more than the copy).  Every thread of the
// block calls it.
__device__ __forceinline__ void stage_segments(float* dst, const float* src,
                                               int n, int seg) {
  int e = threadIdx.x, i = e / seg, w = e - i * seg;
  const int di = blockDim.x / seg, dw = blockDim.x - di * seg;
  for (; e < n; e += blockDim.x) {
    tilefma::cp_async4_zfill(dst + i * (seg + 1) + w, src + e, true);
    i += di;
    w += dw;
    if (w >= seg) {
      w -= seg;
      ++i;
    }
  }
}

template <int K>
__global__ void __launch_bounds__(MAX_LANES) viterbi_kernel(
    const float* __restrict__ log_pi, const float* __restrict__ log_A,
    long long a_sb, long long a_st, const float* __restrict__ log_obs,
    const int* __restrict__ lengths, unsigned* __restrict__ bp,
    int* __restrict__ states, float* __restrict__ score, int B, int T,
    int lanes, int seqs) {
  extern __shared__ __align__(16) float smem[];
  constexpr int KK = K * K;
  const bool stationary = a_st == 0;
  const int a_step = stationary ? 0 : KK;
  const int S = mpscan::seg_len(T), G = mpscan::num_segments(T);
  const int W = lanes * S;
  const Layout ly = layout(K, T, lanes, stationary);
  const int q = threadIdx.x / lanes, lane = threadIdx.x - q * lanes;
  const int b = blockIdx.x * seqs + q;
  const bool live = q < seqs && b < B;
  float* base = smem + (size_t)(live ? q : 0) * ly.words;
  float* sP = base + ly.prod;
  float* sIn = base + ly.in;
  float* sFin = base + ly.fin;
  float* sQ = base + ly.q;
  float* sCin = base + ly.cin;
  float* sCarry = base + ly.carry;
  unsigned* sSel = reinterpret_cast<unsigned*>(base + ly.sel);
  unsigned char* sEnd = reinterpret_cast<unsigned char*>(base + ly.end);
  const int L = live ? (lengths ? lengths[b] : T) : 0;
  unsigned* bpb = bp + (size_t)(live ? b : 0) * T;

  // the fold's chunks (maxplus_scan.cuh::fold_chunk), and the delta the
  // group's first thread folds over them
  const int C = mpscan::fold_chunk(G), nc = (G + C - 1) / C;
  float carry[K];
#pragma unroll
  for (int j = 0; j < K; ++j) carry[j] = 0.f;
  const int rounds = (G + lanes - 1) / lanes;
  for (int r = 0; r < rounds; ++r) {
    const int t0 = r * W, n = min(W, T - t0);
    __syncthreads();                    // the last round's reads are done
    for (int qq = 0; qq < seqs; ++qq) {
      const int bb = blockIdx.x * seqs + qq;
      if (bb >= B) break;
      float* bs = smem + (size_t)qq * ly.words;
      stage_segments(bs + ly.obs, log_obs + ((size_t)bb * T + t0) * K,
                     n * K, S * K);
      stage_segments(bs + ly.a, log_A + bb * a_sb + (long long)t0 * a_st,
                     stationary ? KK : n * KK, S * KK);
    }
    tilefma::cp_async_commit();
    tilefma::cp_async_wait<0>();
    __syncthreads();
    // step gs + s of this thread's segment: obs at O + s * K, log_A at
    // A + s * a_step
    const float* O = base + ly.obs + lane * (S * K + 1);
    const float* A = base + ly.a + (stationary ? 0 : lane * (S * KK + 1));
    const int g = r * lanes + lane;
    const int gs = g * S, gn = min(S, T - gs);
    // (a) segment 0 seeded and run; the products of the others but the
    // last
    if (live && g < G) {
      if (g == 0) {
        float d[K];
        mpscan::seed<K>(d, log_pi, O, L);
        mpscan::segment_rerun<K>(d, A + a_step, a_step, O + K, 1, gn - 1, L,
                                 bpb + 1);
#pragma unroll
        for (int j = 0; j < K; ++j) sFin[j] = d[j];
      } else if (g < G - 1) {
        mpscan::segment_product<K>(A, a_step, O, gs, gn, L, sP + lane * KK);
      }
    }
    __syncthreads();
    // (b) the fold.  The chunks that start in this round are c_lo..c_hi;
    // with more than one chunk, a round holds whole chunks (the plan's
    // lanes are then a multiple of 8).  (b1) the product of each such
    // chunk but the last, on the thread of its first segment
    const int r0 = r * lanes, r1 = min(G, r0 + lanes);
    const int c_lo = r == 0 ? 0 : (r0 + C - 1) / C, c_hi = (r1 - 1) / C;
    const int c = g / C, first = max(1, c * C), end = min(c * C + C, G);
    // (with one chunk, up to G = 64, (b1) and (b2) have nothing to do)
    if (nc > 1 && live && g >= 1 && g < G && g == first && c < nc - 1) {
      float Q[K][K];
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int j = 0; j < K; ++j) Q[i][j] = sP[(first - r0) * KK + i * K + j];
      for (int gg = first + 1; gg < end; ++gg)
#pragma unroll
        for (int i = 0; i < K; ++i) mpscan::fold<K>(Q[i], sP + (gg - r0) * KK);
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int j = 0; j < K; ++j) sQ[(c - c_lo) * KK + i * K + j] = Q[i][j];
    }
    if (nc > 1) __syncthreads();
    // (b2) the incoming delta of each chunk starting here, folded over the
    // chunk products on the first thread
    if (nc > 1 && live && lane == 0) {
      if (r == 0) {
#pragma unroll
        for (int j = 0; j < K; ++j) carry[j] = sFin[j];
      }
      for (int cc = c_lo; cc <= c_hi; ++cc) {
#pragma unroll
        for (int j = 0; j < K; ++j) sCin[(cc - c_lo) * K + j] = carry[j];
        if (cc < nc - 1) mpscan::fold<K>(carry, sQ + (cc - c_lo) * KK);
      }
    }
    if (nc > 1) __syncthreads();
    // (b3) each chunk's incoming deltas, folded over its own products from
    // its incoming delta (with one chunk, delta_0's successor in sFin), or
    // from the delta it carries over from the last round, on the thread of
    // its first segment in this round
    if (live && g >= 1 && g < G && g == max(first, r0)) {
      float y[K];
      const float* from = g != first ? sCarry
                          : nc > 1   ? sCin + (c - c_lo) * K
                                     : sFin;
#pragma unroll
      for (int j = 0; j < K; ++j) y[j] = from[j];
      const int stop = min(end, r1);
      for (int gg = g; gg < stop; ++gg) {
#pragma unroll
        for (int j = 0; j < K; ++j) sIn[(gg - r0) * K + j] = y[j];
        if (gg + 1 < end) mpscan::fold<K>(y, sP + (gg - r0) * KK);
      }
      if (stop < end) {
#pragma unroll
        for (int j = 0; j < K; ++j) sCarry[j] = y[j];
      }
    }
    __syncthreads();
    // (c) the rerun of segments 1.. from their incoming deltas
    if (live && g >= 1 && g < G) {
      float d[K];
#pragma unroll
      for (int j = 0; j < K; ++j) d[j] = sIn[lane * K + j];
      sSel[g] = mpscan::segment_rerun<K>(d, A, a_step, O, gs, gn, L,
                                         bpb + gs);
      if (g == G - 1) {
#pragma unroll
        for (int j = 0; j < K; ++j) sFin[j] = d[j];
      }
    }
  }
  __syncthreads();
  // (d) the final state and the score, then each segment's end state
  if (live && lane == 0) {
    float fin[K], best;
#pragma unroll
    for (int j = 0; j < K; ++j) fin[j] = sFin[j];
    const int s = mpscan::first_argmax<K>(fin, &best);
    score[b] = best;
    sEnd[G - 1] = (unsigned char)s;
  }
  __syncthreads();
  if (G > 1) {
    const int nl = mpscan::reverse_threads(G - 1, lanes);
    unsigned* rev = reinterpret_cast<unsigned*>(base + ly.rev);
    mpscan::reverse_pass<K>(sSel + 1, 1, G - 1, sEnd[G - 1],
                            live ? lane : nl, nl, rev,
                            reinterpret_cast<int*>(rev + nl), sEnd,
                            [] { __syncthreads(); });
  }
  // (e) the backtrace of each segment (this thread's own backpointers)
  if (live)
    for (int gg = lane; gg < G; gg += lanes) {
      const int ts = gg * S;
      mpscan::segment_backtrace(sEnd[gg], bpb + ts, min(S, T - ts),
                                states + (size_t)b * T + ts);
    }
}

template <int K>
cudaError_t launch(const float* log_pi, const float* log_A, long long a_sb,
                   long long a_st, const float* log_obs, const int* lengths,
                   unsigned* bp, int* states, float* score, int B, int T,
                   int lanes, int seqs, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        viterbi_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int threads = (lanes * seqs + 31) / 32 * 32;
  viterbi_kernel<K><<<(B + seqs - 1) / seqs, threads, smem, stream>>>(
      log_pi, log_A, a_sb, a_st, log_obs, lengths, bp, states, score, B, T,
      lanes, seqs);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of a block of `seqs` sequences of `lanes` threads
// (-1 past the int range).
extern "C" int vqhmm_viterbi_smem_bytes(int T, int K, int stationary,
                                        int lanes, int seqs) {
  if (T <= 0 || K <= 0 || lanes <= 0 || seqs <= 0) return -1;
  const long long n = smem_bytes(K, T, lanes, seqs, stationary != 0);
  return n > SMEM_LIMIT ? -1 : (int)n;
}

// log_A (B, T, K, K) read through a_sb (0: shared by the batch) and a_st
// (K * K: a matrix a step, 0: stationary); log_obs (B, T, K) contiguous;
// lengths (B,) or null; bp a (B, T) scratch of 32-bit words; states (B, T)
// int32, score (B,).  K is bounded by the 4-bit backpointers and the
// template instances.
extern "C" int vqhmm_viterbi(const float* log_pi, const float* log_A,
                             long long a_sb, long long a_st,
                             const float* log_obs, const int* lengths,
                             unsigned* bp, int* states, float* score, int B,
                             int T, int K, int lanes, int seqs,
                             void* stream) {
  if (B <= 0 || T <= 0 || K < 1 || K > mpscan::MAX_K ||
      (a_st != 0 && a_st != (long long)K * K) || lanes < 1 || seqs < 1 ||
      lanes * seqs > MAX_LANES)
    return (int)cudaErrorInvalidValue;
  // the fold's chunks lie within a round
  const int G = mpscan::num_segments(T);
  if (lanes < G && mpscan::fold_chunk(G) < G && lanes % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const int smem = vqhmm_viterbi_smem_bytes(T, K, a_st == 0, lanes, seqs);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define VQHMM_VITERBI_CASE(KV)                                             \
  case KV:                                                                 \
    return (int)launch<KV>(log_pi, log_A, a_sb, a_st, log_obs, lengths, bp, \
                           states, score, B, T, lanes, seqs, smem, st);
  switch (K) {
    VQHMM_VITERBI_CASE(1)
    VQHMM_VITERBI_CASE(2)
    VQHMM_VITERBI_CASE(3)
    VQHMM_VITERBI_CASE(4)
    VQHMM_VITERBI_CASE(5)
    VQHMM_VITERBI_CASE(6)
    VQHMM_VITERBI_CASE(7)
    VQHMM_VITERBI_CASE(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef VQHMM_VITERBI_CASE
}
