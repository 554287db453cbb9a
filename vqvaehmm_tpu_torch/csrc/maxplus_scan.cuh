// One segmented max-plus Viterbi decode of a sequence: the recursion of the
// Viterbi kernel (viterbi.cu, kernel B) and of the one-kernel decode
// (fused_decode.cu::fused_decode_kernel, kernel 10).  Each device function
// below is one phase's work on one segment; the kernels place the data and
// the threads.  The plain PyTorch version of the whole scan, operation for
// operation, is vqvaehmm_tpu_torch/ops/fused_viterbi.py::
// viterbi_segmented_reference.
//
// T steps are cut into G = ceil(T / S) segments of S steps, aligned at
// multiples of S from t = 0 (the last one may be shorter).  Step t >= 1 is
// the max-plus matrix E_t[i][j] = A_t[i][j] + obs_t[j]; a step t >= L is
// inert (A the identity: 0 on the diagonal, -inf elsewhere; obs 0), as in
// vqvaehmm_tpu_torch/ops/hmm.py::_mask_inputs, so the path freezes at
// t = L - 1.
//  (a) Segment products, in parallel over segments.  Segment 0 is seeded
//      with delta_0 = log_pi + obs_0 and runs its steps as (c) does; every
//      other segment but the last builds its product P_g: row r is the
//      delta after the segment's steps from the unit vector at r (0 at r,
//      -inf elsewhere).  The last segment's product is never needed.
//  (b) Fold: the incoming delta of segment 1 is segment 0's end delta,
//      and in_{g+1}[j] = max_r in_g[r] + P_g[r][j].  Up to G = 64 one
//      thread folds the segments in ascending order.  Above, in two levels
//      over chunks of 8 segments aligned at multiples of 8 (chunk c holds
//      the segments [max(1, 8c), min(8c + 8, G))): the product Q_c of each
//      chunk's P_g but the last chunk's, in parallel (left to right, each
//      row a fold); one thread folds the Q_c in ascending order for each
//      chunk's incoming delta; then, in parallel, each chunk folds its own
//      P_g from it.  The serial depth falls from G to about 3 sqrt-ish
//      steps (G / 8 + 2 * 8 at T = 2327: 34 instead of 144).
//  (c) Rerun, in parallel: segment g >= 1 runs its steps again from in_g,
//      emitting its backpointers (4 bits a state, a 32-bit word a step) and
//      its selector map (for each end state, the state before the
//      segment: a word of 4-bit entries); the last segment's end delta is
//      delta_{T-1}.
//  (d) Reverse pass: the final state is the first argmax of delta_{T-1},
//      its value the score; end_{g-1} = sel_g[end_g], integer lookups in
//      parallel over ranges of segments (composed maps, then a walk over
//      the ranges, then each range), which leaves every bit as a walk on
//      one thread would.
//  (e) Backtrace, in parallel: each segment walks its backpointers back
//      from its end state.
// A step is the recursion of ops/hmm.py::viterbi: delta[i] + A[i][j], the
// first maximum over i wins (strict >), then + obs[j].
//
// Invariants:
//  * S (seg_len) and the order of the fold (fold_chunk) are functions of T
//    alone, never
//    of B, the tile, the grid or the launch plan, and S divides 16, so
//    every tile width of kernels 8, 10 and 11 (16, 32, 64) holds whole
//    segments.  A row of a batch is therefore bit-equal to the row decoded
//    alone, and kernel 10, fed the evidence bits of kernel 11, decodes the
//    bits of kernel 11 followed by kernel B.
//  * No atomics: two calls give the same bits.
//  * -inf meets finite values only in adds and compares, never NaN (there
//    is no subtraction and no -inf + inf: A and obs are finite or -inf).
//  * Adds and compares only, no multiply for the compiler to contract, so
//    the plain version reproduces every bit.
// The fold reassociates the sums at segment boundaries, so delta differs
// from the sequential recursion by float roundings: where two paths tie
// to within them the states may differ from ops/hmm.py::viterbi, and the
// scores agree to 1e-4 absolute or 32 float32 roundings of the score.

#pragma once

#include <cuda_runtime.h>

namespace mpscan {

constexpr int MAX_K = 8;    // 4-bit backpointers, 8 to a 32-bit word
constexpr int MAX_SEG = 16;  // the longest segment

// S, the steps a segment: 4 up to T = 32, 8 up to 128, then 16.
__host__ __device__ inline int seg_len(int T) {
  return T > 128 ? 16 : (T > 32 ? 8 : 4);
}

__host__ __device__ inline int num_segments(int T) {
  const int S = seg_len(T);
  return (T + S - 1) / S;
}

// The segments of a chunk of the fold, from the G segments: all of them
// (one serial pass) up to G = 64, else 8.
__host__ __device__ inline int fold_chunk(int G) { return G > 64 ? 8 : G; }

// The selector map that sends every state to itself.
template <int K>
__device__ __forceinline__ unsigned identity_map() {
  unsigned m = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) m |= (unsigned)j << (4 * j);
  return m;
}

__device__ __forceinline__ int entry(unsigned word, int s) {
  return (int)((word >> (4 * s)) & 15u);
}

// delta_0 = log_pi + obs_0 (obs_0 taken as 0 where L == 0).
template <int K>
__device__ __forceinline__ void seed(float (&d)[K], const float* log_pi,
                                     const float* o, int L) {
#pragma unroll
  for (int j = 0; j < K; ++j) d[j] = log_pi[j] + (0 < L ? o[j] : 0.f);
}

// One step: d <- max_i (d[i] + A[i][j]) + obs[j], A row-major at a, obs at
// o, the inert step where !valid (a and o are then not read).  Returns
// the step's backpointers, state j's in bits [4j, 4j + 4).
template <int K>
__device__ __forceinline__ unsigned step(float (&d)[K], const float* a,
                                         const float* o, bool valid) {
  float nd[K];
  unsigned bp = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    float best = d[0] + (valid ? a[j] : (j == 0 ? 0.f : -INFINITY));
    int arg = 0;
#pragma unroll
    for (int i = 1; i < K; ++i) {
      const float s =
          d[i] + (valid ? a[i * K + j] : (i == j ? 0.f : -INFINITY));
      const bool gt = s > best;       // selects, not a branch
      best = gt ? s : best;
      arg = gt ? i : arg;
    }
    nd[j] = best + (valid ? o[j] : 0.f);
    bp |= (unsigned)arg << (4 * j);
  }
#pragma unroll
  for (int j = 0; j < K; ++j) d[j] = nd[j];
  return bp;
}

// (a) The product of the n steps from time t0 into P[r * K + j]; step
// t0 + s reads A at a + s * a_step (a_step 0: one stationary matrix) and
// obs at o + s * K.  Up to K = 4 every row runs at once (K independent
// chains a step); above, one row at a time (K floats live, not K * K).
template <int K>
__device__ __forceinline__ void segment_product(const float* a, int a_step,
                                                const float* o, int t0, int n,
                                                int L, float* P) {
  constexpr int RB = K <= 4 ? K : 1;
  for (int r0 = 0; r0 < K; r0 += RB) {
    float d[RB][K];
#pragma unroll
    for (int q = 0; q < RB; ++q)
#pragma unroll
      for (int j = 0; j < K; ++j) d[q][j] = j == r0 + q ? 0.f : -INFINITY;
    for (int s = 0; s < n; ++s) {
#pragma unroll
      for (int q = 0; q < RB; ++q)
        step<K>(d[q], a + s * a_step, o + s * K, t0 + s < L);
    }
#pragma unroll
    for (int q = 0; q < RB; ++q)
#pragma unroll
      for (int j = 0; j < K; ++j) P[(r0 + q) * K + j] = d[q][j];
  }
}

// (a) for segment 0 and (c): the n steps from time t0 run from d, the
// backpointers of step t0 + s to bpw[s]; returns the selector map (for
// each state after the last step, the state before the first).
template <int K>
__device__ __forceinline__ unsigned segment_rerun(float (&d)[K],
                                                  const float* a, int a_step,
                                                  const float* o, int t0,
                                                  int n, int L,
                                                  unsigned* bpw) {
  unsigned map = identity_map<K>();
  for (int s = 0; s < n; ++s) {
    const unsigned w = step<K>(d, a + s * a_step, o + s * K, t0 + s < L);
    bpw[s] = w;
    unsigned next = 0;
#pragma unroll
    for (int j = 0; j < K; ++j)
      next |= (unsigned)entry(map, entry(w, j)) << (4 * j);
    map = next;
  }
  return map;
}

// (b) One fold step: c <- max_r c[r] + P[r][j], the first maximum.
template <int K>
__device__ __forceinline__ void fold(float (&c)[K], const float* P) {
  float nc[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    float best = c[0] + P[j];
#pragma unroll
    for (int r = 1; r < K; ++r) {
      const float s = c[r] + P[r * K + j];
      best = s > best ? s : best;
    }
    nc[j] = best;
  }
#pragma unroll
  for (int j = 0; j < K; ++j) c[j] = nc[j];
}

// (d) The first argmax of delta_{T-1}; its value in *best.
template <int K>
__device__ __forceinline__ int first_argmax(const float (&d)[K],
                                            float* best) {
  float b = d[0];
  int s = 0;
#pragma unroll
  for (int k = 1; k < K; ++k) {
    const bool gt = d[k] > b;
    b = gt ? d[k] : b;
    s = gt ? k : s;
  }
  *best = b;
  return s;
}

// (e) The states of a segment's n <= MAX_SEG steps into out[0, n), given
// its end state: out[s - 1] = bp of step s at out[s] (bpw[s] as
// segment_rerun wrote it; bpw[0] is not read).  The words are loaded all
// at once into registers, so the walk waits on one load, not n.
__device__ __forceinline__ void segment_backtrace(int end, const unsigned* bpw,
                                                  int n, int* out) {
  unsigned w[MAX_SEG];
#pragma unroll
  for (int i = 1; i < MAX_SEG; ++i)
    if (i < n) w[i] = bpw[i];
  int s = end;
  out[n - 1] = s;
#pragma unroll
  for (int i = MAX_SEG - 1; i >= 1; --i)
    if (i < n) {
      s = entry(w[i], s);
      out[i - 1] = s;
    }
}

// (d) in parallel: the end states ends[lo - 1 .. hi] of segments lo - 1 to
// hi, given segment hi's end state s_hi and the selector maps of segments
// lo..hi at map[g - lo].  Threads id < nl each take a range of segments
// from the top: compose its maps, then one thread walks the ranges'
// composites from s_hi, then each walks its own range; with nl = 1 thread
// 0 walks the maps alone.  Every thread with an id calls it (sync() is
// their barrier, and it ends with one); comp and bnd are nl and nl + 1
// words of scratch.  Returns, on thread 0, the state before segment lo.
template <int K, typename E, typename Sync>
__device__ __forceinline__ int reverse_pass(const unsigned* map, int lo,
                                            int hi, int s_hi, int id, int nl,
                                            unsigned* comp, int* bnd,
                                            E* ends, Sync sync) {
  if (nl == 1) {
    int s = s_hi;
    if (id == 0) {
      ends[hi] = (E)s;
      for (int g = hi; g >= lo; --g) {
        s = entry(map[g - lo], s);
        ends[g - 1] = (E)s;
      }
    }
    sync();
    return s;
  }
  const int R = (hi - lo + nl) / nl;          // segments a range
  const int rhi = hi - id * R, rlo = max(lo, rhi - R + 1);
  const bool mine = id < nl && rhi >= lo;
  if (mine) {
    unsigned f = identity_map<K>();
    for (int g = rhi; g >= rlo; --g) {
      const unsigned m = map[g - lo];
      unsigned next = 0;
#pragma unroll
      for (int s = 0; s < K; ++s)
        next |= (unsigned)entry(m, entry(f, s)) << (4 * s);
      f = next;
    }
    comp[id] = f;
  }
  sync();
  if (id == 0) {
    int s = s_hi;
    for (int l = 0; l < nl && hi - l * R >= lo; ++l) {
      bnd[l] = s;
      s = entry(comp[l], s);
    }
    bnd[nl] = s;
  }
  sync();
  if (mine) {
    int s = bnd[id];
    ends[rhi] = (E)s;
    for (int g = rhi; g >= rlo; --g) {
      s = entry(map[g - lo], s);
      ends[g - 1] = (E)s;
    }
  }
  const int before = bnd[nl];
  sync();
  return before;
}

// Threads for reverse_pass over n maps: one up to 32 maps (the walk is
// shorter than three barriers), else about sqrt(n), at most `most`.
__device__ __forceinline__ int reverse_threads(int n, int most) {
  if (n <= 32) return 1;
  int t = 1;
  while (t * t < n) ++t;
  return t < most ? t : most;
}

}  // namespace mpscan
