// Viterbi MAP decode (path and score) for Hopper (sm_90a).
//
// Replaces the three TPU kernels of vqvaehmm_tpu/ops/pallas_hmm.py: the
// monolithic doubling-scan kernel (_viterbi_kernel) and the chunked pair
// (_viterbi_fwd_tiled_kernel, _viterbi_bwd_tiled_kernel).  They were split
// only because the TPU's VMEM bounds T; here the backpointers go to a
// (B, T, K) int8 scratch in device memory that the wrapper allocates, so
// one kernel covers every T.  The Python wrapper and its plain PyTorch
// version are in vqvaehmm_tpu_torch/ops/fused_viterbi.py.
//
// Design.  One warp decodes one sequence.  The recursion is sequential in
// T and costs K*K adds and compares a step, so the kernel is bound by the
// latency of each step, not by arithmetic or bandwidth.  The warp stages
// CH steps of log_A and log_obs at a time into shared memory with
// coalesced loads; lane 0 then runs the max-plus recursion over them with
// delta in registers (K is a template parameter) and writes the
// backpointers.  The backtrace walks the backpointers in reverse, again
// staged CH steps at a time by the whole warp.
//
// Semantics (vqvaehmm_tpu/ops/hmm.py:66-77, 200-229): a step t >= L is an
// identity transition (0 on the diagonal, -inf elsewhere) with a zero
// observation; scores[i][j] = delta[i] + A[i][j], the first maximum over i
// wins (strict >), then delta[j] = best + obs[j].  The operations and their
// order are those of the plain version, so the two agree bit for bit on
// the same inputs.  -inf only meets finite values in an add or a compare,
// which gives -inf, never NaN.

#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int CH = 128;   // time steps staged per round

template <int K>
__global__ void __launch_bounds__(32) viterbi_kernel(
    const float* __restrict__ log_pi, const float* __restrict__ log_A,
    long long a_sb, long long a_st, const float* __restrict__ log_obs,
    const int* __restrict__ lengths, int8_t* __restrict__ bp,
    int* __restrict__ states, float* __restrict__ score, int T) {
  __shared__ float sA[CH * K * K];
  __shared__ float sO[CH * K];
  __shared__ int8_t sB[CH * K];
  __shared__ int sS[CH];

  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int L = lengths ? lengths[b] : T;
  const float* Ab = log_A + (long long)b * a_sb;
  const float* Ob = log_obs + (size_t)b * T * K;
  int8_t* bpb = bp + (size_t)b * T * K;
  int* sb = states + (size_t)b * T;

  float delta[K];
#pragma unroll
  for (int k = 0; k < K; ++k) delta[k] = log_pi[k] + (0 < L ? Ob[k] : 0.f);

  for (int c0 = 1; c0 < T; c0 += CH) {
    const int n = min(CH, T - c0);
    for (int idx = lane; idx < n * K * K; idx += 32) {
      const int tt = idx / (K * K);
      sA[idx] = Ab[(long long)(c0 + tt) * a_st + (idx - tt * K * K)];
    }
    for (int idx = lane; idx < n * K; idx += 32)
      sO[idx] = Ob[(size_t)c0 * K + idx];
    __syncwarp();
    if (lane == 0) {
      for (int tt = 0; tt < n; ++tt) {
        const bool valid = c0 + tt < L;
        const float* a = sA + tt * K * K;
        float nd[K];
#pragma unroll
        for (int j = 0; j < K; ++j) {
          float best = delta[0] + (valid ? a[j] : (j == 0 ? 0.f : -INFINITY));
          int arg = 0;
#pragma unroll
          for (int i = 1; i < K; ++i) {
            const float s = delta[i] +
                (valid ? a[i * K + j] : (i == j ? 0.f : -INFINITY));
            if (s > best) { best = s; arg = i; }
          }
          nd[j] = best + (valid ? sO[tt * K + j] : 0.f);
          sB[tt * K + j] = (int8_t)arg;
        }
#pragma unroll
        for (int j = 0; j < K; ++j) delta[j] = nd[j];
      }
    }
    __syncwarp();
    for (int idx = lane; idx < n * K; idx += 32)
      bpb[(size_t)c0 * K + idx] = sB[idx];
    __syncwarp();
  }

  // final state: first maximum of delta_{T-1}
  int s = 0;
  if (lane == 0) {
    float best = delta[0];
#pragma unroll
    for (int k = 1; k < K; ++k)
      if (delta[k] > best) { best = delta[k]; s = k; }
    score[b] = best;
    sb[T - 1] = s;
  }
  __syncwarp();  // orders the backpointer stores above before the loads below

  // backtrace s_{t-1} = bp_t[s_t], CH steps [lo, hi) at a time
  for (int hi = T; hi > 1; hi -= CH) {
    const int lo = max(1, hi - CH);
    const int n = hi - lo;
    for (int idx = lane; idx < n * K; idx += 32)
      sB[idx] = bpb[(size_t)lo * K + idx];
    __syncwarp();
    if (lane == 0) {
      for (int t = hi - 1; t >= lo; --t) {
        s = sB[(t - lo) * K + s];
        sS[t - lo] = s;   // state at t - 1
      }
    }
    __syncwarp();
    for (int idx = lane; idx < n; idx += 32) sb[lo - 1 + idx] = sS[idx];
    __syncwarp();
  }
}

template <int K>
cudaError_t launch(const float* log_pi, const float* log_A, long long a_sb,
                   long long a_st, const float* log_obs, const int* lengths,
                   int8_t* bp, int* states, float* score, int B, int T,
                   cudaStream_t stream) {
  viterbi_kernel<K><<<B, 32, 0, stream>>>(log_pi, log_A, a_sb, a_st, log_obs,
                                          lengths, bp, states, score, T);
  return cudaGetLastError();
}

}  // namespace

// K is bounded by the int8 backpointers and by the template instances.
extern "C" int vqhmm_viterbi(const float* log_pi, const float* log_A,
                             long long a_sb, long long a_st,
                             const float* log_obs, const int* lengths,
                             int8_t* bp, int* states, float* score, int B,
                             int T, int K, void* stream) {
  if (B <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (K) {
    case 1: return (int)launch<1>(log_pi, log_A, a_sb, a_st, log_obs, lengths, bp, states, score, B, T, st);
    case 2: return (int)launch<2>(log_pi, log_A, a_sb, a_st, log_obs, lengths, bp, states, score, B, T, st);
    case 3: return (int)launch<3>(log_pi, log_A, a_sb, a_st, log_obs, lengths, bp, states, score, B, T, st);
    case 4: return (int)launch<4>(log_pi, log_A, a_sb, a_st, log_obs, lengths, bp, states, score, B, T, st);
    case 5: return (int)launch<5>(log_pi, log_A, a_sb, a_st, log_obs, lengths, bp, states, score, B, T, st);
    case 6: return (int)launch<6>(log_pi, log_A, a_sb, a_st, log_obs, lengths, bp, states, score, B, T, st);
    case 7: return (int)launch<7>(log_pi, log_A, a_sb, a_st, log_obs, lengths, bp, states, score, B, T, st);
    case 8: return (int)launch<8>(log_pi, log_A, a_sb, a_st, log_obs, lengths, bp, states, score, B, T, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
