// Nearest-code vector quantization for Hopper (sm_90a):
//   idx[n]  = argmax_m ( z_n . e_m - 0.5 * |e_m|^2 )   (first index on a tie)
//   zq[n]   = e_{idx[n]}
// which is argmin_m |z_n - e_m|^2 with the |z_n|^2 term, constant in m,
// dropped.
//
// Replaces the TPU kernel vqvaehmm_tpu/ops/vq.py::_vq_kernel (entry
// vq_pallas).  The wrapper and its plain PyTorch version are in
// vqvaehmm_tpu_torch/ops/vq.py.
//
// Layout.  z and zq are addressed as (B, D, T) through three strides, so
// the model's channels-first latents (B, D, T) go in as they are and a
// flat (N, D) array goes in as B=1, T=N with strides (0, 1, D).  idx is
// (B * T,) int32 in token order n = b * T + t.  The codebook is (M, D)
// row-major.
//
// Design and bound.  Each input is read once and each output written once:
// N*D*4*2 + N*4 + M*D*4 bytes against 2*N*M*D operations, so the kernel is
// bound by bytes (0.0005 ms at N=12800, M=8, D=16) and in practice by its
// launch.  The codebook and its M half norms are staged in shared memory
// once a block (the half norms are computed here, not by a call before
// the launch).  One thread owns one token: it holds the token's D latents
// in registers, runs one FMA chain over d for each code, subtracts the half
// norm and keeps the running best with a strict `>`, so the first maximum
// wins as in argmax.  It then copies the winning row out of shared memory,
// which makes zq bit-equal to codebook[idx].  Consecutive threads take
// consecutive t, so with the channels-first layout every load and store of
// a warp is one coalesced row segment and no transpose is launched.
// Nothing is carried over from the TPU kernel's 1024-row VMEM block or its
// one-hot matmul: that re-expansion exists there because the TPU has no
// cheap gather.
//
// The latents sit in a register array of DP = D rounded up to a power of
// two (8..64), zero past D, and the codebook rows in shared memory are
// padded to DP the same way: fma(0, 0, acc) leaves acc as it was, so the
// padding changes no score.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_D = 64;
constexpr int SMEM_LIMIT = 48 * 1024;   // a block's default shared memory

template <int DP>
__global__ void __launch_bounds__(THREADS) vq_nearest_kernel(
    const float* __restrict__ z, long long zb, long long zd, long long zt,
    const float* __restrict__ cb, float* __restrict__ zq,
    int* __restrict__ idx, int B, int T, int M, int D) {
  extern __shared__ float smem[];
  float* e = smem;                 // (M, DP), zero past D
  float* half = smem + M * DP;     // (M,)
  for (int i = threadIdx.x; i < M * DP; i += THREADS) {
    const int m = i / DP, d = i % DP;
    e[i] = d < D ? cb[m * D + d] : 0.f;
  }
  __syncthreads();
  for (int m = threadIdx.x; m < M; m += THREADS) {
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(e[m * DP + d], e[m * DP + d], s);
    half[m] = 0.5f * s;
  }
  __syncthreads();

  const long long total = (long long)B * T;
  for (long long n = blockIdx.x * (long long)THREADS + threadIdx.x;
       n < total; n += (long long)gridDim.x * THREADS) {
    const long long b = n / T, t = n % T;
    const long long base = b * zb + t * zt;
    float zr[DP];
#pragma unroll
    for (int d = 0; d < DP; ++d) zr[d] = d < D ? z[base + d * zd] : 0.f;
    int best = 0;
    float best_score = 0.f;
    for (int m = 0; m < M; ++m) {
      const float* row = e + m * DP;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < DP; ++d) acc = fmaf(zr[d], row[d], acc);
      const float score = acc - half[m];
      if (m == 0 || score > best_score) {
        best_score = score;
        best = m;
      }
    }
    idx[n] = best;
    const float* row = e + best * DP;
#pragma unroll
    for (int d = 0; d < DP; ++d)
      if (d < D) zq[base + d * zd] = row[d];
  }
}

int padded_d(int D) {
  int dp = 8;
  while (dp < D) dp *= 2;
  return dp;
}

// Shared memory a block needs, or -1 where D is past the register loop.
int smem_bytes(int M, int D) {
  if (M <= 0 || D <= 0 || D > MAX_D) return -1;
  return (int)sizeof(float) * (M * padded_d(D) + M);
}

}  // namespace

extern "C" int vqhmm_vq_nearest(const float* z, long long zb, long long zd,
                                long long zt, const float* cb, float* zq,
                                int* idx, int B, int T, int M, int D,
                                void* stream) {
  if (B <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(M, D);
  if (smem < 0 || smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * T;
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;  // grid-stride beyond
  const dim3 grid((unsigned)blocks);
  cudaStream_t s = (cudaStream_t)stream;
  switch (padded_d(D)) {
    case 8:
      vq_nearest_kernel<8><<<grid, THREADS, smem, s>>>(
          z, zb, zd, zt, cb, zq, idx, B, T, M, D);
      break;
    case 16:
      vq_nearest_kernel<16><<<grid, THREADS, smem, s>>>(
          z, zb, zd, zt, cb, zq, idx, B, T, M, D);
      break;
    case 32:
      vq_nearest_kernel<32><<<grid, THREADS, smem, s>>>(
          z, zb, zd, zt, cb, zq, idx, B, T, M, D);
      break;
    default:
      vq_nearest_kernel<64><<<grid, THREADS, smem, s>>>(
          z, zb, zd, zt, cb, zq, idx, B, T, M, D);
      break;
  }
  return (int)cudaGetLastError();
}
