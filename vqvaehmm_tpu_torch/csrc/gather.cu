// Window gather of the device input pipeline for Hopper (sm_90a):
//   x[b, c, t] = pool_x[si[b], c, st[b] + t]   for t < ln[b], else 0
//   u[b, c, t] = pool_u[si[b], c, st[b] + t]   for t < ln[b], else 0
//
// Replaces the TPU kernels vqvaehmm_tpu/ops/pallas_gather.py::
// _kernel_resident and ::_kernel_dma in one kernel: the TPU split them
// only by whether the pool fits VMEM, and here the pool always stays in
// device memory.  The wrapper and its plain PyTorch version are in
// vqvaehmm_tpu_torch/ops/gather.py.
//
// Layout: pools (N, C, Tmax) and (N, U, Tmax) float32, each sequence
// zero-padded to Tmax; outputs (B, C, T) and (B, U, T), the layout of the
// host collate and of the fused train kernel (csrc/fused_train.cu).
//
// Design and bound.  One thread computes one output element; a warp
// covers 32 neighbouring time steps of one row, so both the read of the
// pool row and the write are coalesced (the read is shifted by st[b], so
// it spans at most two extra 32-byte sectors).  At B=64, T=200, C+U=9 a
// call moves about 0.9 MB, which the card's bandwidth serves in well
// under a microsecond: the kernel is bound by its launch latency, and its
// design does nothing more than keep every access coalesced.  Nothing is
// carried over from the TPU kernel's 128-aligned wide load and rotate:
// those exist only for Mosaic's aligned dynamic slices.
//
// A window that would read outside its pool row (a triple the sampler
// never makes; ops/gather.py validates triples on the host) is written as
// zeros rather than read out of bounds.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) gather_kernel(
    const float* __restrict__ pool_x, const float* __restrict__ pool_u,
    const int* __restrict__ si, const int* __restrict__ st,
    const int* __restrict__ ln, float* __restrict__ x, float* __restrict__ u,
    int N, int C, int U, int Tmax, int B, int T) {
  const long long total = (long long)B * (C + U) * T;
  for (long long idx = blockIdx.x * (long long)THREADS + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * THREADS) {
    const int t = (int)(idx % T);
    const long long row = idx / T;       // b * (C + U) + channel
    const int ch = (int)(row % (C + U));
    const int b = (int)(row / (C + U));
    const int s = si[b], s0 = st[b], L = ln[b];
    const bool ok = s >= 0 && s < N && s0 >= 0 && L >= 0 && s0 + L <= Tmax;
    float v = 0.f;
    if (ok && t < L) {
      v = ch < C ? pool_x[((long long)s * C + ch) * Tmax + s0 + t]
                 : pool_u[((long long)s * U + (ch - C)) * Tmax + s0 + t];
    }
    if (ch < C)
      x[((long long)b * C + ch) * T + t] = v;
    else
      u[((long long)b * U + (ch - C)) * T + t] = v;
  }
}

}  // namespace

extern "C" int vqhmm_gather(const float* pool_x, const float* pool_u,
                            const int* si, const int* st, const int* ln,
                            float* x, float* u, int N, int C, int U, int Tmax,
                            int B, int T, void* stream) {
  if (B <= 0 || T <= 0 || C + U <= 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * (C + U) * T;
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;  // grid-stride beyond
  gather_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      pool_x, pool_u, si, st, ln, x, u, N, C, U, Tmax, B, T);
  return (int)cudaGetLastError();
}
