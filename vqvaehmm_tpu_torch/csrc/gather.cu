// Window gather of the device input pipeline for Hopper (sm_90a), a whole
// epoch in one launch:
//   x[w, c, t] = pool_x[si[w], c, st[w] + t]   for t < ln[w], else 0
//   u[w, c, t] = pool_u[si[w], c, st[w] + t]   for t < ln[w], else 0
// for the W = S * B windows of an epoch of S batches of B (w = s * B + b);
// one batch is the case S = 1.
//
// Replaces the TPU kernels vqvaehmm_tpu/ops/pallas_gather.py::
// _kernel_resident and ::_kernel_dma in one kernel: the TPU split them
// only by whether the pool fits VMEM, and here the pool always stays in
// device memory.  The wrappers (gather_epoch, gather_windows) and their
// plain PyTorch versions are in vqvaehmm_tpu_torch/ops/gather.py.
//
// Layout: pools (N, C, Tmax) and (N, U, Tmax) float32, each sequence
// zero-padded to Tmax; outputs (W, C, T) and (W, U, T), which are the
// epoch's (S, B, C, T) and (S, B, U, T): the layout of the host collate and
// of the fused train kernel (csrc/fused_train.cu) a batch.
//
// Design and bound.  The work is a copy: 2 * 4 * W * (C + U) * T bytes,
// 6.9 MB an epoch of the VQ configuration (S = 15, B = 64, C + U = 9,
// T = 200), 2.1 us of the card's memory rate, against 2-3 us for any
// launch.  So the design takes the launches out: the whole epoch is one
// grid of one block a window (960 blocks at that configuration, about
// seven on each of the 132 SMs), where a launch a batch took 15 launches
// and a torch.stack copy of the epoch.  A block reads its triple once and
// walks the window's (C + U) x T elements with its lanes over t, so both
// the read of the pool row at the unaligned start st and the write of the
// output row are coalesced (the read spans at most one 32-byte sector
// more than the write).  Nothing is carried over from the TPU kernel's
// 128-aligned wide load and rotate: those exist only for Mosaic's aligned
// dynamic slices.
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
    int N, int C, int U, int Tmax, int T) {
  const long long w = blockIdx.x;
  const int s = si[w], s0 = st[w], L = ln[w];
  const bool ok = s >= 0 && s < N && s0 >= 0 && L >= 0 && s0 + L <= Tmax;
  // the window's pool rows and output rows (the pool's only read if ok)
  const float* px = pool_x + ((long long)(ok ? s : 0) * C) * Tmax + s0;
  const float* pu = pool_u + ((long long)(ok ? s : 0) * U) * Tmax + s0;
  float* xo = x + w * C * T;
  float* uo = u + w * U * T;
  const int n = (C + U) * T, valid = ok ? L : 0;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int ch = i / T, t = i - ch * T;
    if (ch < C)
      xo[i] = t < valid ? px[ch * Tmax + t] : 0.f;
    else
      uo[i - C * T] = t < valid ? pu[(ch - C) * Tmax + t] : 0.f;
  }
}

}  // namespace

extern "C" int vqhmm_gather(const float* pool_x, const float* pool_u,
                            const int* si, const int* st, const int* ln,
                            float* x, float* u, int N, int C, int U, int Tmax,
                            int W, int T, void* stream) {
  if (W <= 0 || T <= 0 || C + U <= 0) return (int)cudaErrorInvalidValue;
  gather_kernel<<<(unsigned)W, THREADS, 0, (cudaStream_t)stream>>>(
      pool_x, pool_u, si, st, ln, x, u, N, C, U, Tmax, T);
  return (int)cudaGetLastError();
}
