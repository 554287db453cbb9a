// Fused training step of the VAE-HMM for Hopper (sm_90a): the masked
// negative ELBO and the gradients of all 18 parameter arrays in one call.
//
// Replaces the TPU kernel vqvaehmm_tpu/ops/pallas_train.py::_kernel and
// the loss assembly and log_prior chain of its wrapper
// (fused_loss_and_grads, :551-600).  The Python wrapper, the launch plan,
// the torch.autograd.Function around it and its two plain PyTorch versions
// (compute_loss plus autograd; the same tiles and closed-form backward as
// here) are in vqvaehmm_tpu_torch/ops/fused_train.py.
//
// Layout: x (B, C, T) float32 contiguous; u (B, U, T) or (B, T, U), read
// through strides; lengths (B,) int32; the weights are the torch modules'
// own tensors (Conv1d (O, I, 3), Linear (out, in), Embedding (K, D)).  The
// gradients come out as one flat float32 vector, the 18 arrays in
// state_dict order and layout, which the wrapper views as tensors.
//
// Semantics (vqvaehmm_tpu/models/vae_hmm.py::compute_loss):
//  * valid_to = max(lengths).  x is zeroed at t >= valid_to only as the
//    encoder's input; the NLL reads raw x.  h1, e and hd1 are zeroed at
//    t >= valid_to; h2 and hd2 are not.  Every convolution pads its own
//    input with zeros outside [0, T).
//  * loss mask mf[t] = t < length; pairwise mask pm[t] = mf[t] * mf[t-1],
//    zero at t = 0; the initial term reads q at t = 0 for every row.
//  * var = max(exp(logvar), 1e-8), with a zero gradient where the clamp
//    holds.
//  * loss = S_nll / max(sum(mf) * C, 1) - beta/B * S_prior + beta/B * S_qlogq
//    with the three sums over the batch.
//  * d log_prior = g - softmax(log_prior) * sum(g), g the gradient of
//    log_pi = log_softmax(log_prior).
//  * the backward pass: the closed-form softmax and log-softmax VJPs, the
//    transposed conv taps, and the transition cross terms through q[t-1]
//    and q[t+1].
//
// Design.  One call enqueues five kernels on the caller's stream; a kernel
// boundary is the grid-wide barrier between them, and a device scratch
// (rows of T floats a sequence, see Rows) carries what one leaves for the
// next.
//  0. train_pack_kernel: the weights, and the transposed weights the backward
//     convolves with, into the order the building block stages them in
//     (tile_fma.cuh), so that a block copies a slab of a layer as one
//     contiguous run of 16-byte words.
//  1. train_forward_kernel: a block a (sequence, time tile), the tile 16, 32 or
//     64 steps (the wrapper picks the widest that still gives every SM two
//     blocks).  The block stages x and u with a halo of 4 steps a side and
//     walks the model layer by layer through the register-tiled building
//     block of tile_fma.cuh, every activation of the window in shared
//     memory; it writes its own steps of each activation, and of
//     d(mu, logvar), to the scratch, and its sum of the NLL.
//  2. train_backward_kernel: the same grid.  The activation gradients need their
//     neighbours through three transposed convolutions, so a block
//     recomputes them on a halo of 3 steps a side from the scratch (the
//     forward's values of any step are there, whichever block made them):
//     dhd2, dhd1, de, the per-step softmax stage with the transition cross
//     terms, dh2, dh1, dhp.  The transposed layers go through the same
//     building block (its TRANS staging).  It writes its own steps of each
//     gradient to the scratch, and its sums of the prior and entropy terms.
//  3. train_weight_grad_kernel: the nine weight gradients
//     gw[o][i][k] = sum_t dy[o][t] in[i][t-1+k] as a tiled reduction.  A
//     block of 64 threads owns 32 x 32 (o, i) pairs of one gradient and
//     one of `splits` fixed ranges of the (sequence, slab of 32 steps)
//     units; it stages a slab of dy and of in from the scratch in shared
//     memory (asynchronous copies into one of two buffers while the FMAs
//     read the other), transposed so that a thread reads its 4 outputs and its 4
//     inputs of a step as one 16-byte word each, and keeps 4 x 4 pairs with
//     all three taps in registers: 48 independent FMAs for two loads a
//     step.  The small layers ride in the same launch as tiles of their
//     own.  Partial sums go to a (splits, P) array.
//  4. train_reduce_kernel: sums the partials over the splits in index order,
//     applies the log_prior chain and assembles the loss in double.
// No float atomics anywhere: every sum has a fixed order, so the same
// inputs give the same bits on every call.
//
// Two numeric modes, a template parameter BF16 of the four kernels that
// compute products, chosen by the `bf16` argument of the entry point (the
// model's compute_dtype; the TPU kernel's bf16_matmuls, pallas_train.py
// _make_dots).  float32: every value float32.  bfloat16: both operands of
// every product are rounded to the nearest bfloat16 and the sums stay
// float32; the pack kernel rounds the weights, the FMA slabs of
// tile_fma.cuh round each activation or activation gradient as they read
// it, and the weight-gradient tiles round dy and the layer's input.  The
// stored activations, the ReLU gates, the softmax stages, the HMM terms,
// the loss sums and the bias gradients (sums of the unrounded dy) stay
// float32, as in the TPU kernel, and train_reduce_kernel has no product.
// A product of two bfloat16 values is exact in float32, so the mode
// differs from its plain version (ops/nn.py::bf16_matmul) only in the
// order of the sums.  The float32 instantiations compile to the code they
// had before the mode existed.
//
// Bound.  About 2.5 GFLOP a step at B=64, T=200 (the forward is about
// 65 kFLOP a token, the backward twice that) against a few MB of inputs
// and weights: bound by operations, fp32 FMA on the CUDA cores against the
// card's 67 TFLOP/s.  The float32 mode's contract is full float32 (the
// loss is held to 1e-5 and the gradients to 1e-4 of their largest entry,
// which TF32's three digits fail), so it does not use the tensor cores.
// The bfloat16 mode runs the same fp32 FMA chains on rounded operands;
// its bound is the card's bf16 tensor-core rate (989 TFLOP/s dense),
// which a later design with bfloat16 operands in shared memory and
// mma.sync / wgmma would reach for.  What the design does about the bound:
// blocks over (sequence, tile) fill the 132 SMs at any batch; the
// activations of a window stay in shared memory across a layer; a thread's
// register tile cuts the shared-memory loads an FMA needs; the weight
// gradients run as a reduction with the whole card behind it rather than
// a thread a pair.  The halos cost (tile + 8) / tile and (tile + 6) / tile
// of the forward's and backward's arithmetic, and the scratch round trip
// about 100 MB of L2 and device-memory traffic a step at B=64, T=200.

#include <cuda_runtime.h>
#include <climits>

#include "tile_fma.cuh"

namespace {

using tilefma::Next;

constexpr int MAX_THREADS = 512;
constexpr int JB = 4;       // time steps per thread in a convolution
constexpr int KMAX = 16;    // regimes a thread keeps in registers
constexpr int HALO_F = 4;   // forward: one step per k=3 convolution
constexpr int HALO_B = 3;   // backward: one step per transposed convolution
constexpr int WG_TILE = 32;     // (o, i) pairs a side of a weight-gradient block
constexpr int WG_SLAB = 32;     // time steps staged at once
constexpr int WG_THREADS = 64;  // 8 x 8 threads of 4 x 4 pairs
constexpr int WG_STRIDE = 36;   // floats a staged step: 16-byte aligned rows
constexpr int NJOBS = 9;
constexpr float LOG2PI = 1.8378770664093453f;

struct Weights {
  const float *ew1, *eb1, *ew2, *eb2, *ew3, *eb3, *logprior, *pw1, *pb1,
      *pw2, *pb2, *emb, *dw1, *db1, *dw2, *db2, *dw3, *db3;
};

struct Dims {
  int B, C, T, U, H1, H2, K, HP, D;
  long long u_sb, u_sc, u_st;   // strides of u: batch, channel, time
};

// Offsets of the 18 gradient arrays in the flat vector (state_dict order).
struct Offsets {
  long long ew1, eb1, ew2, eb2, ew3, eb3, logprior, pw1, pb1, pw2, pb2, emb,
      dw1, db1, dw2, db2, dw3, db3, P;
};

__host__ __device__ inline Offsets offsets(const Dims& d) {
  Offsets o;
  long long p = 0;
  o.ew1 = p; p += (long long)d.H1 * d.C * 3;
  o.eb1 = p; p += d.H1;
  o.ew2 = p; p += (long long)d.H2 * d.H1 * 3;
  o.eb2 = p; p += d.H2;
  o.ew3 = p; p += (long long)d.K * d.H2;
  o.eb3 = p; p += d.K;
  o.logprior = p; p += d.K;
  o.pw1 = p; p += (long long)d.HP * d.U;
  o.pb1 = p; p += d.HP;
  o.pw2 = p; p += (long long)d.K * d.K * d.HP;
  o.pb2 = p; p += (long long)d.K * d.K;
  o.emb = p; p += (long long)d.K * d.D;
  o.dw1 = p; p += (long long)d.D * d.D * 3;
  o.db1 = p; p += d.D;
  o.dw2 = p; p += (long long)d.D * d.D * 3;
  o.db2 = p; p += d.D;
  o.dw3 = p; p += (long long)2 * d.C * d.D;
  o.db3 = p; p += 2 * d.C;
  o.P = p;
  return o;
}

__host__ __device__ inline int maxi(int a, int b) { return a > b ? a : b; }
// Rows of a ping-pong buffer: the widest layer, (mu, logvar) among them.
// The two buffers are neighbours, and the prior's hidden layer (HP rows,
// on the tile's own steps) lies across both.
__host__ __device__ inline int widest(const Dims& d) {
  return maxi(maxi(maxi(d.D, d.H1), maxi(d.H2, (d.HP + 1) / 2)), 2 * d.C);
}

// First float of each layer in the packed weights (tile_fma.cuh's order):
// the forward's layers, the codebook as the transposed layer e = E^T q,
// then the transposed layers of the backward (T) and the codebook as the
// layer E de.
struct Packed {
  long long ew1, ew2, ew3, embT, dw1, dw2, dw3, pw1, pw2, dw3T, dw2T, dw1T,
      emb, ew3T, ew2T, pw2T, total;
};

__host__ __device__ inline Packed packed(const Dims& d) {
  using tilefma::packed_floats;
  const int KK = d.K * d.K;
  Packed p;
  long long at = 0;
  p.ew1 = at; at += packed_floats(d.H1, d.C, 3);
  p.ew2 = at; at += packed_floats(d.H2, d.H1, 3);
  p.ew3 = at; at += packed_floats(d.K, d.H2, 1);
  p.embT = at; at += packed_floats(d.D, d.K, 1);
  p.dw1 = at; at += packed_floats(d.D, d.D, 3);
  p.dw2 = at; at += packed_floats(d.D, d.D, 3);
  p.dw3 = at; at += packed_floats(2 * d.C, d.D, 1);
  p.pw1 = at; at += packed_floats(d.HP, d.U, 1);
  p.pw2 = at; at += packed_floats(KK, d.HP, 1);
  p.dw3T = at; at += packed_floats(d.D, 2 * d.C, 1);
  p.dw2T = at; at += packed_floats(d.D, d.D, 3);
  p.dw1T = at; at += packed_floats(d.D, d.D, 3);
  p.emb = at; at += packed_floats(d.K, d.D, 1);
  p.ew3T = at; at += packed_floats(d.H2, d.K, 1);
  p.ew2T = at; at += packed_floats(d.H1, d.H2, 3);
  p.pw2T = at; at += packed_floats(d.HP, KK, 1);
  p.total = at;
  return p;
}

constexpr int NPACK = 16;
struct PackJobs {
  tilefma::PackJob j[NPACK];
};

template <bool BF16>
__global__ void __launch_bounds__(256) train_pack_kernel(PackJobs jobs,
                                                   float* __restrict__ dst) {
  tilefma::pack_weights<BF16>(jobs.j, NPACK, dst);
}

// First row of each array in one sequence's scratch, rows of T floats:
// what the forward leaves (x masked at valid_to, u, the activations,
// q, log q, log_A rows (i*K+j), d(mu, logvar)), then the gradients.
struct Rows {
  int xm, uu, h1, hp, h2, q, lq, la, e, hd1, hd2, dout, dhd2, dhd1, de, dl,
      dap, dh2, dhp, dh1, total;
};

__host__ __device__ inline Rows rows(const Dims& d) {
  Rows r;
  int p = 0;
  const int KK = d.K * d.K;
  r.xm = p; p += d.C;
  r.uu = p; p += d.U;
  r.h1 = p; p += d.H1;
  r.hp = p; p += d.HP;
  r.h2 = p; p += d.H2;
  r.q = p; p += d.K;
  r.lq = p; p += d.K;
  r.la = p; p += KK;
  r.e = p; p += d.D;
  r.hd1 = p; p += d.D;
  r.hd2 = p; p += d.D;
  r.dout = p; p += 2 * d.C;
  r.dhd2 = p; p += d.D;
  r.dhd1 = p; p += d.D;
  r.de = p; p += d.D;
  r.dl = p; p += d.K;
  r.dap = p; p += KK;
  r.dh2 = p; p += d.H2;
  r.dhp = p; p += d.HP;
  r.dh1 = p; p += d.H1;
  r.total = p;
  return r;
}

__host__ __device__ inline int row_stride(int tile, int halo) {
  // the window plus room for over-reads, a multiple of 4 (16-byte rows)
  return (tile + 2 * halo + JB + 3) & ~3;
}

// Threads of a block: the (4 output channels, JB steps) tiles of the
// widest layer over the widest convolution's range, spread evenly over
// the fewest rounds of at most MAX_THREADS threads, so that no round of
// such a convolution runs on a part of the block; four warps at least.
inline int block_threads(int tile, int G) {
  const int items = (G + 3) / 4 * (tile / JB + 2);
  const int rounds = (items + MAX_THREADS - 1) / MAX_THREADS;
  const int t = ((items + rounds - 1) / rounds + 31) / 32 * 32;
  return t < 128 ? 128 : t;
}

inline size_t smem_fwd(const Dims& d, int tile) {
  return sizeof(float) * (2 * tilefma::WBUF + tilefma::ROW_PAD +
                          (size_t)row_stride(tile, HALO_F) *
                          (d.C + d.U + 2 * widest(d) + 2 * d.K + d.K * d.K));
}

inline size_t smem_bwd(const Dims& d, int tile) {
  return sizeof(float) * (2 * tilefma::WBUF + tilefma::ROW_PAD +
                          (size_t)row_stride(tile, HALO_B) *
                          (2 * widest(d) + 2 * d.C + 4 * d.K + 2 * d.K * d.K));
}

// dst[r][j] = src[r][p0 + j] for j in [0, W), zero outside [0, limit);
// src rows are T floats apart.
__device__ __forceinline__ void load_rows(float* dst, int WS,
                                          const float* __restrict__ src,
                                          int nrows, int p0, int W, int T,
                                          int limit) {
  for (int idx = threadIdx.x; idx < nrows * W; idx += blockDim.x) {
    const int r = idx / W, j = idx - r * W;
    const int p = p0 + j;
    dst[r * WS + j] = (p >= 0 && p < limit) ? src[(size_t)r * T + p] : 0.f;
  }
}

// dst[r][t0 + jj] = src[r][off + jj] for jj in [0, n).
__device__ __forceinline__ void store_rows(const float* src, int WS, int off,
                                           float* __restrict__ dst, int nrows,
                                           int t0, int n, int T) {
  for (int idx = threadIdx.x; idx < nrows * n; idx += blockDim.x) {
    const int r = idx / n, jj = idx - r * n;
    dst[(size_t)r * T + t0 + jj] = src[r * WS + off + jj];
  }
}

// The block's sum of one double a thread, in a fixed order: each warp's
// lane 0 adds its 32 values, thread 0 the warps' sums.  red holds
// MAX_THREADS doubles.  Returns the sum on thread 0.
__device__ __forceinline__ double block_sum(double v, double* red) {
  __syncthreads();
  red[threadIdx.x] = v;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    double s = 0.0;
    const int end = min((int)threadIdx.x + 32, (int)blockDim.x);
    for (int i = threadIdx.x; i < end; ++i) s += red[i];
    red[threadIdx.x] = s;
  }
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int i = 0; i < (int)blockDim.x; i += 32) s += red[i];
  return s;
}

// valid_to = min(max(lengths), T), by every block for itself.
__device__ __forceinline__ int valid_to(const int* __restrict__ lengths, int B,
                                        int T, int* slot) {
  if (threadIdx.x == 0) *slot = 0;
  __syncthreads();
  int m = 0;
  for (int i = threadIdx.x; i < B; i += blockDim.x) m = max(m, lengths[i]);
  if (m > 0) atomicMax(slot, m);
  __syncthreads();
  return min(*slot, T);
}

// 1 / max(sum_b clamp(lengths[b], 0, T) * C, 1), as the reduce kernel
// computes the loss's denominator.
__device__ __forceinline__ float recon_scale(const int* __restrict__ lengths,
                                             int B, int T, int C) {
  float msum = 0.f;
  for (int i = 0; i < B; ++i) {
    const int li = lengths[i];
    msum += (float)(li < 0 ? 0 : (li > T ? T : li));
  }
  return 1.0f / fmaxf(msum * (float)C, 1.0f);
}

// Two blocks an SM: at most 64 registers a thread.
template <bool BF16>
__global__ void __launch_bounds__(MAX_THREADS, 2) train_forward_kernel(
    const float* __restrict__ x, const float* __restrict__ u,
    const int* __restrict__ lengths, Weights Wt, const float* __restrict__ wp,
    Dims d, int tile, int tiles, float* __restrict__ scratch,
    double* __restrict__ loss_partials) {
  extern __shared__ __align__(16) float smem[];
  __shared__ double red[MAX_THREADS];
  __shared__ int vt_s;
  __shared__ float s_r_s;

  const int T = d.T, C = d.C, K = d.K, KK = d.K * d.K;
  const int G = widest(d);
  const int WS = row_stride(tile, HALO_F);
  tilefma::Pipe pipe{smem, 0, false};
  float* xs = tilefma::first_row(smem + 2 * tilefma::WBUF);   // C rows
  float* us = xs + C * WS;                // U rows
  float* bufA = us + d.U * WS;            // G rows
  float* bufB = bufA + G * WS;            // G rows
  float* qs = bufB + G * WS;              // K rows
  float* lqs = qs + K * WS;               // K rows
  float* las = lqs + K * WS;              // K*K rows

  const int b = blockIdx.x / tiles;
  const int t0 = (blockIdx.x - b * tiles) * tile;
  const int n = min(tile, T - t0);
  const int W = n + 2 * HALO_F;
  const int p0 = t0 - HALO_F;
  const Rows R = rows(d);
  const Packed at = packed(d);
  float* S = scratch + (size_t)b * R.total * T;
  const float* xb = x + (size_t)b * C * T;
  const float* ub = u + (size_t)b * d.u_sb;
  const int L = lengths[b];
  const int vt = valid_to(lengths, d.B, T, &vt_s);
  if (threadIdx.x == 0) s_r_s = recon_scale(lengths, d.B, T, C);

  // x on the window, zero outside [0, T) and past valid_to; u on it
  load_rows(xs, WS, xb, C, p0, W, T, vt);
  for (int idx = threadIdx.x; idx < d.U * W; idx += blockDim.x) {
    const int c = idx / W, j = idx - c * W;
    const int p = p0 + j;
    us[c * WS + j] = (p >= 0 && p < T) ? ub[c * d.u_sc + p * d.u_st] : 0.f;
  }
  __syncthreads();
  const float s_r = s_r_s;
  store_rows(xs, WS, HALO_F, S + (size_t)R.xm * T, C, t0, n, T);
  store_rows(us, WS, HALO_F, S + (size_t)R.uu * T, d.U, t0, n, T);
  // h1 = relu(conv1(x)), masked at valid_to
  tilefma::layer<3, 4, JB, BF16>(wp + at.ew1, d.H1, C, xs, bufA, WS, 1, W - 1,
                                 pipe, Next{wp + at.ew2, d.H2, d.H1, 3});
  tilefma::finish<true>(bufA, d.H1, WS, 1, W - 1, Wt.eb1, true, p0, T, vt,
                        nullptr, S + (size_t)R.h1 * T, t0, n);
  // h2 = relu(conv2(h1)), not masked
  tilefma::layer<3, 4, JB, BF16>(wp + at.ew2, d.H2, d.H1, bufA, bufB, WS, 2,
                                 W - 2, pipe, Next{wp + at.ew3, K, d.H2, 1});
  tilefma::finish<true>(bufB, d.H2, WS, 2, W - 2, Wt.eb2, false, p0, T, vt,
                        nullptr, S + (size_t)R.h2 * T, t0, n);
  // logits, a (step, regime) a thread; log q and q per step
  tilefma::layer<1, 1, 1, BF16>(wp + at.ew3, K, d.H2, bufB, qs, WS, 2, W - 2,
                                pipe, Next{wp + at.embT, d.D, K, 1});
  for (int j = 2 + threadIdx.x; j < W - 2; j += blockDim.x) {
    float lg[KMAX];
    float m = -INFINITY;
    for (int k = 0; k < K; ++k) {
      lg[k] = qs[k * WS + j] + __ldg(Wt.eb3 + k);
      m = fmaxf(m, lg[k]);
    }
    float z = 0.f;
    for (int k = 0; k < K; ++k) z += expf(lg[k] - m);
    const float lse = logf(z) + m;
    for (int k = 0; k < K; ++k) {
      const float l = lg[k] - lse;
      lqs[k * WS + j] = l;
      qs[k * WS + j] = expf(l);
    }
  }
  __syncthreads();
  store_rows(qs, WS, HALO_F, S + (size_t)R.q * T, K, t0, n, T);
  store_rows(lqs, WS, HALO_F, S + (size_t)R.lq * T, K, t0, n, T);
  // e = E^T q, masked at valid_to
  tilefma::layer<1, 4, JB, BF16>(wp + at.embT, d.D, K, qs, bufA, WS, 2, W - 2,
                                 pipe, Next{wp + at.dw1, d.D, d.D, 3});
  tilefma::finish<false>(bufA, d.D, WS, 2, W - 2, nullptr, true, p0, T, vt,
                         nullptr, S + (size_t)R.e * T, t0, n);
  // hd1 = relu(dconv1(e)), masked; hd2 = relu(dconv2(hd1)), not masked
  tilefma::layer<3, 4, JB, BF16>(wp + at.dw1, d.D, d.D, bufA, bufB, WS, 3,
                                 W - 3, pipe, Next{wp + at.dw2, d.D, d.D, 3});
  tilefma::finish<true>(bufB, d.D, WS, 3, W - 3, Wt.db1, true, p0, T, vt,
                        nullptr, S + (size_t)R.hd1 * T, t0, n);
  tilefma::layer<3, 4, JB, BF16>(wp + at.dw2, d.D, d.D, bufB, bufA, WS, HALO_F,
                                 W - HALO_F, pipe,
                                 Next{wp + at.dw3, 2 * C, d.D, 1});
  tilefma::finish<true>(bufA, d.D, WS, HALO_F, W - HALO_F, Wt.db2, false, p0,
                        T, vt, nullptr, S + (size_t)R.hd2 * T, t0, n);
  // (mu, logvar) on the tile, the Gaussian NLL and its gradient
  tilefma::layer<1, 4, 1, BF16>(wp + at.dw3, 2 * C, d.D, bufA, bufB, WS, HALO_F,
                                W - HALO_F, pipe,
                                Next{wp + at.pw1, d.HP, d.U, 1});
  double p_nll = 0.0;
  float* dout = S + (size_t)R.dout * T;
  for (int idx = threadIdx.x; idx < C * n; idx += blockDim.x) {
    const int c = idx / n, jj = idx - c * n;
    const int t = t0 + jj;
    const float mu = bufB[c * WS + HALO_F + jj] + __ldg(Wt.db3 + c);
    const float lv = bufB[(C + c) * WS + HALO_F + jj] + __ldg(Wt.db3 + C + c);
    const float ev = expf(lv);
    const float var = fmaxf(ev, 1e-8f);
    const float diff = mu - xb[(size_t)c * T + t];
    const float r = diff * diff / var;
    const float mf = t < L ? 1.f : 0.f;
    p_nll += 0.5f * (LOG2PI + logf(var) + r) * mf;
    dout[(size_t)c * T + t] = s_r * mf * diff / var;
    dout[(size_t)(C + c) * T + t] =
        ev > 1e-8f ? s_r * mf * 0.5f * (1.f - r) : 0.f;
  }
  __syncthreads();
  // the prior on the tile: hp = relu(fc1(u)) across both buffers,
  // log_A = log_softmax(fc2(hp))
  tilefma::layer<1, 4, JB, BF16>(wp + at.pw1, d.HP, d.U, us, bufA, WS, HALO_F,
                                 W - HALO_F, pipe,
                                 Next{wp + at.pw2, KK, d.HP, 1});
  tilefma::finish<true>(bufA, d.HP, WS, HALO_F, W - HALO_F, Wt.pb1, false, p0,
                        T, vt, nullptr, S + (size_t)R.hp * T, t0, n);
  tilefma::layer<1, 4, JB, BF16>(wp + at.pw2, KK, d.HP, bufA, las, WS, HALO_F,
                                 W - HALO_F, pipe, tilefma::no_next());
  for (int idx = threadIdx.x; idx < K * n; idx += blockDim.x) {
    const int i = idx / n, j = HALO_F + idx - i * n;
    float v[KMAX];
    float m = -INFINITY;
    for (int jj = 0; jj < K; ++jj) {
      v[jj] = las[(i * K + jj) * WS + j] + __ldg(Wt.pb2 + i * K + jj);
      m = fmaxf(m, v[jj]);
    }
    float z = 0.f;
    for (int jj = 0; jj < K; ++jj) z += expf(v[jj] - m);
    const float lse = logf(z) + m;
    for (int jj = 0; jj < K; ++jj) las[(i * K + jj) * WS + j] = v[jj] - lse;
  }
  __syncthreads();
  store_rows(las, WS, HALO_F, S + (size_t)R.la * T, KK, t0, n, T);
  const double s = block_sum(p_nll, red);
  if (threadIdx.x == 0) loss_partials[3 * (size_t)blockIdx.x] = s;
}

// Two blocks an SM: at most 64 registers a thread.
template <bool BF16>
__global__ void __launch_bounds__(MAX_THREADS, 2) train_backward_kernel(
    const int* __restrict__ lengths, Weights Wt, const float* __restrict__ wp,
    Dims d, float beta, int tile, int tiles, float* __restrict__ scratch,
    double* __restrict__ loss_partials) {
  extern __shared__ __align__(16) float smem[];
  __shared__ double red[MAX_THREADS];
  __shared__ float logpi_s[KMAX];
  __shared__ int vt_s;

  const int T = d.T, C = d.C, K = d.K, KK = d.K * d.K;
  const int G = widest(d);
  const int WS = row_stride(tile, HALO_B);
  tilefma::Pipe pipe{smem, 0, false};
  float* bufA = tilefma::first_row(smem + 2 * tilefma::WBUF);  // G rows
  float* bufB = bufA + G * WS;             // G rows
  float* douts = bufB + G * WS;            // 2C rows
  float* qs = douts + 2 * C * WS;          // K rows
  float* lqs = qs + K * WS;                // K rows
  float* gds = lqs + K * WS;               // K rows: E de
  float* dls = gds + K * WS;               // K rows: d logits
  float* las = dls + K * WS;               // K*K rows
  float* daps = las + KK * WS;             // K*K rows: d transition logits

  const int b = blockIdx.x / tiles;
  const int t0 = (blockIdx.x - b * tiles) * tile;
  const int n = min(tile, T - t0);
  const int W = n + 2 * HALO_B;
  const int p0 = t0 - HALO_B;
  const Rows R = rows(d);
  const Packed at = packed(d);
  float* S = scratch + (size_t)b * R.total * T;
  const int L = lengths[b];
  const int vt = valid_to(lengths, d.B, T, &vt_s);
  if (threadIdx.x == 0) {
    float m = -INFINITY;
    for (int k = 0; k < K; ++k) m = fmaxf(m, Wt.logprior[k]);
    float z = 0.f;
    for (int k = 0; k < K; ++k) z += expf(Wt.logprior[k] - m);
    const float lse = logf(z) + m;
    for (int k = 0; k < K; ++k) logpi_s[k] = Wt.logprior[k] - lse;
  }
  const float s_p = -beta / (float)d.B, s_h = beta / (float)d.B;

  load_rows(douts, WS, S + (size_t)R.dout * T, 2 * C, p0, W, T, T);
  load_rows(qs, WS, S + (size_t)R.q * T, K, p0, W, T, T);
  load_rows(lqs, WS, S + (size_t)R.lq * T, K, p0, W, T, T);
  load_rows(las, WS, S + (size_t)R.la * T, KK, p0, W, T, T);
  __syncthreads();
  // dhd2 = W3^T d(mu, logvar), gated by hd2's ReLU
  tilefma::layer<1, 4, JB, BF16>(wp + at.dw3T, d.D, 2 * C, douts, bufA, WS, 0,
                                 W, pipe, Next{wp + at.dw2T, d.D, d.D, 3});
  tilefma::finish<false>(bufA, d.D, WS, 0, W, nullptr, true, p0, T, T,
                         S + (size_t)R.hd2 * T, S + (size_t)R.dhd2 * T, t0, n);
  // dhd1, gated by hd1 (zero past valid_to)
  tilefma::layer<3, 4, JB, BF16>(wp + at.dw2T, d.D, d.D, bufA, bufB, WS, 1,
                                 W - 1, pipe, Next{wp + at.dw1T, d.D, d.D, 3});
  tilefma::finish<false>(bufB, d.D, WS, 1, W - 1, nullptr, true, p0, T, T,
                         S + (size_t)R.hd1 * T, S + (size_t)R.dhd1 * T, t0, n);
  // de, masked at valid_to
  tilefma::layer<3, 4, JB, BF16>(wp + at.dw1T, d.D, d.D, bufB, bufA, WS, 2,
                                 W - 2, pipe, Next{wp + at.emb, K, d.D, 1});
  tilefma::finish<false>(bufA, d.D, WS, 2, W - 2, nullptr, true, p0, T, vt,
                         nullptr, S + (size_t)R.de * T, t0, n);
  // E de, a (step, regime) a thread
  tilefma::layer<1, 1, 1, BF16>(wp + at.emb, K, d.D, bufA, gds, WS, 2, W - 2,
                                pipe, Next{wp + at.ew3T, d.H2, K, 1});
  // the prior, entropy and decoder terms of dq -> d logits; d transition
  // logits; the loss sums of the prior and the entropy on the tile's steps
  double p_prior = 0.0, p_qlogq = 0.0;
  for (int j = 2 + threadIdx.x; j < W - 2; j += blockDim.x) {
    const int t = p0 + j;
    if (t < 0 || t >= T) {
      for (int k = 0; k < K; ++k) dls[k * WS + j] = 0.f;
      for (int r = 0; r < KK; ++r) daps[r * WS + j] = 0.f;
      continue;
    }
    const float mf = t < L ? 1.f : 0.f;
    const float pm = (t >= 1 && t < L) ? 1.f : 0.f;
    const float pmn = (t + 1 < T && t + 1 < L) ? 1.f : 0.f;   // pm[t+1]
    float qt[KMAX], qp[KMAX], g[KMAX];
    for (int k = 0; k < K; ++k) {
      qt[k] = qs[k * WS + j];
      qp[k] = t > 0 ? qs[k * WS + j - 1] : 0.f;
    }
    float trans = 0.f, qlogq = 0.f, init = 0.f;
    for (int i = 0; i < K; ++i)
      for (int jj = 0; jj < K; ++jj)
        trans += qp[i] * qt[jj] * las[(i * K + jj) * WS + j];
    for (int k = 0; k < K; ++k) {
      const float l = lqs[k * WS + j];
      qlogq += qt[k] * l;
      // transitions into t (through q[t]) and out of t (through q[t] as
      // the previous step of t+1)
      float in_t = 0.f, out_t = 0.f;
      for (int i = 0; i < K; ++i) in_t += qp[i] * las[(i * K + k) * WS + j];
      if (t + 1 < T)
        for (int jj = 0; jj < K; ++jj)
          out_t += qs[jj * WS + j + 1] * las[(k * K + jj) * WS + j + 1];
      float gq = gds[k * WS + j] + s_p * pm * in_t + s_p * pmn * out_t +
                 s_h * mf * l;
      if (t == 0) gq += s_p * logpi_s[k];
      g[k] = s_h * mf * qt[k] + gq * qt[k];
    }
    if (t == 0)
      for (int k = 0; k < K; ++k) init += qt[k] * logpi_s[k];
    if (t >= t0 && t < t0 + n) {
      p_prior += init + trans * pm;
      p_qlogq += qlogq * mf;
    }
    float colsum = 0.f;
    for (int k = 0; k < K; ++k) colsum += g[k];
    for (int k = 0; k < K; ++k) dls[k * WS + j] = g[k] - qt[k] * colsum;
    for (int i = 0; i < K; ++i) {
      float rowsum = 0.f;
      for (int jj = 0; jj < K; ++jj) rowsum += s_p * pm * qp[i] * qt[jj];
      for (int jj = 0; jj < K; ++jj) {
        const int at = (i * K + jj) * WS + j;
        daps[at] = s_p * pm * qp[i] * qt[jj] - expf(las[at]) * rowsum;
      }
    }
  }
  __syncthreads();
  store_rows(dls, WS, HALO_B, S + (size_t)R.dl * T, K, t0, n, T);
  store_rows(daps, WS, HALO_B, S + (size_t)R.dap * T, KK, t0, n, T);
  // dh2 = W3^T d logits, gated by h2's ReLU
  tilefma::layer<1, 4, JB, BF16>(wp + at.ew3T, d.H2, K, dls, bufB, WS, 2, W - 2,
                                 pipe, Next{wp + at.ew2T, d.H1, d.H2, 3});
  tilefma::finish<false>(bufB, d.H2, WS, 2, W - 2, nullptr, true, p0, T, T,
                         S + (size_t)R.h2 * T, S + (size_t)R.dh2 * T, t0, n);
  // dh1, gated by h1 (zero past valid_to), on the tile
  tilefma::layer<3, 4, JB, BF16>(wp + at.ew2T, d.H1, d.H2, bufB, bufA, WS,
                                 HALO_B, W - HALO_B, pipe,
                                 Next{wp + at.pw2T, d.HP, KK, 1});
  tilefma::finish<false>(bufA, d.H1, WS, HALO_B, W - HALO_B, nullptr, true, p0,
                         T, T, S + (size_t)R.h1 * T, S + (size_t)R.dh1 * T, t0,
                         n);
  // dhp = W2^T d transition logits, gated by hp's ReLU, on the tile, across
  // both buffers
  tilefma::layer<1, 4, JB, BF16>(wp + at.pw2T, d.HP, KK, daps, bufA, WS, HALO_B,
                                 W - HALO_B, pipe, tilefma::no_next());
  tilefma::finish<false>(bufA, d.HP, WS, HALO_B, W - HALO_B, nullptr, true, p0,
                         T, T, S + (size_t)R.hp * T, S + (size_t)R.dhp * T, t0,
                         n);
  const double s1 = block_sum(p_prior, red);
  const double s2 = block_sum(p_qlogq, red);
  if (threadIdx.x == 0) {
    loss_partials[3 * (size_t)blockIdx.x + 1] = s1;
    loss_partials[3 * (size_t)blockIdx.x + 2] = s2;
  }
}

// One weight gradient: gw[o][i][k] = sum_t dy[o][t] in[i][t - taps/2 + k]
// (in zero outside [0, T)) and, where off_b >= 0, gb[o] = sum_t dy[o][t].
struct Job {
  int dy_row, in_row, O, I, taps, tiles_i, first_tile;
  long long off_w, off_b;
};
struct Jobs {
  Job j[NJOBS];
  int tiles;       // blocks of all jobs
};

inline Jobs make_jobs(const Dims& d) {
  const Rows R = rows(d);
  const Offsets off = offsets(d);
  const int KK = d.K * d.K;
  Jobs jobs;
  const Job list[NJOBS] = {
      {R.dh1, R.xm, d.H1, d.C, 3, 0, 0, off.ew1, off.eb1},
      {R.dh2, R.h1, d.H2, d.H1, 3, 0, 0, off.ew2, off.eb2},
      {R.dl, R.h2, d.K, d.H2, 1, 0, 0, off.ew3, off.eb3},
      {R.dhp, R.uu, d.HP, d.U, 1, 0, 0, off.pw1, off.pb1},
      {R.dap, R.hp, KK, d.HP, 1, 0, 0, off.pw2, off.pb2},
      {R.q, R.de, d.K, d.D, 1, 0, 0, off.emb, -1},
      {R.dhd1, R.e, d.D, d.D, 3, 0, 0, off.dw1, off.db1},
      {R.dhd2, R.hd1, d.D, d.D, 3, 0, 0, off.dw2, off.db2},
      {R.dout, R.hd2, 2 * d.C, d.D, 1, 0, 0, off.dw3, off.db3}};
  int first = 0;
  for (int i = 0; i < NJOBS; ++i) {
    jobs.j[i] = list[i];
    jobs.j[i].tiles_i = (list[i].I + WG_TILE - 1) / WG_TILE;
    jobs.j[i].first_tile = first;
    first += ((list[i].O + WG_TILE - 1) / WG_TILE) * jobs.j[i].tiles_i;
  }
  jobs.tiles = first;
  return jobs;
}

// BF16: dy and the input rounded to bfloat16 where they enter a product;
// the bias sums read dy unrounded.
template <bool BF16>
__device__ __forceinline__ float4 operand4(float4 v) {
  return make_float4(tilefma::operand<BF16>(v.x), tilefma::operand<BF16>(v.y),
                     tilefma::operand<BF16>(v.z), tilefma::operand<BF16>(v.w));
}

template <int TAPS, bool BF16>
__device__ __forceinline__ void weight_grad_tile(
    const Job& job, int o_base, int i_base, const float* __restrict__ scratch,
    int rows_total, int T, int nslab, int u0, int u1,
    float* __restrict__ part, float* dys0, float* ins0) {
  const int lo = threadIdx.x & 7, li = threadIdx.x >> 3;
  const bool active = o_base + 4 * lo < job.O && i_base + 4 * li < job.I;
  float acc[TAPS][4][4];
  float gb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < TAPS; ++k)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[k][a][c] = 0.f;
  // a unit's slabs, staged by step: dys[tt][o], ins[r][i] with r = 0 the
  // step ts - 1; copied asynchronously into the buffer the FMAs do not read
  auto stage = [&](int unit, float* dyb, float* inb) {
    const int b = unit / nslab;
    const int ts = (unit - b * nslab) * WG_SLAB;
    const float* S = scratch + (size_t)b * rows_total * T;
    const float* dy = S + (size_t)(job.dy_row + o_base) * T;
    const float* in = S + (size_t)(job.in_row + i_base) * T;
    for (int idx = threadIdx.x; idx < WG_TILE * WG_SLAB; idx += WG_THREADS) {
      const int o = idx / WG_SLAB, tt = idx - o * WG_SLAB;
      const int t = ts + tt;
      const bool ok = o_base + o < job.O && t < T;
      tilefma::cp_async4_zfill(dyb + tt * WG_STRIDE + o,
                               ok ? dy + (size_t)o * T + t : S, ok);
    }
    for (int idx = threadIdx.x; idx < WG_TILE * (WG_SLAB + 2);
         idx += WG_THREADS) {
      const int i = idx / (WG_SLAB + 2), r = idx - i * (WG_SLAB + 2);
      const int t = ts - 1 + r;
      const bool ok = i_base + i < job.I && t >= 0 && t < T;
      tilefma::cp_async4_zfill(inb + r * WG_STRIDE + i,
                               ok ? in + (size_t)i * T + t : S, ok);
    }
    tilefma::cp_async_commit();
  };
  stage(u0, dys0, ins0);
  for (int unit = u0; unit < u1; ++unit) {
    const bool odd = (unit - u0) & 1;
    const float* dys = odd ? dys0 + WG_SLAB * WG_STRIDE : dys0;
    const float* ins = odd ? ins0 + (WG_SLAB + 2) * WG_STRIDE : ins0;
    if (unit + 1 < u1) {
      stage(unit + 1, odd ? dys0 : dys0 + WG_SLAB * WG_STRIDE,
            odd ? ins0 : ins0 + (WG_SLAB + 2) * WG_STRIDE);
      tilefma::cp_async_wait<1>();
    } else {
      tilefma::cp_async_wait<0>();
    }
    __syncthreads();
    const float* dp = dys + 4 * lo;
    const float* ip = ins + 4 * li;
    if (!active) {
      // a thread wholly outside a narrow layer's (o, i) pairs
    } else if constexpr (TAPS == 3) {
      float4 am = operand4<BF16>(*reinterpret_cast<const float4*>(ip));
      float4 a0 =
          operand4<BF16>(*reinterpret_cast<const float4*>(ip + WG_STRIDE));
#pragma unroll 4
      for (int tt = 0; tt < WG_SLAB; ++tt) {
        const float4 d4 = *reinterpret_cast<const float4*>(dp + tt * WG_STRIDE);
        const float4 ap = operand4<BF16>(
            *reinterpret_cast<const float4*>(ip + (tt + 2) * WG_STRIDE));
        const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
        const float4 r4 = operand4<BF16>(d4);
        const float dr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float v[3][4] = {{am.x, am.y, am.z, am.w},
                               {a0.x, a0.y, a0.z, a0.w},
                               {ap.x, ap.y, ap.z, ap.w}};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          gb[a] += dv[a];
#pragma unroll
          for (int k = 0; k < 3; ++k)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[k][a][c] = fmaf(dr[a], v[k][c], acc[k][a][c]);
        }
        am = a0;
        a0 = ap;
      }
    } else {
#pragma unroll 4
      for (int tt = 0; tt < WG_SLAB; ++tt) {
        const float4 d4 = *reinterpret_cast<const float4*>(dp + tt * WG_STRIDE);
        const float4 a4 = operand4<BF16>(
            *reinterpret_cast<const float4*>(ip + (tt + 1) * WG_STRIDE));
        const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
        const float4 r4 = operand4<BF16>(d4);
        const float dr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float v[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          gb[a] += dv[a];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[0][a][c] = fmaf(dr[a], v[c], acc[0][a][c]);
        }
      }
    }
    __syncthreads();      // before the next copies land in this buffer
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int o = o_base + 4 * lo + a;
    if (o >= job.O) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = i_base + 4 * li + c;
      if (i >= job.I) continue;
#pragma unroll
      for (int k = 0; k < TAPS; ++k)
        part[job.off_w + ((long long)o * job.I + i) * TAPS + k] = acc[k][a][c];
    }
    if (job.off_b >= 0 && i_base == 0 && li == 0) part[job.off_b + o] = gb[a];
  }
}

template <bool BF16>
__global__ void __launch_bounds__(WG_THREADS) train_weight_grad_kernel(
    const float* __restrict__ scratch, Jobs jobs, int rows_total, int T,
    int nslab, int units, int per, float* __restrict__ partials,
    long long P) {
  __shared__ __align__(16) float dys[2 * WG_SLAB * WG_STRIDE];
  __shared__ __align__(16) float ins[2 * (WG_SLAB + 2) * WG_STRIDE];
  int ji = 0;
  while (ji + 1 < NJOBS && (int)blockIdx.x >= jobs.j[ji + 1].first_tile) ++ji;
  const Job job = jobs.j[ji];
  const int local = blockIdx.x - job.first_tile;
  const int o_base = (local / job.tiles_i) * WG_TILE;
  const int i_base = (local % job.tiles_i) * WG_TILE;
  const int u0 = blockIdx.y * per;
  const int u1 = min(units, u0 + per);
  float* part = partials + (size_t)blockIdx.y * P;
  if (job.taps == 3)
    weight_grad_tile<3, BF16>(job, o_base, i_base, scratch, rows_total, T,
                              nslab, u0, u1, part, dys, ins);
  else
    weight_grad_tile<1, BF16>(job, o_base, i_base, scratch, rows_total, T,
                              nslab, u0, u1, part, dys, ins);
}

// A block's sum of one double a thread, a fixed tree over 256 threads.
__device__ __forceinline__ double tree_sum_256(double v, double* red) {
  __syncthreads();
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = 128; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  return red[0];
}

// grads[p] = sum_s partials[s][p] in index order.  The last block sums the
// blocks' three loss sums and q at t = 0 (each thread a fixed stride, then
// a fixed tree), assembles the loss and applies the log_prior chain.
__global__ void __launch_bounds__(256) train_reduce_kernel(
    const float* __restrict__ partials, int splits,
    const double* __restrict__ loss_partials, int blocks,
    const float* __restrict__ scratch, const int* __restrict__ lengths,
    const float* __restrict__ logprior, Dims d, float beta,
    float* __restrict__ grads, float* __restrict__ loss) {
  __shared__ double red[256];
  const Offsets off = offsets(d);
  if (blockIdx.x == gridDim.x - 1) {
    double s[3];
    for (int r = 0; r < 3; ++r) {
      double v = 0.0;
      for (int i = threadIdx.x; i < blocks; i += 256)
        v += loss_partials[3 * (size_t)i + r];
      s[r] = tree_sum_256(v, red);
    }
    // d log_prior = g - softmax(log_prior) * sum(g), g[k] = s_p sum_b q[b][k][0]
    const Rows R = rows(d);
    const float s_p = -beta / (float)d.B;
    float g[KMAX];
    for (int k = 0; k < d.K; ++k) {
      double v = 0.0;
      for (int b = threadIdx.x; b < d.B; b += 256)
        v += (double)(s_p * scratch[((size_t)b * R.total + R.q + k) * d.T]);
      g[k] = (float)tree_sum_256(v, red);
    }
    if (threadIdx.x != 0) return;
    float msum = 0.f;
    for (int b = 0; b < d.B; ++b) {
      const int li = lengths[b];
      msum += (float)(li < 0 ? 0 : (li > d.T ? d.T : li));
    }
    const double denom = fmax((double)msum * d.C, 1.0);
    // the prior and entropy sums nearly cancel (each is about T log K a
    // sequence), so they are combined in double before the one rounding
    *loss = (float)(s[0] / denom + (double)beta * (s[2] - s[1]) / d.B);
    float gsum = 0.f, m = -INFINITY, z = 0.f;
    for (int k = 0; k < d.K; ++k) {
      gsum += g[k];
      m = fmaxf(m, logprior[k]);
    }
    for (int k = 0; k < d.K; ++k) z += expf(logprior[k] - m);
    for (int k = 0; k < d.K; ++k)
      grads[off.logprior + k] = g[k] - expf(logprior[k] - m) / z * gsum;
    return;
  }
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= off.P || (p >= off.logprior && p < off.logprior + d.K)) return;
  float a = 0.f;
  for (int s = 0; s < splits; ++s) a += partials[s * off.P + p];
  grads[p] = a;
}

// The five launches of one call in mode BF16 (the entry point checked the
// arguments).
template <bool BF16>
int enqueue(const float* x, const float* u, const int* lengths,
            const Weights& W, const Dims& d, float* packed_weights,
            float* scratch, float* partials, double* loss_partials,
            float* grads, float* loss, int tile, int splits, float beta,
            cudaStream_t s) {
  const int G = widest(d);
  const int tiles = (d.T + tile - 1) / tile;
  const long long blocks = (long long)tiles * d.B;
  const int nslab = (d.T + WG_SLAB - 1) / WG_SLAB;
  const long long units = (long long)d.B * nslab;
  const int per = (int)((units + splits - 1) / splits);
  const int threads = block_threads(tile, G);
  const size_t sf = smem_fwd(d, tile), sb = smem_bwd(d, tile);
  cudaError_t err = cudaFuncSetAttribute(
      train_forward_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sf);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(train_backward_kernel<BF16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sb);
  if (err != cudaSuccess) return (int)err;
  const Packed at = packed(d);
  const int C = d.C, D = d.D, K = d.K, KK = d.K * d.K;
  const PackJobs pj{{{W.ew1, d.H1, C, 3, 0, at.ew1},
                     {W.ew2, d.H2, d.H1, 3, 0, at.ew2},
                     {W.ew3, K, d.H2, 1, 0, at.ew3},
                     {W.emb, D, K, 1, 1, at.embT},
                     {W.dw1, D, D, 3, 0, at.dw1},
                     {W.dw2, D, D, 3, 0, at.dw2},
                     {W.dw3, 2 * C, D, 1, 0, at.dw3},
                     {W.pw1, d.HP, d.U, 1, 0, at.pw1},
                     {W.pw2, KK, d.HP, 1, 0, at.pw2},
                     {W.dw3, D, 2 * C, 1, 1, at.dw3T},
                     {W.dw2, D, D, 3, 1, at.dw2T},
                     {W.dw1, D, D, 3, 1, at.dw1T},
                     {W.emb, K, D, 1, 0, at.emb},
                     {W.ew3, d.H2, K, 1, 1, at.ew3T},
                     {W.ew2, d.H1, d.H2, 3, 1, at.ew2T},
                     {W.pw2, d.HP, KK, 1, 1, at.pw2T}}};
  train_pack_kernel<BF16><<<(unsigned)((at.total + 255) / 256), 256, 0, s>>>(
      pj, packed_weights);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  train_forward_kernel<BF16><<<(unsigned)blocks, threads, sf, s>>>(
      x, u, lengths, W, packed_weights, d, tile, tiles, scratch,
      loss_partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  train_backward_kernel<BF16><<<(unsigned)blocks, threads, sb, s>>>(
      lengths, W, packed_weights, d, beta, tile, tiles, scratch,
      loss_partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Jobs jobs = make_jobs(d);
  const long long P = offsets(d).P;
  train_weight_grad_kernel<BF16><<<dim3((unsigned)jobs.tiles,
                                        (unsigned)splits),
                                   WG_THREADS, 0, s>>>(
      scratch, jobs, rows(d).total, d.T, nslab, (int)units, per, partials,
      P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  train_reduce_kernel<<<(unsigned)((P + 255) / 256 + 1), 256, 0, s>>>(
      partials, splits, loss_partials, (int)blocks, scratch, lengths,
      W.logprior, d, beta, grads, loss);
  return (int)cudaGetLastError();
}

}  // namespace

// what = 0: floats of the flat gradient vector; 1: scratch rows of T a
// sequence; 2, 3: dynamic shared memory bytes of a forward and a backward
// block at tile width `tile`; 4: (o, i) tiles of the weight-gradient grid;
// 5: floats of the packed weights.
extern "C" long long vqhmm_fused_train_sizes(int B, int C, int T, int U,
                                             int H1, int H2, int K, int HP,
                                             int D, int tile, int what) {
  Dims d{B, C, T, U, H1, H2, K, HP, D, 0, 0, 0};
  switch (what) {
    case 0: return offsets(d).P;
    case 1: return rows(d).total;
    case 2: return (long long)smem_fwd(d, tile);
    case 3: return (long long)smem_bwd(d, tile);
    case 4: return make_jobs(d).tiles;
    default: return packed(d).total;
  }
}

// packed_weights: vqhmm_fused_train_sizes(.., 5) floats; scratch: B * rows
// * T floats; partials: splits * P floats; loss_partials: 3 * B *
// ceil(T / tile) doubles.  bf16: 0 for the float32 mode, 1 for the
// bfloat16 mode (products of bfloat16-rounded operands).
extern "C" int vqhmm_fused_train(
    const float* x, const float* u, long long u_sb, long long u_sc,
    long long u_st, const int* lengths, const float* ew1, const float* eb1,
    const float* ew2, const float* eb2, const float* ew3, const float* eb3,
    const float* logprior, const float* pw1, const float* pb1,
    const float* pw2, const float* pb2, const float* emb, const float* dw1,
    const float* db1, const float* dw2, const float* db2, const float* dw3,
    const float* db3, float* packed_weights, float* scratch, float* partials,
    double* loss_partials, float* grads, float* loss, int B, int C, int T,
    int U, int H1, int H2, int K, int HP, int D, int tile, int splits,
    int bf16, float beta, void* stream) {
  Weights W{ew1, eb1, ew2, eb2, ew3, eb3, logprior, pw1, pb1, pw2, pb2,
            emb, dw1, db1, dw2, db2, dw3, db3};
  Dims d{B, C, T, U, H1, H2, K, HP, D, u_sb, u_sc, u_st};
  const int G = widest(d);
  if (B <= 0 || T <= 0 || K <= 0 || K > KMAX || splits <= 0 ||
      splits > 65535 || (tile != 16 && tile != 32 && tile != 64) ||
      (bf16 != 0 && bf16 != 1) ||
      3 * tilefma::round4(maxi(G, HP)) > tilefma::WBUF)
    return (int)cudaErrorInvalidValue;
  const int tiles = (T + tile - 1) / tile;
  const long long blocks = (long long)tiles * B;
  const int nslab = (T + WG_SLAB - 1) / WG_SLAB;
  const long long units = (long long)B * nslab;
  if (blocks > INT_MAX || units > INT_MAX) return (int)cudaErrorInvalidValue;
  const int per = (int)((units + splits - 1) / splits);
  if ((units + per - 1) / per != splits) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? enqueue<true>(x, u, lengths, W, d, packed_weights, scratch,
                              partials, loss_partials, grads, loss, tile,
                              splits, beta, s)
              : enqueue<false>(x, u, lengths, W, d, packed_weights, scratch,
                               partials, loss_partials, grads, loss, tile,
                               splits, beta, s);
}
