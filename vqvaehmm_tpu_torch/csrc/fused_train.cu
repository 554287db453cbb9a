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
//  * Global normalisation (the TPU kernel's axis_name mode, for data
//    parallelism): where the caller passes valid_to, the mask total sum(mf)
//    and B of the whole global batch (Dims::vt_g, msum_g, B_g), they stand
//    in for this batch's own, so that the ranks' losses and gradients sum
//    to the global batch's.  -1 in each means "this batch's own" and leaves
//    the arithmetic as it is without them.
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
// Two numeric modes, chosen by the `bf16` argument of the entry point (the
// model's compute_dtype; the TPU kernel's bf16_matmuls, pallas_train.py
// _make_dots).
//  * float32: every value float32; the kernels above, whose products are
//    fp32 FMA chains on the CUDA cores (tile_fma.cuh).
//  * bfloat16: both operands of every product are the nearest bfloat16
//    and every sum is float32, on the tensor cores: train_pack_bf16_kernel
//    rounds the weights (and the transposed ones) into mma fragment order,
//    train_forward_bf16_kernel and train_backward_bf16_kernel walk the same
//    windows and stages as the float32 kernels with each layer an implicit
//    GEMM of mma.sync.m16n8k16 over bfloat16 operands kept time-major in
//    shared memory (tile_mma.cuh), and train_weight_grad_bf16_kernel
//    reduces each weight gradient over time with the same tiles and splits
//    as the float32 kernel, dy and the input rounded as they are staged.
//    The stored activations, the ReLU gates, the softmax stages, the HMM
//    terms, the loss sums and the bias gradients (sums of the unrounded
//    dy) stay float32, as in the TPU kernel; train_reduce_kernel, which has
//    no product, serves both modes.  A product of two bfloat16 values is
//    exact in float32, so the mode differs from its plain version
//    (ops/nn.py::bf16_matmul) only in the order of the float32 sums.
//
// Bound.  About 2.5 GFLOP a step at B=64, T=200 (the forward is about
// 65 kFLOP a token, the backward twice that) against a few MB of inputs
// and weights: bound by operations.  The float32 mode's contract is full
// float32 (the loss is held to 1e-5 and the gradients to 1e-4 of their
// largest entry, which TF32's three digits fail), so it runs on the CUDA
// cores against the card's 67 TFLOP/s.  What its design does about the
// bound: blocks over (sequence, tile) fill the 132 SMs at any batch; the
// activations of a window stay in shared memory across a layer; a thread's
// register tile cuts the shared-memory loads an FMA needs; the weight
// gradients run as a reduction with the whole card behind it rather than
// a thread a pair.  The bfloat16 mode's bound is the card's dense bf16
// tensor-core rate, 989 TFLOP/s: there a warp's mma keeps 16 channels x
// up to 48 steps of sums in registers over a whole layer, the weights
// stream from L2 in fragment order two chunks ahead with no barrier
// inside a layer, and a block's operands are half the bytes of the
// float32 windows.  At the probe shape the scratch round trip, not the
// products, takes most of the bfloat16 forward's time.  The halos cost
// (tile + 8) / tile and (tile + 6) / tile of the forward's and backward's
// arithmetic, and the scratch round trip about 100 MB of L2 and
// device-memory traffic a step at B=64, T=200.

#include <cuda_runtime.h>
#include <climits>

#include "tile_fma.cuh"
#include "tile_mma.cuh"

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
constexpr int WG_TILE_MMA = 64;      // the bfloat16 mode's (o, i) tiles
constexpr int WG_STRIDE = 36;   // floats a staged step: 16-byte aligned rows
constexpr int NJOBS = 9;
constexpr int MMA_THREADS = 256;   // a block of the bfloat16 mode: 8 warps
constexpr float LOG2PI = 1.8378770664093453f;

struct Weights {
  const float *ew1, *eb1, *ew2, *eb2, *ew3, *eb3, *logprior, *pw1, *pb1,
      *pw2, *pb2, *emb, *dw1, *db1, *dw2, *db2, *dw3, *db3;
};

struct Dims {
  int B, C, T, U, H1, H2, K, HP, D;
  long long u_sb, u_sc, u_st;   // strides of u: batch, channel, time
  // the global batch's valid_to, mask total and B, or -1 for this batch's
  int vt_g;
  long long msum_g;
  int B_g;
};

// B of the loss's prior and entropy terms: the global batch's where given.
__host__ __device__ inline int batch_total(const Dims& d) {
  return d.B_g > 0 ? d.B_g : d.B;
}

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

// First value of each layer in the packed weights: the forward's layers,
// the codebook as the transposed layer e = E^T q, then the transposed
// layers of the backward (T) and the codebook as the layer E de.  float32:
// floats in tile_fma.cuh's order; BF16: bfloat16 values in tile_mma.cuh's
// fragment order.
struct Packed {
  long long ew1, ew2, ew3, embT, dw1, dw2, dw3, pw1, pw2, dw3T, dw2T, dw1T,
      emb, ew3T, ew2T, pw2T, total;
};

template <bool BF16>
__host__ __device__ inline Packed packed(const Dims& d) {
  const auto packed_floats = [](int O, int I, int taps) -> long long {
    if constexpr (BF16) return tilemma::packed_elems(O, I, taps);
    return tilefma::packed_floats(O, I, taps);
  };
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
struct MmaPackJobs {
  tilemma::PackJob j[NPACK];
};

__global__ void __launch_bounds__(256) train_pack_kernel(PackJobs jobs,
                                                         float* __restrict__ dst) {
  tilefma::pack_weights(jobs.j, NPACK, dst);
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

// The bfloat16 mode's forward and backward blocks (tile_mma.cuh): bfloat16
// operand buffers of op_rows rows (the window, time-major), then float32
// rows of WS floats for the values a softmax or the NLL reads.
__host__ __device__ inline int op_rows(int tile, int halo) {
  return tile + 2 * halo;
}
// the widest operand of the forward's ping-pong buffers (h1, h2, q, e,
// hd1, hd2, hp) and of the backward's (dhd2, dhd1, de, dh2)
__host__ __device__ inline int fwd_operand(const Dims& d) {
  return maxi(maxi(maxi(d.H1, d.H2), maxi(d.D, d.HP)), d.K);
}
__host__ __device__ inline int bwd_operand(const Dims& d) {
  return maxi(d.D, d.H2);
}
// float32 rows: the forward's logits and log q, then (mu, logvar), then
// log_A, one after another in the same rows; the backward's q, log q,
// log_A and E de
__host__ __device__ inline int fwd_f32_rows(const Dims& d) {
  return maxi(maxi(2 * d.K, 2 * d.C), d.K * d.K);
}

inline size_t smem_fwd_bf16(const Dims& d, int tile) {
  using tilemma::op_stride;
  return 2 * (size_t)op_rows(tile, HALO_F) *
             (2 * op_stride(fwd_operand(d)) + op_stride(d.C) +
              op_stride(d.U)) +
         sizeof(float) * (size_t)row_stride(tile, HALO_F) * fwd_f32_rows(d);
}

inline size_t smem_bwd_bf16(const Dims& d, int tile) {
  using tilemma::op_stride;
  return 2 * (size_t)op_rows(tile, HALO_B) *
             (2 * op_stride(bwd_operand(d)) + op_stride(2 * d.C) +
              op_stride(d.K) + op_stride(d.K * d.K)) +
         sizeof(float) * (size_t)row_stride(tile, HALO_B) *
             (3 * d.K + d.K * d.K);
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

// valid_to = min(max(lengths), T), by every block for itself, or the
// global batch's where given (the same for every thread of the grid).
__device__ __forceinline__ int valid_to(const int* __restrict__ lengths,
                                        const Dims& d, int* slot) {
  const int B = d.B, T = d.T;
  if (d.vt_g >= 0) return min(d.vt_g, T);
  if (threadIdx.x == 0) *slot = 0;
  __syncthreads();
  int m = 0;
  for (int i = threadIdx.x; i < B; i += blockDim.x) m = max(m, lengths[i]);
  if (m > 0) atomicMax(slot, m);
  __syncthreads();
  return min(*slot, T);
}

// sum_b clamp(lengths[b], 0, T), the mask total, or the global batch's
// where given (an integer below 2^24 either way, so exact in float).
__device__ __forceinline__ float mask_total(const int* __restrict__ lengths,
                                            const Dims& d) {
  if (d.msum_g >= 0) return (float)d.msum_g;
  float msum = 0.f;
  for (int i = 0; i < d.B; ++i) {
    const int li = lengths[i];
    msum += (float)(li < 0 ? 0 : (li > d.T ? d.T : li));
  }
  return msum;
}

// 1 / max(mask total * C, 1), as the reduce kernel computes the loss's
// denominator.
__device__ __forceinline__ float recon_scale(const int* __restrict__ lengths,
                                             const Dims& d) {
  return 1.0f / fmaxf(mask_total(lengths, d) * (float)d.C, 1.0f);
}

// The stages between the products, shared by both modes' kernels: each
// takes where its inputs lie and where its outputs go as accessors, so
// that a mode reads and writes its own buffers around the same float32
// arithmetic.

// v[k] = value(k) for k in [0, K), and log sum_k exp(v[k]): the largest
// value out, the exponentials summed in index order.
template <typename Value>
__device__ __forceinline__ float fill_log_sum_exp(float* v, int K,
                                                  Value value) {
  float m = -INFINITY;
  for (int k = 0; k < K; ++k) {
    v[k] = value(k);
    m = fmaxf(m, v[k]);
  }
  float z = 0.f;
  for (int k = 0; k < K; ++k) z += expf(v[k] - m);
  return logf(z) + m;
}

// log_pi = log_softmax(log_prior), by thread 0 into logpi.
__device__ __forceinline__ void log_pi(const float* __restrict__ logprior,
                                       int K, float* logpi) {
  if (threadIdx.x == 0) {
    float m = -INFINITY;
    for (int k = 0; k < K; ++k) m = fmaxf(m, logprior[k]);
    float z = 0.f;
    for (int k = 0; k < K; ++k) z += expf(logprior[k] - m);
    const float lse = logf(z) + m;
    for (int k = 0; k < K; ++k) logpi[k] = logprior[k] - lse;
  }
}

// log q and q at window positions j in [lo, hi) from the step's K logits:
// logit(k, j) reads them, put(k, j, log q, q) takes the results.
template <typename Logit, typename Put>
__device__ __forceinline__ void posterior_softmax(int K, int lo, int hi,
                                                  Logit logit, Put put) {
  for (int j = lo + threadIdx.x; j < hi; j += blockDim.x) {
    float lg[KMAX];
    const float lse =
        fill_log_sum_exp(lg, K, [&](int k) { return logit(k, j); });
    for (int k = 0; k < K; ++k) {
      const float l = lg[k] - lse;
      put(k, j, l, expf(l));
    }
  }
}

// The Gaussian NLL of the block's own steps t0 + jj, jj in [0, n), and its
// gradient to (mu, logvar) into the scratch rows dout (2C rows of T
// floats); mu_lv(c, jj, mu, lv) reads channel c's mean and log variance.
// Returns the thread's share of the NLL sum.
template <typename MuLv>
__device__ __forceinline__ double gaussian_nll(MuLv mu_lv,
                                               const float* __restrict__ xb,
                                               float* __restrict__ dout,
                                               int C, int T, int t0, int n,
                                               int L, float s_r) {
  double p_nll = 0.0;
  for (int idx = threadIdx.x; idx < C * n; idx += blockDim.x) {
    const int c = idx / n, jj = idx - c * n;
    const int t = t0 + jj;
    float mu, lv;
    mu_lv(c, jj, mu, lv);
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
  return p_nll;
}

// log_A = the log-softmax over j of the transition logits of the block's
// own steps jj in [0, n): logit(r, jj) reads logit r = i K + j,
// put(r, jj, v) takes log_A's entry.
template <typename Logit, typename Put>
__device__ __forceinline__ void transition_log_softmax(int K, int n,
                                                       Logit logit, Put put) {
  for (int idx = threadIdx.x; idx < K * n; idx += blockDim.x) {
    const int i = idx / n, jj = idx - i * n;
    float v[KMAX];
    const float lse =
        fill_log_sum_exp(v, K, [&](int k) { return logit(i * K + k, jj); });
    for (int k = 0; k < K; ++k) put(i * K + k, jj, v[k] - lse);
  }
}

// The backward's per-step stage at window position j, time t in [0, T),
// from the window's float32 rows (WS floats apart) of q, log q, log_A and
// E de: the prior, entropy and decoder terms of dq through the softmax to
// the d logits, dl(k, v), and the d transition logits, dap(i K + j, v);
// the step's prior and entropy terms added to p_prior and p_qlogq where it
// is one of the block's own steps.
template <typename DL, typename DAP>
__device__ __forceinline__ void dq_step(
    const float* qs, const float* lqs, const float* las, const float* gds,
    int WS, int j, int t, int T, int K, int L, float s_p, float s_h,
    const float* logpi, bool own, double& p_prior, double& p_qlogq, DL dl,
    DAP dap) {
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
    // transitions into t (through q[t]) and out of t (through q[t] as the
    // previous step of t+1)
    float in_t = 0.f, out_t = 0.f;
    for (int i = 0; i < K; ++i) in_t += qp[i] * las[(i * K + k) * WS + j];
    if (t + 1 < T)
      for (int jj = 0; jj < K; ++jj)
        out_t += qs[jj * WS + j + 1] * las[(k * K + jj) * WS + j + 1];
    float gq = gds[k * WS + j] + s_p * pm * in_t + s_p * pmn * out_t +
               s_h * mf * l;
    if (t == 0) gq += s_p * logpi[k];
    g[k] = s_h * mf * qt[k] + gq * qt[k];
  }
  if (t == 0)
    for (int k = 0; k < K; ++k) init += qt[k] * logpi[k];
  if (own) {
    p_prior += init + trans * pm;
    p_qlogq += qlogq * mf;
  }
  float colsum = 0.f;
  for (int k = 0; k < K; ++k) colsum += g[k];
  for (int k = 0; k < K; ++k) dl(k, g[k] - qt[k] * colsum);
  for (int i = 0; i < K; ++i) {
    float rowsum = 0.f;
    for (int jj = 0; jj < K; ++jj) rowsum += s_p * pm * qp[i] * qt[jj];
    for (int jj = 0; jj < K; ++jj) {
      const int r = i * K + jj;
      dap(r, s_p * pm * qp[i] * qt[jj] - expf(las[r * WS + j]) * rowsum);
    }
  }
}

// Two blocks an SM: at most 64 registers a thread.
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
  const Packed at = packed<false>(d);
  float* S = scratch + (size_t)b * R.total * T;
  const float* xb = x + (size_t)b * C * T;
  const float* ub = u + (size_t)b * d.u_sb;
  const int L = lengths[b];
  const int vt = valid_to(lengths, d, &vt_s);
  if (threadIdx.x == 0) s_r_s = recon_scale(lengths, d);

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
  tilefma::layer<3, 4, JB>(wp + at.ew1, d.H1, C, xs, bufA, WS, 1, W - 1,
                           pipe, Next{wp + at.ew2, d.H2, d.H1, 3});
  tilefma::finish<true>(bufA, d.H1, WS, 1, W - 1, Wt.eb1, true, p0, T, vt,
                        nullptr, S + (size_t)R.h1 * T, t0, n);
  // h2 = relu(conv2(h1)), not masked
  tilefma::layer<3, 4, JB>(wp + at.ew2, d.H2, d.H1, bufA, bufB, WS, 2,
                           W - 2, pipe, Next{wp + at.ew3, K, d.H2, 1});
  tilefma::finish<true>(bufB, d.H2, WS, 2, W - 2, Wt.eb2, false, p0, T, vt,
                        nullptr, S + (size_t)R.h2 * T, t0, n);
  // logits, a (step, regime) a thread; log q and q per step
  tilefma::layer<1, 1, 1>(wp + at.ew3, K, d.H2, bufB, qs, WS, 2, W - 2,
                          pipe, Next{wp + at.embT, d.D, K, 1});
  posterior_softmax(
      K, 2, W - 2,
      [&](int k, int j) { return qs[k * WS + j] + __ldg(Wt.eb3 + k); },
      [&](int k, int j, float l, float q) {
        lqs[k * WS + j] = l;
        qs[k * WS + j] = q;
      });
  __syncthreads();
  store_rows(qs, WS, HALO_F, S + (size_t)R.q * T, K, t0, n, T);
  store_rows(lqs, WS, HALO_F, S + (size_t)R.lq * T, K, t0, n, T);
  // e = E^T q, masked at valid_to
  tilefma::layer<1, 4, JB>(wp + at.embT, d.D, K, qs, bufA, WS, 2, W - 2,
                           pipe, Next{wp + at.dw1, d.D, d.D, 3});
  tilefma::finish<false>(bufA, d.D, WS, 2, W - 2, nullptr, true, p0, T, vt,
                         nullptr, S + (size_t)R.e * T, t0, n);
  // hd1 = relu(dconv1(e)), masked; hd2 = relu(dconv2(hd1)), not masked
  tilefma::layer<3, 4, JB>(wp + at.dw1, d.D, d.D, bufA, bufB, WS, 3,
                           W - 3, pipe, Next{wp + at.dw2, d.D, d.D, 3});
  tilefma::finish<true>(bufB, d.D, WS, 3, W - 3, Wt.db1, true, p0, T, vt,
                        nullptr, S + (size_t)R.hd1 * T, t0, n);
  tilefma::layer<3, 4, JB>(wp + at.dw2, d.D, d.D, bufB, bufA, WS, HALO_F,
                           W - HALO_F, pipe,
                           Next{wp + at.dw3, 2 * C, d.D, 1});
  tilefma::finish<true>(bufA, d.D, WS, HALO_F, W - HALO_F, Wt.db2, false, p0,
                        T, vt, nullptr, S + (size_t)R.hd2 * T, t0, n);
  // (mu, logvar) on the tile, the Gaussian NLL and its gradient
  tilefma::layer<1, 4, 1>(wp + at.dw3, 2 * C, d.D, bufA, bufB, WS, HALO_F,
                          W - HALO_F, pipe,
                          Next{wp + at.pw1, d.HP, d.U, 1});
  const double p_nll = gaussian_nll(
      [&](int c, int jj, float& mu, float& lv) {
        mu = bufB[c * WS + HALO_F + jj] + __ldg(Wt.db3 + c);
        lv = bufB[(C + c) * WS + HALO_F + jj] + __ldg(Wt.db3 + C + c);
      },
      xb, S + (size_t)R.dout * T, C, T, t0, n, L, s_r);
  __syncthreads();
  // the prior on the tile: hp = relu(fc1(u)) across both buffers,
  // log_A = log_softmax(fc2(hp))
  tilefma::layer<1, 4, JB>(wp + at.pw1, d.HP, d.U, us, bufA, WS, HALO_F,
                           W - HALO_F, pipe,
                           Next{wp + at.pw2, KK, d.HP, 1});
  tilefma::finish<true>(bufA, d.HP, WS, HALO_F, W - HALO_F, Wt.pb1, false, p0,
                        T, vt, nullptr, S + (size_t)R.hp * T, t0, n);
  tilefma::layer<1, 4, JB>(wp + at.pw2, KK, d.HP, bufA, las, WS, HALO_F,
                           W - HALO_F, pipe, tilefma::no_next());
  transition_log_softmax(
      K, n,
      [&](int r, int jj) {
        return las[r * WS + HALO_F + jj] + __ldg(Wt.pb2 + r);
      },
      [&](int r, int jj, float v) { las[r * WS + HALO_F + jj] = v; });
  __syncthreads();
  store_rows(las, WS, HALO_F, S + (size_t)R.la * T, KK, t0, n, T);
  const double s = block_sum(p_nll, red);
  if (threadIdx.x == 0) loss_partials[3 * (size_t)blockIdx.x] = s;
}

// Two blocks an SM: at most 64 registers a thread.
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
  const Packed at = packed<false>(d);
  float* S = scratch + (size_t)b * R.total * T;
  const int L = lengths[b];
  const int vt = valid_to(lengths, d, &vt_s);
  log_pi(Wt.logprior, K, logpi_s);
  const float s_p = -beta / (float)batch_total(d),
              s_h = beta / (float)batch_total(d);

  load_rows(douts, WS, S + (size_t)R.dout * T, 2 * C, p0, W, T, T);
  load_rows(qs, WS, S + (size_t)R.q * T, K, p0, W, T, T);
  load_rows(lqs, WS, S + (size_t)R.lq * T, K, p0, W, T, T);
  load_rows(las, WS, S + (size_t)R.la * T, KK, p0, W, T, T);
  __syncthreads();
  // dhd2 = W3^T d(mu, logvar), gated by hd2's ReLU
  tilefma::layer<1, 4, JB>(wp + at.dw3T, d.D, 2 * C, douts, bufA, WS, 0,
                           W, pipe, Next{wp + at.dw2T, d.D, d.D, 3});
  tilefma::finish<false>(bufA, d.D, WS, 0, W, nullptr, true, p0, T, T,
                         S + (size_t)R.hd2 * T, S + (size_t)R.dhd2 * T, t0, n);
  // dhd1, gated by hd1 (zero past valid_to)
  tilefma::layer<3, 4, JB>(wp + at.dw2T, d.D, d.D, bufA, bufB, WS, 1,
                           W - 1, pipe, Next{wp + at.dw1T, d.D, d.D, 3});
  tilefma::finish<false>(bufB, d.D, WS, 1, W - 1, nullptr, true, p0, T, T,
                         S + (size_t)R.hd1 * T, S + (size_t)R.dhd1 * T, t0, n);
  // de, masked at valid_to
  tilefma::layer<3, 4, JB>(wp + at.dw1T, d.D, d.D, bufB, bufA, WS, 2,
                           W - 2, pipe, Next{wp + at.emb, K, d.D, 1});
  tilefma::finish<false>(bufA, d.D, WS, 2, W - 2, nullptr, true, p0, T, vt,
                         nullptr, S + (size_t)R.de * T, t0, n);
  // E de, a (step, regime) a thread
  tilefma::layer<1, 1, 1>(wp + at.emb, K, d.D, bufA, gds, WS, 2, W - 2,
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
    dq_step(qs, lqs, las, gds, WS, j, t, T, K, L, s_p, s_h, logpi_s,
            t >= t0 && t < t0 + n, p_prior, p_qlogq,
            [&](int k, float v) { dls[k * WS + j] = v; },
            [&](int r, float v) { daps[r * WS + j] = v; });
  }
  __syncthreads();
  store_rows(dls, WS, HALO_B, S + (size_t)R.dl * T, K, t0, n, T);
  store_rows(daps, WS, HALO_B, S + (size_t)R.dap * T, KK, t0, n, T);
  // dh2 = W3^T d logits, gated by h2's ReLU
  tilefma::layer<1, 4, JB>(wp + at.ew3T, d.H2, K, dls, bufB, WS, 2, W - 2,
                           pipe, Next{wp + at.ew2T, d.H1, d.H2, 3});
  tilefma::finish<false>(bufB, d.H2, WS, 2, W - 2, nullptr, true, p0, T, T,
                         S + (size_t)R.h2 * T, S + (size_t)R.dh2 * T, t0, n);
  // dh1, gated by h1 (zero past valid_to), on the tile
  tilefma::layer<3, 4, JB>(wp + at.ew2T, d.H1, d.H2, bufB, bufA, WS,
                           HALO_B, W - HALO_B, pipe,
                           Next{wp + at.pw2T, d.HP, KK, 1});
  tilefma::finish<false>(bufA, d.H1, WS, HALO_B, W - HALO_B, nullptr, true, p0,
                         T, T, S + (size_t)R.h1 * T, S + (size_t)R.dh1 * T, t0,
                         n);
  // dhp = W2^T d transition logits, gated by hp's ReLU, on the tile, across
  // both buffers
  tilefma::layer<1, 4, JB>(wp + at.pw2T, d.HP, KK, daps, bufA, WS, HALO_B,
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

// The jobs in (o, i) tiles of `tile` pairs a side: WG_TILE for the float32
// kernel, WG_TILE_MMA for the bfloat16 mode's.
inline Jobs make_jobs(const Dims& d, int tile) {
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
    jobs.j[i].tiles_i = (list[i].I + tile - 1) / tile;
    jobs.j[i].first_tile = first;
    first += ((list[i].O + tile - 1) / tile) * jobs.j[i].tiles_i;
  }
  jobs.tiles = first;
  return jobs;
}

template <int TAPS>
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
      float4 am = *reinterpret_cast<const float4*>(ip);
      float4 a0 = *reinterpret_cast<const float4*>(ip + WG_STRIDE);
#pragma unroll 4
      for (int tt = 0; tt < WG_SLAB; ++tt) {
        const float4 d4 = *reinterpret_cast<const float4*>(dp + tt * WG_STRIDE);
        const float4 ap =
            *reinterpret_cast<const float4*>(ip + (tt + 2) * WG_STRIDE);
        const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
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
              acc[k][a][c] = fmaf(dv[a], v[k][c], acc[k][a][c]);
        }
        am = a0;
        a0 = ap;
      }
    } else {
#pragma unroll 4
      for (int tt = 0; tt < WG_SLAB; ++tt) {
        const float4 d4 = *reinterpret_cast<const float4*>(dp + tt * WG_STRIDE);
        const float4 a4 =
            *reinterpret_cast<const float4*>(ip + (tt + 1) * WG_STRIDE);
        const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
        const float v[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          gb[a] += dv[a];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[0][a][c] = fmaf(dv[a], v[c], acc[0][a][c]);
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
    weight_grad_tile<3>(job, o_base, i_base, scratch, rows_total, T,
                              nslab, u0, u1, part, dys, ins);
  else
    weight_grad_tile<1>(job, o_base, i_base, scratch, rows_total, T,
                              nslab, u0, u1, part, dys, ins);
}

// ---------------------------------------------------------------------------
// The bfloat16 mode: the products on the tensor cores (tile_mma.cuh).
// ---------------------------------------------------------------------------

using tilemma::bf16;
using tilemma::op_stride;

__global__ void __launch_bounds__(256) train_pack_bf16_kernel(
    MmaPackJobs jobs, bf16* __restrict__ dst) {
  tilemma::pack_fragments(jobs.j, NPACK, dst);
}

// x (zero past valid_to) or u on the window as a bfloat16 operand, the
// padding channels zero; the block's own steps of it, float32, to the
// scratch rows `own`.  src(c, p) reads channel c at time p in [0, T).
template <typename Src>
__device__ __forceinline__ void load_operand(bf16* op, int RS, int nch,
                                             int W, int p0, int limit,
                                             Src src, float* own, int T,
                                             int t0, int n) {
  const int C16 = tilemma::round16(nch);
  for (int idx = threadIdx.x; idx < C16 * W; idx += blockDim.x) {
    const int c = idx / W, j = idx - c * W;
    const int p = p0 + j;
    const float v = (c < nch && p >= 0 && p < limit) ? src(c, p) : 0.f;
    op[j * RS + c] = __float2bfloat16_rn(v);
    if (c < nch && p >= t0 && p < t0 + n) own[(size_t)c * T + p] = v;
  }
}

// Three blocks an SM: at most 80 registers a thread (the mma items and
// their epilogues wait on memory, so more warps an SM beat more registers
// on the card).  The same window, the same stages and the same epilogues
// as train_forward_kernel, each layer an implicit GEMM on the tensor cores.
__global__ void __launch_bounds__(MMA_THREADS, 3) train_forward_bf16_kernel(
    const float* __restrict__ x, const float* __restrict__ u,
    const int* __restrict__ lengths, Weights Wt, const bf16* __restrict__ wp,
    Dims d, int tile, int tiles, float* __restrict__ scratch,
    double* __restrict__ loss_partials) {
  extern __shared__ __align__(16) unsigned char smem_b[];
  __shared__ double red[MMA_THREADS];
  __shared__ int vt_s;
  __shared__ float s_r_s;
  using tilemma::Out;

  const int T = d.T, C = d.C, K = d.K, KK = d.K * d.K;
  const int WS = row_stride(tile, HALO_F), NR = op_rows(tile, HALO_F);
  const int RG = op_stride(fwd_operand(d)), RC = op_stride(C),
            RU = op_stride(d.U);
  bf16* opA = reinterpret_cast<bf16*>(smem_b);   // NR rows of RG
  bf16* opB = opA + NR * RG;                     // NR rows of RG
  bf16* xo = opB + NR * RG;                      // NR rows of RC
  bf16* uo = xo + NR * RC;                       // NR rows of RU
  float* F = reinterpret_cast<float*>(uo + NR * RU);   // fwd_f32_rows rows

  const int b = blockIdx.x / tiles;
  const int t0 = (blockIdx.x - b * tiles) * tile;
  const int n = min(tile, T - t0);
  const int W = n + 2 * HALO_F;
  const int p0 = t0 - HALO_F;
  const tilemma::Win win{p0, T, t0, n};
  const Rows R = rows(d);
  const Packed at = packed<true>(d);
  float* S = scratch + (size_t)b * R.total * T;
  const float* xb = x + (size_t)b * C * T;
  const float* ub = u + (size_t)b * d.u_sb;
  const int L = lengths[b];
  const int vt = valid_to(lengths, d, &vt_s);
  if (threadIdx.x == 0) s_r_s = recon_scale(lengths, d);

  // x on the window, zero outside [0, T) and past valid_to; u on it
  load_operand(xo, RC, C, W, p0, vt,
               [&](int c, int p) { return xb[(size_t)c * T + p]; },
               S + (size_t)R.xm * T, T, t0, n);
  load_operand(uo, RU, d.U, W, p0, T,
               [&](int c, int p) { return ub[c * d.u_sc + p * d.u_st]; },
               S + (size_t)R.uu * T, T, t0, n);
  __syncthreads();
  const float s_r = s_r_s;
  // h1 = relu(conv1(x)), masked at valid_to
  tilemma::layer<3>(wp + at.ew1, d.H1, C, xo, RC, NR, 1, W - 1,
                    Out{Wt.eb1, true, true, vt, nullptr, S + (size_t)R.h1 * T,
                        nullptr, 0, opA, RG}, win);
  // h2 = relu(conv2(h1)), not masked
  tilemma::layer<3>(wp + at.ew2, d.H2, d.H1, opA, RG, NR, 2, W - 2,
                    Out{Wt.eb2, true, false, T, nullptr, S + (size_t)R.h2 * T,
                        nullptr, 0, opB, RG}, win);
  // logits into F rows [0, K); log q and q per step, q also as an operand
  tilemma::layer<1>(wp + at.ew3, K, d.H2, opB, RG, NR, 2, W - 2,
                    Out{Wt.eb3, false, false, T, nullptr, nullptr, F, WS,
                        nullptr, 0}, win);
  posterior_softmax(
      K, 2, W - 2, [&](int k, int j) { return F[k * WS + j]; },
      [&](int k, int j, float l, float q) {
        const int p = p0 + j;
        opA[j * RG + k] = __float2bfloat16_rn(q);
        if (p >= t0 && p < t0 + n) {
          S[(size_t)(R.q + k) * T + p] = q;
          S[(size_t)(R.lq + k) * T + p] = l;
        }
      });
  tilemma::zero_pad(opA, RG, K, 2, W - 2);
  __syncthreads();
  // e = E^T q, masked at valid_to
  tilemma::layer<1>(wp + at.embT, d.D, K, opA, RG, NR, 2, W - 2,
                    Out{nullptr, false, true, vt, nullptr, S + (size_t)R.e * T,
                        nullptr, 0, opB, RG}, win);
  // hd1 = relu(dconv1(e)), masked; hd2 = relu(dconv2(hd1)), not masked
  tilemma::layer<3>(wp + at.dw1, d.D, d.D, opB, RG, NR, 3, W - 3,
                    Out{Wt.db1, true, true, vt, nullptr,
                        S + (size_t)R.hd1 * T, nullptr, 0, opA, RG}, win);
  tilemma::layer<3>(wp + at.dw2, d.D, d.D, opA, RG, NR, HALO_F, W - HALO_F,
                    Out{Wt.db2, true, false, T, nullptr,
                        S + (size_t)R.hd2 * T, nullptr, 0, opB, RG}, win);
  // (mu, logvar) on the tile into F rows [0, 2C), the Gaussian NLL and its
  // gradient
  tilemma::layer<1>(wp + at.dw3, 2 * C, d.D, opB, RG, NR, HALO_F, W - HALO_F,
                    Out{Wt.db3, false, false, T, nullptr, nullptr, F, WS,
                        nullptr, 0}, win);
  const double p_nll = gaussian_nll(
      [&](int c, int jj, float& mu, float& lv) {
        mu = F[c * WS + HALO_F + jj];
        lv = F[(C + c) * WS + HALO_F + jj];
      },
      xb, S + (size_t)R.dout * T, C, T, t0, n, L, s_r);
  __syncthreads();
  // the prior on the tile: hp = relu(fc1(u)), log_A = log_softmax(fc2(hp))
  // into F rows [0, K*K)
  tilemma::layer<1>(wp + at.pw1, d.HP, d.U, uo, RU, NR, HALO_F, W - HALO_F,
                    Out{Wt.pb1, true, false, T, nullptr, S + (size_t)R.hp * T,
                        nullptr, 0, opA, RG}, win);
  tilemma::layer<1>(wp + at.pw2, KK, d.HP, opA, RG, NR, HALO_F, W - HALO_F,
                    Out{Wt.pb2, false, false, T, nullptr, nullptr, F, WS,
                        nullptr, 0}, win);
  transition_log_softmax(
      K, n, [&](int r, int jj) { return F[r * WS + HALO_F + jj]; },
      [&](int r, int jj, float v) {
        S[(size_t)(R.la + r) * T + t0 + jj] = v;
      });
  const double s = block_sum(p_nll, red);
  if (threadIdx.x == 0) loss_partials[3 * (size_t)blockIdx.x] = s;
}

// Three blocks an SM, as the forward.  The same window and stages as
// train_backward_kernel, each transposed layer an implicit GEMM on the
// tensor cores.
__global__ void __launch_bounds__(MMA_THREADS, 3) train_backward_bf16_kernel(
    const int* __restrict__ lengths, Weights Wt, const bf16* __restrict__ wp,
    Dims d, float beta, int tile, int tiles, float* __restrict__ scratch,
    double* __restrict__ loss_partials) {
  extern __shared__ __align__(16) unsigned char smem_b[];
  __shared__ double red[MMA_THREADS];
  __shared__ float logpi_s[KMAX];
  __shared__ int vt_s;
  using tilemma::Out;

  const int T = d.T, C = d.C, K = d.K, KK = d.K * d.K;
  const int WS = row_stride(tile, HALO_B), NR = op_rows(tile, HALO_B);
  const int RG = op_stride(bwd_operand(d)), RD = op_stride(2 * C),
            RK = op_stride(K), RKK = op_stride(KK);
  bf16* opA = reinterpret_cast<bf16*>(smem_b);   // NR rows of RG
  bf16* opB = opA + NR * RG;                     // NR rows of RG
  bf16* dop = opB + NR * RG;                     // d(mu, logvar): NR x RD
  bf16* dlo = dop + NR * RD;                     // d logits: NR x RK
  bf16* dapo = dlo + NR * RK;                    // d log_A: NR x RKK
  float* qs = reinterpret_cast<float*>(dapo + NR * RKK);   // K rows
  float* lqs = qs + K * WS;                // K rows
  float* las = lqs + K * WS;               // K*K rows
  float* gds = las + KK * WS;              // K rows: E de

  const int b = blockIdx.x / tiles;
  const int t0 = (blockIdx.x - b * tiles) * tile;
  const int n = min(tile, T - t0);
  const int W = n + 2 * HALO_B;
  const int p0 = t0 - HALO_B;
  const tilemma::Win win{p0, T, t0, n};
  const Rows R = rows(d);
  const Packed at = packed<true>(d);
  float* S = scratch + (size_t)b * R.total * T;
  const int L = lengths[b];
  const int vt = valid_to(lengths, d, &vt_s);
  log_pi(Wt.logprior, K, logpi_s);
  const float s_p = -beta / (float)batch_total(d),
              s_h = beta / (float)batch_total(d);

  const float* douts = S + (size_t)R.dout * T;
  load_operand(dop, RD, 2 * C, W, p0, T,
               [&](int c, int p) { return douts[(size_t)c * T + p]; },
               nullptr, T, 0, 0);
  load_rows(qs, WS, S + (size_t)R.q * T, K, p0, W, T, T);
  load_rows(lqs, WS, S + (size_t)R.lq * T, K, p0, W, T, T);
  load_rows(las, WS, S + (size_t)R.la * T, KK, p0, W, T, T);
  __syncthreads();
  // dhd2 = W3^T d(mu, logvar), gated by hd2's ReLU
  tilemma::layer<1>(wp + at.dw3T, d.D, 2 * C, dop, RD, NR, 0, W,
                    Out{nullptr, false, true, T, S + (size_t)R.hd2 * T,
                        S + (size_t)R.dhd2 * T, nullptr, 0, opA, RG}, win);
  // dhd1, gated by hd1 (zero past valid_to)
  tilemma::layer<3>(wp + at.dw2T, d.D, d.D, opA, RG, NR, 1, W - 1,
                    Out{nullptr, false, true, T, S + (size_t)R.hd1 * T,
                        S + (size_t)R.dhd1 * T, nullptr, 0, opB, RG}, win);
  // de, masked at valid_to
  tilemma::layer<3>(wp + at.dw1T, d.D, d.D, opB, RG, NR, 2, W - 2,
                    Out{nullptr, false, true, vt, nullptr,
                        S + (size_t)R.de * T, nullptr, 0, opA, RG}, win);
  // E de
  tilemma::layer<1>(wp + at.emb, K, d.D, opA, RG, NR, 2, W - 2,
                    Out{nullptr, false, false, T, nullptr, nullptr, gds, WS,
                        nullptr, 0}, win);
  // the prior, entropy and decoder terms of dq -> d logits; d transition
  // logits; the loss sums of the prior and the entropy on the tile's steps.
  // d logits and d transition logits go to the scratch (the tile's steps)
  // and, rounded, to the operands of the last two layers.
  double p_prior = 0.0, p_qlogq = 0.0;
  for (int j = 2 + threadIdx.x; j < W - 2; j += blockDim.x) {
    const int t = p0 + j;
    const bool own = t >= t0 && t < t0 + n;
    if (t < 0 || t >= T) {
      for (int k = 0; k < K; ++k) dlo[j * RK + k] = __float2bfloat16_rn(0.f);
      for (int r = 0; r < KK; ++r)
        dapo[j * RKK + r] = __float2bfloat16_rn(0.f);
      continue;
    }
    dq_step(qs, lqs, las, gds, WS, j, t, T, K, L, s_p, s_h, logpi_s, own,
            p_prior, p_qlogq,
            [&](int k, float v) {
              dlo[j * RK + k] = __float2bfloat16_rn(v);
              if (own) S[(size_t)(R.dl + k) * T + t] = v;
            },
            [&](int r, float v) {
              dapo[j * RKK + r] = __float2bfloat16_rn(v);
              if (own) S[(size_t)(R.dap + r) * T + t] = v;
            });
  }
  tilemma::zero_pad(dlo, RK, K, 2, W - 2);
  tilemma::zero_pad(dapo, RKK, KK, 2, W - 2);
  __syncthreads();
  // dh2 = W3^T d logits, gated by h2's ReLU
  tilemma::layer<1>(wp + at.ew3T, d.H2, K, dlo, RK, NR, 2, W - 2,
                    Out{nullptr, false, true, T, S + (size_t)R.h2 * T,
                        S + (size_t)R.dh2 * T, nullptr, 0, opB, RG}, win);
  // dh1, gated by h1 (zero past valid_to), on the tile
  tilemma::layer<3>(wp + at.ew2T, d.H1, d.H2, opB, RG, NR, HALO_B,
                    W - HALO_B,
                    Out{nullptr, false, true, T, S + (size_t)R.h1 * T,
                        S + (size_t)R.dh1 * T, nullptr, 0, nullptr, 0}, win);
  // dhp = W2^T d transition logits, gated by hp's ReLU, on the tile
  tilemma::layer<1>(wp + at.pw2T, d.HP, KK, dapo, RKK, NR, HALO_B, W - HALO_B,
                    Out{nullptr, false, true, T, S + (size_t)R.hp * T,
                        S + (size_t)R.dhp * T, nullptr, 0, nullptr, 0}, win);
  const double s1 = block_sum(p_prior, red);
  const double s2 = block_sum(p_qlogq, red);
  if (threadIdx.x == 0) {
    loss_partials[3 * (size_t)blockIdx.x + 1] = s1;
    loss_partials[3 * (size_t)blockIdx.x + 2] = s2;
  }
}

// One weight gradient on the tensor cores: a block of WG_MMA_THREADS owns
// WG_TILE_MMA x WG_TILE_MMA (o, i) pairs of one gradient and one split of
// the (sequence, slab of WG_SLAB steps) units.  gw[o][i][k] = sum_t dy[o][t]
// in[i][t - taps/2 + k] is a GEMM with M = o, N = i and the reduction over
// t: a slab is two chunks of 16 steps, each chunk's float32 partial sum
// added to the pair's in order (tile_mma.cuh's mma_chunk).  dy is staged [o][t] (the A
// operand, ldmatrix) and the input [t][i] (the B operand, ldmatrix.trans),
// so that a tap is a row offset, both rounded to bfloat16 as they are
// staged; the next unit's values are loaded into registers while the
// tensor cores work on this one.  Warp w keeps 16 o x 32 i x taps sums in
// registers.  The bias gradient gb[o] = sum_t dy[o][t] sums the unrounded
// dy on the CUDA cores: a thread keeps a fixed (o, t mod 32) partial over
// the units, and the 32 partials of an o are added in order at the end.
// Tiles twice the float32 kernel's a side read each slab of dy and of the
// input half as often.
constexpr int WG_MMA_THREADS = 256;
constexpr int WG_DY_RS = WG_SLAB + 8;       // bfloat16 values a staged dy row
constexpr int WG_IN_RS = WG_TILE_MMA + 8;   // ... a staged input step

template <int TAPS>
__device__ __forceinline__ void weight_grad_mma_tile(
    const Job& job, int o_base, int i_base, const float* __restrict__ scratch,
    int rows_total, int T, int nslab, int u0, int u1,
    float* __restrict__ part, bf16* dys, bf16* ins, float* red) {
  constexpr int WARPS = WG_MMA_THREADS / 32;
  constexpr int NO = WG_TILE_MMA / WARPS;                             // 8
  constexpr int NIN = WG_TILE_MMA * (WG_SLAB + 2);
  constexpr int NI = (NIN + WG_MMA_THREADS - 1) / WG_MMA_THREADS;      // 9
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int oq = warp & 3, ih = warp >> 2;    // 16 o, 32 i a warp
  float acc[TAPS][4][4];
#pragma unroll
  for (int k = 0; k < TAPS; ++k)
#pragma unroll
    for (int h = 0; h < 4; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[k][h][e] = 0.f;
  float gb[NO], dv[NO], iv[NI];
#pragma unroll
  for (int q = 0; q < NO; ++q) gb[q] = 0.f;
  // a unit's dy[o][ts + lane] (o = warp + 8 q) and in[i][ts - 1 + r]
  // (i, r from threadIdx.x + 256 q), zero outside the layer and [0, T)
  auto load = [&](int unit) {
    const int b = unit / nslab;
    const int ts = (unit - b * nslab) * WG_SLAB;
    const float* S = scratch + (size_t)b * rows_total * T;
    const int t = ts + lane;
#pragma unroll
    for (int q = 0; q < NO; ++q) {
      const int o = o_base + warp + WARPS * q;
      dv[q] = (o < job.O && t < T) ? S[(size_t)(job.dy_row + o) * T + t]
                                   : 0.f;
    }
#pragma unroll
    for (int q = 0; q < NI; ++q) {
      const int idx = threadIdx.x + WG_MMA_THREADS * q;
      const int i = idx / (WG_SLAB + 2), r = idx - i * (WG_SLAB + 2);
      const int tt = ts - 1 + r;
      iv[q] = (idx < NIN && i_base + i < job.I && tt >= 0 && tt < T)
                  ? S[(size_t)(job.in_row + i_base + i) * T + tt]
                  : 0.f;
    }
  };
  auto store = [&](bf16* dyb, bf16* inb) {
#pragma unroll
    for (int q = 0; q < NO; ++q) {
      dyb[(warp + WARPS * q) * WG_DY_RS + lane] = __float2bfloat16_rn(dv[q]);
      gb[q] += dv[q];
    }
#pragma unroll
    for (int q = 0; q < NI; ++q) {
      const int idx = threadIdx.x + WG_MMA_THREADS * q;
      const int i = idx / (WG_SLAB + 2), r = idx - i * (WG_SLAB + 2);
      if (idx < NIN) inb[r * WG_IN_RS + i] = __float2bfloat16_rn(iv[q]);
    }
  };
  if (u0 < u1) load(u0);
  for (int unit = u0; unit < u1; ++unit) {
    const int buf = (unit - u0) & 1;
    bf16* dyb = dys + buf * WG_TILE_MMA * WG_DY_RS;
    bf16* inb = ins + buf * (WG_SLAB + 2) * WG_IN_RS;
    store(dyb, inb);
    __syncthreads();
    if (unit + 1 < u1) load(unit + 1);
#pragma unroll
    for (int c = 0; c < WG_SLAB / 16; ++c) {
      uint32_t a[4];
      tilemma::ldmatrix_x4(a, dyb + (16 * oq + (lane & 15)) * WG_DY_RS +
                                  16 * c + 8 * (lane >> 4));
      const uint4 af{a[0], a[1], a[2], a[3]};
#pragma unroll
      for (int k = 0; k < TAPS; ++k) {
        // B[s][i] = in[i][ts + 16 c + s - 1 + k'] is staged row
        // 16 c + s + k' (k' = k, or 1 for a 1x1 layer)
        const int row = 16 * c + (TAPS == 1 ? 1 : k) + (lane & 7) +
                        8 * ((lane >> 3) & 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t bb[4];
          tilemma::ldmatrix_x4_trans(
              bb, inb + row * WG_IN_RS + 32 * ih + 16 * h + 8 * (lane >> 4));
          tilemma::mma_chunk(acc[k][2 * h], af, bb[0], bb[1]);
          tilemma::mma_chunk(acc[k][2 * h + 1], af, bb[2], bb[3]);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < TAPS; ++k)
#pragma unroll
    for (int h = 0; h < 4; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = o_base + 16 * oq + (lane >> 2) + 8 * (e >> 1);
        const int i = i_base + 32 * ih + 8 * h + 2 * (lane & 3) + (e & 1);
        if (o < job.O && i < job.I)
          part[job.off_w + ((long long)o * job.I + i) * TAPS + k] =
              acc[k][h][e];
      }
  if (job.off_b >= 0 && i_base == 0) {
#pragma unroll
    for (int q = 0; q < NO; ++q) red[(warp + WARPS * q) * 32 + lane] = gb[q];
    __syncthreads();
    if (threadIdx.x < WG_TILE_MMA && o_base + threadIdx.x < job.O) {
      float s = 0.f;
      for (int l = 0; l < 32; ++l) s += red[threadIdx.x * 32 + l];
      part[job.off_b + o_base + threadIdx.x] = s;
    }
  }
}

__global__ void __launch_bounds__(WG_MMA_THREADS) train_weight_grad_bf16_kernel(
    const float* __restrict__ scratch, Jobs jobs, int rows_total, int T,
    int nslab, int units, int per, float* __restrict__ partials,
    long long P) {
  __shared__ __align__(16) bf16 dys[2 * WG_TILE_MMA * WG_DY_RS];
  __shared__ __align__(16) bf16 ins[2 * (WG_SLAB + 2) * WG_IN_RS];
  __shared__ float red[WG_TILE_MMA * 32];
  int ji = 0;
  while (ji + 1 < NJOBS && (int)blockIdx.x >= jobs.j[ji + 1].first_tile) ++ji;
  const Job job = jobs.j[ji];
  const int local = blockIdx.x - job.first_tile;
  const int o_base = (local / job.tiles_i) * WG_TILE_MMA;
  const int i_base = (local % job.tiles_i) * WG_TILE_MMA;
  const int u0 = blockIdx.y * per;
  const int u1 = min(units, u0 + per);
  float* part = partials + (size_t)blockIdx.y * P;
  if (job.taps == 3)
    weight_grad_mma_tile<3>(job, o_base, i_base, scratch, rows_total, T,
                            nslab, u0, u1, part, dys, ins, red);
  else
    weight_grad_mma_tile<1>(job, o_base, i_base, scratch, rows_total, T,
                            nslab, u0, u1, part, dys, ins, red);
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
    const float s_p = -beta / (float)batch_total(d);
    float g[KMAX];
    for (int k = 0; k < d.K; ++k) {
      double v = 0.0;
      for (int b = threadIdx.x; b < d.B; b += 256)
        v += (double)(s_p * scratch[((size_t)b * R.total + R.q + k) * d.T]);
      g[k] = (float)tree_sum_256(v, red);
    }
    if (threadIdx.x != 0) return;
    const double denom = fmax((double)mask_total(lengths, d) * d.C, 1.0);
    // the prior and entropy sums nearly cancel (each is about T log K a
    // sequence), so they are combined in double before the one rounding
    *loss = (float)(s[0] / denom
                    + (double)beta * (s[2] - s[1]) / batch_total(d));
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

// The sixteen layers to pack, in the order of Packed.
template <typename Jobs16, bool BF16>
Jobs16 pack_jobs(const Weights& W, const Dims& d) {
  const Packed at = packed<BF16>(d);
  const int C = d.C, D = d.D, K = d.K, KK = d.K * d.K;
  return Jobs16{{{W.ew1, d.H1, C, 3, 0, at.ew1},
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
}

// The five launches of one call in mode BF16 (the entry point checked the
// arguments): the float32 kernels, or the bfloat16 mode's tensor-core
// kernels and the same reduce kernel.
template <bool BF16>
int enqueue(const float* x, const float* u, const int* lengths,
            const Weights& W, const Dims& d, float* packed_weights,
            float* scratch, float* partials, double* loss_partials,
            float* grads, float* loss, int tile, int splits, float beta,
            cudaStream_t s) {
  const int tiles = (d.T + tile - 1) / tile;
  const long long blocks = (long long)tiles * d.B;
  const int nslab = (d.T + WG_SLAB - 1) / WG_SLAB;
  const long long units = (long long)d.B * nslab;
  const int per = (int)((units + splits - 1) / splits);
  const Packed at = packed<BF16>(d);
  const Jobs jobs = make_jobs(d, BF16 ? WG_TILE_MMA : WG_TILE);
  const long long P = offsets(d).P;
  cudaError_t err;
  if constexpr (BF16) {
    const size_t sf = smem_fwd_bf16(d, tile), sb = smem_bwd_bf16(d, tile);
    err = cudaFuncSetAttribute(train_forward_bf16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sf);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(train_backward_bf16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sb);
    if (err != cudaSuccess) return (int)err;
    bf16* wp = reinterpret_cast<bf16*>(packed_weights);
    train_pack_bf16_kernel<<<(unsigned)((at.total + 255) / 256), 256, 0, s>>>(
        pack_jobs<MmaPackJobs, true>(W, d), wp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    train_forward_bf16_kernel<<<(unsigned)blocks, MMA_THREADS, sf, s>>>(
        x, u, lengths, W, wp, d, tile, tiles, scratch, loss_partials);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    train_backward_bf16_kernel<<<(unsigned)blocks, MMA_THREADS, sb, s>>>(
        lengths, W, wp, d, beta, tile, tiles, scratch, loss_partials);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    train_weight_grad_bf16_kernel<<<dim3((unsigned)jobs.tiles,
                                         (unsigned)splits),
                                    WG_MMA_THREADS, 0, s>>>(
        scratch, jobs, rows(d).total, d.T, nslab, (int)units, per, partials,
        P);
  } else {
    const int threads = block_threads(tile, widest(d));
    const size_t sf = smem_fwd(d, tile), sb = smem_bwd(d, tile);
    err = cudaFuncSetAttribute(train_forward_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sf);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(train_backward_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sb);
    if (err != cudaSuccess) return (int)err;
    train_pack_kernel<<<(unsigned)((at.total + 255) / 256), 256, 0, s>>>(
        pack_jobs<PackJobs, false>(W, d), packed_weights);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    train_forward_kernel<<<(unsigned)blocks, threads, sf, s>>>(
        x, u, lengths, W, packed_weights, d, tile, tiles, scratch,
        loss_partials);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    train_backward_kernel<<<(unsigned)blocks, threads, sb, s>>>(
        lengths, W, packed_weights, d, beta, tile, tiles, scratch,
        loss_partials);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    train_weight_grad_kernel<<<dim3((unsigned)jobs.tiles, (unsigned)splits),
                               WG_THREADS, 0, s>>>(
        scratch, jobs, rows(d).total, d.T, nslab, (int)units, per, partials,
        P);
  }
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
// 5: floats the packed weights take (bfloat16 values two a float).  bf16:
// the mode, as vqhmm_fused_train takes it.
extern "C" long long vqhmm_fused_train_sizes(int B, int C, int T, int U,
                                             int H1, int H2, int K, int HP,
                                             int D, int tile, int what,
                                             int bf16) {
  Dims d{B, C, T, U, H1, H2, K, HP, D, 0, 0, 0, -1, -1, -1};
  switch (what) {
    case 0: return offsets(d).P;
    case 1: return rows(d).total;
    case 2: return (long long)(bf16 ? smem_fwd_bf16(d, tile)
                                    : smem_fwd(d, tile));
    case 3: return (long long)(bf16 ? smem_bwd_bf16(d, tile)
                                    : smem_bwd(d, tile));
    case 4: return make_jobs(d, bf16 ? WG_TILE_MMA : WG_TILE).tiles;
    default: return bf16 ? (packed<true>(d).total + 1) / 2
                         : packed<false>(d).total;
  }
}

// packed_weights: vqhmm_fused_train_sizes(.., 5, bf16) floats; scratch: B
// * rows * T floats; partials: splits * P floats; loss_partials: 3 * B *
// ceil(T / tile) doubles.  bf16: 0 for the float32 mode, 1 for the
// bfloat16 mode (products of bfloat16 operands on the tensor cores).
// vt_global, msum_global, b_global: the global batch's valid_to, mask total
// and B, for a rank of a data-parallel step, or -1 each for this batch's
// own.
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
    int bf16, float beta, int vt_global, long long msum_global,
    int b_global, void* stream) {
  Weights W{ew1, eb1, ew2, eb2, ew3, eb3, logprior, pw1, pb1, pw2, pb2,
            emb, dw1, db1, dw2, db2, dw3, db3};
  Dims d{B, C, T, U, H1, H2, K, HP, D, u_sb, u_sc, u_st, vt_global,
         msum_global, b_global};
  const int G = widest(d);
  if (B <= 0 || T <= 0 || K <= 0 || K > KMAX || splits <= 0 ||
      splits > 65535 || (tile != 16 && tile != 32 && tile != 64) ||
      (bf16 != 0 && bf16 != 1) || vt_global < -1 || msum_global < -1 ||
      msum_global >= (1LL << 24) || b_global < -1 || b_global == 0 ||
      (b_global > 0 && b_global < B) ||
      (vt_global >= 0) != (msum_global >= 0) ||
      (vt_global >= 0) != (b_global > 0) ||
      (bf16 == 0 && 3 * tilefma::round4(maxi(G, HP)) > tilefma::WBUF))
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
