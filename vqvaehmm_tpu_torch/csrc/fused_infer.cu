// Fused serving forward of the VAE-HMM for Hopper (sm_90a):
//   encoder  conv3+ReLU -> conv3+ReLU -> 1x1 -> logits
//   softmax  q over the K regimes
//   codebook e = E^T q
//   decoder  conv3+ReLU -> conv3+ReLU -> 1x1 -> (mu, logvar)
//
// Replaces the TPU kernel vqvaehmm_tpu/ops/pallas_infer.py::_kernel.  The
// Python wrapper, the launch plan (tile width, blocks, shared memory) and
// the plain PyTorch version are in vqvaehmm_tpu_torch/ops/fused_infer.py.
//
// Layout: x (B, C, T), outputs mu/logvar (B, C, T) and q (B, K, T), all
// float32 and contiguous along T; the weights are the torch modules' own
// tensors (Conv1d (O, I, W), Embedding (K, D)).
//
// Design.  One block computes `tile` output steps of one sequence, tile
// one of 16, 32 or 64, chosen by the wrapper from the work (the widest
// for which the grid still has a block for every SM).  The block stages
// x with a HALO of 4 steps a side in shared memory (each of the four k=3
// convolutions consumes one) and keeps every intermediate there, in two
// ping-pong buffers of max(H1, H2, D, 2C) rows (the last layer leaves its
// 2C rows of mu and logvar in one); the ragged last tile computes
// its valid steps and their halo only.  All six products (four
// convolutions, to_logits, the codebook, to_params) go through the
// register-tiled building block of tile_fma.cuh: a thread computes 4
// output channels x 4 steps (1 x 1 for to_logits and 4 x 1 for to_params,
// whose few outputs are spread over the block a (step, output) each), the
// weights stream through shared memory in cp.async slabs laid out so
// that a warp reads them as neighbouring 16-byte words, and the lanes of
// a warp share their input window.  A small pack kernel lays the torch
// weights out in that order (32 768 floats at the published widths), so
// that a block stages a slab as one contiguous run.
//
// Bound.  At the published widths a token costs about 65 kFLOP against 72
// bytes of input and output, so the kernel is bound by operations: fp32
// FMA on the CUDA cores, against the card's 67 TFLOP/s.  The model's
// contract is full float32 (matmul_precision "highest"; the checks are
// 1e-5 on q and 1e-4 on mu and logvar, which TF32's three digits fail),
// so the tensor cores are not used here; they belong to a bf16
// throughput mode.  What holds a register-tiled fp32 kernel under the
// peak is the shared-memory loads an FMA needs (the 4 x 4 tile brings
// them to 5 loads for 48 FMAs), the barriers between the layers of a
// block, and, at B = 1, the latency of one block's chain of seven layers.
//
// Semantics that must hold (vqvaehmm_tpu/models/vae_hmm.py encode/decode):
//  * every convolution pads its own input with zeros at the sequence
//    ends, so h1, e and hd1 are zero outside [0, T), not values computed
//    from zero-padded x (e there would be E^T softmax(bias));
//  * valid_to[b] zeroes x, h1, e and hd1 at t >= valid_to[b], and nothing
//    else: h2, hd2 and the outputs past valid_to are computed and written;
//  * the softmax clamps the row max at -1e30 before the exp
//    (vqvaehmm_tpu/ops/pallas_infer.py:79-84);
//  * nothing depends on B, on another row or on the tile width: each
//    output's summation order is fixed (input channels ascending, taps 0,
//    1, 2 nested), so a row of a batch is bit-identical to the same row
//    computed alone, at any tile width.
//
// The weights are packed by vqhmm_fused_infer_pack, which the wrapper
// calls once a weight version and mode (ops/fused_encoder.py::KernelCache)
// and which also raises the kernel's dynamic shared-memory limit, so a
// request launches the forward alone.
//
// The bfloat16-operand mode (the TPU kernel's highest=False, taken by a
// float32 model whose matmul_precision is not "highest";
// fused_infer_bf16_kernel): both operands of every product rounded to the
// nearest bfloat16 and the sums float32, on the tensor cores: the same
// window and stages, each layer an implicit GEMM of mma.sync.m16n8k16
// (tile_mma.cuh) over bfloat16 operands kept time-major in two ping-pong
// buffers sized by the widest of H1, H2, D and K, the weights in mma
// fragment order.  x is rounded as it is staged and q as the codebook
// product's operand (K padded to a chunk of 16); the biases, ReLUs, masks
// and the softmax stay float32, the logits and q in K float32 rows, (mu,
// logvar) in 2C.  Its plain version is VAEHMM.encode/decode(
// bf16_operands=True) (ops/nn.py::bf16_matmul).  Its bound is the card's
// dense bf16 rate, 989 TFLOP/s, against which a token's 65 kFLOP leave it
// bound by bytes at every shape.
//
// What held the mode's first design (weights read from L2 two chunks
// ahead, on each layer's critical path) was the weights' latency: at
// B = 1 the seven layers took 88% of a block, a layer of twelve chunks
// about 2000 cycles and 400 more a chunk (chip_smoke.py --scan-clocks,
// PERF.md).  So the weights are staged in shared memory ahead of the
// chain (tile_mma.cuh::staged_layer, one instance a weight kind):
// RESIDENT at the published widths, each layer's fragments a TMA bulk
// copy on its own mbarrier, the first two at block start and each next
// one two layers ahead, read from shared memory by layer()'s own loop and
// sums; a ring for a model whose fragments do not fit beside the
// operands; L2 where not even two slots do.  A layer's bias is read
// before its reduction.  The sums are the first design's, so the outputs
// are bit-equal to its.  The block keeps up to 128 registers
// (__launch_bounds__(256, 2)): no spill.

#include <cuda_runtime.h>
#include <climits>
#include <cstddef>

#include "tile_fma.cuh"
#include "tile_mma.cuh"

namespace {

constexpr int HALO = 4;                // one step per k=3 convolution
constexpr int JB = 4;                  // time steps per thread in a conv
constexpr int MAX_THREADS = 512;
constexpr float NEG = -1e30f;
// shared memory a Hopper block may use (227 KB, NVIDIA H100 data sheet)
constexpr int SMEM_LIMIT = 232448;

__host__ __device__ inline int row_stride(int tile) {
  return tile + 2 * HALO + JB;         // window plus room for over-reads
}

// Threads of a block: the (4 output channels, JB steps) tiles of the
// widest layer over the widest convolution's range, spread evenly over
// the fewest rounds of at most MAX_THREADS threads, so that no round of
// such a convolution runs on a part of the block; four warps at least.
inline int block_threads(int tile, int maxH) {
  const int items = (maxH + 3) / 4 * (tile / JB + 2);
  const int rounds = (items + MAX_THREADS - 1) / MAX_THREADS;
  const int t = ((items + rounds - 1) / rounds + 31) / 32 * 32;
  return t < 128 ? 128 : t;
}

// First float of each layer in the packed weights (tile_fma.cuh's order;
// the codebook as the transposed layer e = E^T q).
struct Packed {
  long long ew1, ew2, ew3, emb, dw1, dw2, dw3, total;
};

__host__ __device__ inline Packed packed(int C, int H1, int H2, int K, int D) {
  Packed p;
  long long at = 0;
  p.ew1 = at; at += tilefma::packed_floats(H1, C, 3);
  p.ew2 = at; at += tilefma::packed_floats(H2, H1, 3);
  p.ew3 = at; at += tilefma::packed_floats(K, H2, 1);
  p.emb = at; at += tilefma::packed_floats(D, K, 1);
  p.dw1 = at; at += tilefma::packed_floats(D, D, 3);
  p.dw2 = at; at += tilefma::packed_floats(D, D, 3);
  p.dw3 = at; at += tilefma::packed_floats(2 * C, D, 1);
  p.total = at;
  return p;
}

constexpr int NPACK = 7;
struct PackJobs {
  tilefma::PackJob j[NPACK];
};

__global__ void __launch_bounds__(256) infer_pack_kernel(PackJobs jobs,
                                                   float* __restrict__ dst) {
  tilefma::pack_weights(jobs.j, NPACK, dst);
}

// First bfloat16 value of each layer in the bfloat16 mode's packed weights
// (tile_mma.cuh's fragment order; the codebook as the transposed layer).
__host__ __device__ inline Packed packed_bf16(int C, int H1, int H2, int K,
                                              int D) {
  using tilemma::packed_elems;
  Packed p;
  long long at = 0;
  p.ew1 = at; at += packed_elems(H1, C, 3);
  p.ew2 = at; at += packed_elems(H2, H1, 3);
  p.ew3 = at; at += packed_elems(K, H2, 1);
  p.emb = at; at += packed_elems(D, K, 1);
  p.dw1 = at; at += packed_elems(D, D, 3);
  p.dw2 = at; at += packed_elems(D, D, 3);
  p.dw3 = at; at += packed_elems(2 * C, D, 1);
  p.total = at;
  return p;
}

struct MmaPackJobs {
  tilemma::PackJob j[NPACK];
};

__global__ void __launch_bounds__(256) infer_pack_bf16_kernel(
    MmaPackJobs jobs, tilemma::bf16* __restrict__ dst) {
  tilemma::pack_fragments(jobs.j, NPACK, dst);
}

__device__ __forceinline__ bool outside(int p, int T, int vt) {
  return p < 0 || p >= T || p >= vt;
}

__global__ void __launch_bounds__(MAX_THREADS) fused_infer_kernel(
    const float* __restrict__ x, const int* __restrict__ valid_to,
    const float* __restrict__ wp, const float* __restrict__ eb1,
    const float* __restrict__ eb2, const float* __restrict__ eb3,
    const float* __restrict__ db1, const float* __restrict__ db2,
    const float* __restrict__ db3, float* __restrict__ mu, float* __restrict__ logvar,
    float* __restrict__ q_out,
    int C, int T, int H1, int H2, int K, int D, int tile, int tiles,
    int rows) {
  extern __shared__ __align__(16) float smem[];
  const int WS = row_stride(tile);
  using tilefma::Next;
  tilefma::Pipe pipe{smem, 0, false};        // two weight slabs
  float* xs = tilefma::first_row(smem + 2 * tilefma::WBUF);   // C rows
  float* bufA = xs + C * WS;                 // `rows` rows
  float* bufB = bufA + rows * WS;            // `rows` rows
  float* qs = bufB + rows * WS;              // K rows

  const int b = blockIdx.x / tiles;
  const int t0 = (blockIdx.x - b * tiles) * tile;
  const int n = min(tile, T - t0);           // valid steps of this tile
  const int W = n + 2 * HALO;                // its window
  const int p0 = t0 - HALO;
  const int vt = valid_to[b];
  const float* xb = x + (size_t)b * C * T;
  const Packed at = packed(C, H1, H2, K, D);
  const float *ew1 = wp + at.ew1, *ew2 = wp + at.ew2, *ew3 = wp + at.ew3,
              *emb = wp + at.emb, *dw1 = wp + at.dw1, *dw2 = wp + at.dw2,
              *dw3 = wp + at.dw3;

  // 1. x on the whole window, zero outside [0, T) and past valid_to
  for (int idx = threadIdx.x; idx < C * W; idx += blockDim.x) {
    const int c = idx / W, j = idx - c * W;
    const int p = p0 + j;
    xs[c * WS + j] = outside(p, T, vt) ? 0.f : xb[(size_t)c * T + p];
  }
  __syncthreads();
  // 2. h1 = relu(conv1(x)), masked
  tilefma::layer<3, 4, JB>(ew1, H1, C, xs, bufA, WS, 1, W - 1, pipe,
                                  Next{ew2, H2, H1, 3});
  tilefma::finish<true>(bufA, H1, WS, 1, W - 1, eb1, true, p0, T, vt, nullptr,
                        nullptr, 0, 0);
  // 3. h2 = relu(conv2(h1)), not masked
  tilefma::layer<3, 4, JB>(ew2, H2, H1, bufA, bufB, WS, 2, W - 2, pipe,
                                  Next{ew3, K, H2, 1});
  tilefma::finish<true>(bufB, H2, WS, 2, W - 2, eb2, false, p0, T, vt, nullptr,
                        nullptr, 0, 0);
  // 4. logits = W3 h2 + b3, a (step, regime) a thread; q = softmax over K
  //    (row max clamped at -1e30)
  tilefma::layer<1, 1, 1>(ew3, K, H2, bufB, qs, WS, 2, W - 2, pipe,
                                 Next{emb, D, K, 1});
  for (int j = 2 + threadIdx.x; j < W - 2; j += blockDim.x) {
    float m = -INFINITY;
    for (int k = 0; k < K; ++k) {
      const float l = qs[k * WS + j] + __ldg(eb3 + k);
      qs[k * WS + j] = l;
      m = fmaxf(m, l);
    }
    const float msafe = fmaxf(m, NEG);
    float z = 0.f;
    for (int k = 0; k < K; ++k) {
      const float e = expf(qs[k * WS + j] - msafe);
      qs[k * WS + j] = e;
      z += e;
    }
    for (int k = 0; k < K; ++k) qs[k * WS + j] = qs[k * WS + j] / z;
  }
  __syncthreads();
  // 5. e = E^T q, masked
  tilefma::layer<1, 4, JB>(emb, D, K, qs, bufA, WS, 2, W - 2, pipe,
                                 Next{dw1, D, D, 3});
  tilefma::finish<false>(bufA, D, WS, 2, W - 2, nullptr, true, p0, T, vt,
                         nullptr, nullptr, 0, 0);
  // 6. hd1 = relu(dconv1(e)), masked
  tilefma::layer<3, 4, JB>(dw1, D, D, bufA, bufB, WS, 3, W - 3, pipe,
                                  Next{dw2, D, D, 3});
  tilefma::finish<true>(bufB, D, WS, 3, W - 3, db1, true, p0, T, vt, nullptr,
                        nullptr, 0, 0);
  // 7. hd2 = relu(dconv2(hd1)), not masked
  tilefma::layer<3, 4, JB>(dw2, D, D, bufB, bufA, WS, HALO, W - HALO,
                                  pipe, Next{dw3, 2 * C, D, 1});
  tilefma::finish<true>(bufA, D, WS, HALO, W - HALO, db2, false, p0, T, vt,
                        nullptr, nullptr, 0, 0);
  // 8. (mu, logvar) = W hd2 + b on the tile, 4 outputs x 1 step a thread;
  //    q on the tile
  tilefma::layer<1, 4, 1>(dw3, 2 * C, D, bufA, bufB, WS, HALO, W - HALO,
                                 pipe, tilefma::no_next());
  for (int idx = threadIdx.x; idx < 2 * C * n; idx += blockDim.x) {
    const int o = idx / n, jj = idx - o * n;
    const float val = bufB[o * WS + HALO + jj] + __ldg(db3 + o);
    float* dst = o < C ? mu + ((size_t)b * C + o) * T
                       : logvar + ((size_t)b * C + (o - C)) * T;
    dst[t0 + jj] = val;
  }
  for (int idx = threadIdx.x; idx < K * n; idx += blockDim.x) {
    const int k = idx / n, jj = idx - k * n;
    q_out[((size_t)b * K + k) * T + t0 + jj] = qs[k * WS + HALO + jj];
  }
}

// The bfloat16 mode's block: 8 warps, at most 2 an SM (up to 128
// registers a thread: at 3 an SM the kernel kept 80 and spilled).  Shared
// memory: bfloat16 operands of op_rows_bf16(tile) rows (x, then two
// ping-pong buffers of the widest of H1, H2, D and K), then float32 rows
// of row_stride(tile) floats: K for the logits and q, 2C for (mu,
// logvar); then the weights as tile_mma.cuh::stage_plan places them:
// RESIDENT the next item's raw x window (C rows of op_rows_bf16(tile)
// floats), the barriers and the seven layers' fragments; RING the
// barriers and the slots; DIRECT nothing more.
constexpr int MMA_THREADS = 256;
constexpr int MMA_BLOCKS_PER_SM = 2;

__host__ __device__ inline int op_rows_bf16(int tile) {
  return tile + 2 * HALO;
}

__host__ __device__ inline int operand_bf16(int H1, int H2, int K, int D) {
  const int h = H1 > H2 ? H1 : H2;
  const int e = D > K ? D : K;
  return h > e ? h : e;
}

// the operands' bytes (x, two ping-pong buffers, K + 2C float32 rows)
__host__ __device__ inline int bf16_operand_bytes(int C, int H1, int H2,
                                                  int K, int D, int tile) {
  return 2 * op_rows_bf16(tile) *
             (tilemma::op_stride(C) +
              2 * tilemma::op_stride(operand_bf16(H1, H2, K, D))) +
         (int)sizeof(float) * row_stride(tile) * (K + 2 * C);
}

__host__ __device__ inline tilemma::StagePlan bf16_stage(int C, int H1,
                                                         int H2, int K, int D,
                                                         int tile) {
  return tilemma::stage_plan(
      bf16_operand_bytes(C, H1, H2, K, D, tile),
      (long long)sizeof(float) * C * op_rows_bf16(tile),
      packed_bf16(C, H1, H2, K, D).total, SMEM_LIMIT);
}

// The kernel walks the items (sequence, tile) blockIdx.x, blockIdx.x +
// gridDim.x, ...: a persistent grid of resident blocks where the weights
// are RESIDENT (staged once a block; each item's raw x window prefetched
// with cp.async while the item before it computes), one item a block
// otherwise.  Each item's layers and their sums are the first design's.
template <int KIND>
__global__ void __launch_bounds__(MMA_THREADS, MMA_BLOCKS_PER_SM)
    fused_infer_bf16_kernel(
    const float* __restrict__ x, const int* __restrict__ valid_to,
    const tilemma::bf16* __restrict__ wp, const float* __restrict__ eb1,
    const float* __restrict__ eb2, const float* __restrict__ eb3,
    const float* __restrict__ db1, const float* __restrict__ db2,
    const float* __restrict__ db3, float* __restrict__ mu,
    float* __restrict__ logvar, float* __restrict__ q_out, int C, int T,
    int H1, int H2, int K, int D, int tile, int tiles, int items) {
  extern __shared__ __align__(16) unsigned char smem_b[];
  using tilemma::bf16;
  using tilemma::Out;
  const int WS = row_stride(tile), NR = op_rows_bf16(tile);
  const int RC = tilemma::op_stride(C);
  const int RG = tilemma::op_stride(operand_bf16(H1, H2, K, D));
  bf16* xo = reinterpret_cast<bf16*>(smem_b);    // NR rows of RC
  bf16* opA = xo + NR * RC;                      // NR rows of RG
  bf16* opB = opA + NR * RG;                     // NR rows of RG
  float* qs = reinterpret_cast<float*>(opB + NR * RG);   // K rows
  float* F = qs + K * WS;                        // 2C rows
  constexpr bool prefetch = KIND == tilemma::RESIDENT;
  unsigned char* after = smem_b + bf16_operand_bytes(C, H1, H2, K, D, tile);
  float* xraw = reinterpret_cast<float*>(after);  // C rows of NR floats
  if (prefetch) after += sizeof(float) * C * NR;
  tilemma::Staged st;
  st.slots = bf16_stage(C, H1, H2, K, D, tile).slots;
  st.wp = wp;
  st.bar = reinterpret_cast<uint64_t*>(after);
  st.ring_chain = reinterpret_cast<tilemma::ChainLayer*>(
      after + 8 * 2 * tilemma::RING_SLOTS);
  st.sw = reinterpret_cast<bf16*>(after + tilemma::CTRL_BYTES);
  st.l0 = 0;
  st.l1 = 7;
  const Packed at = packed_bf16(C, H1, H2, K, D);
  const auto chain = [&](int l) {
    switch (l) {
      case 0: return tilemma::ChainLayer{at.ew1, H1, C, 3, 1, 1};
      case 1: return tilemma::ChainLayer{at.ew2, H2, H1, 3, 2, 2};
      case 2: return tilemma::ChainLayer{at.ew3, K, H2, 1, 2, 2};
      case 3: return tilemma::ChainLayer{at.emb, D, K, 1, 2, 2};
      case 4: return tilemma::ChainLayer{at.dw1, D, D, 3, 3, 3};
      case 5: return tilemma::ChainLayer{at.dw2, D, D, 3, HALO, HALO};
      default: return tilemma::ChainLayer{at.dw3, 2 * C, D, 1, HALO, HALO};
    }
  };

  // the raw x window of an item into xraw, the steps inside [0, T) and
  // before valid_to alone (the staging zeroes the rest): one cp.async
  // group
  auto fetch_x = [&](int item) {
    const int b = item / tiles;
    const int t0 = (item - b * tiles) * tile;
    const int W = min(tile, T - t0) + 2 * HALO;
    const int vt = valid_to[b];
    const float* xb = x + (size_t)b * C * T;
    for (int idx = threadIdx.x; idx < C * W; idx += blockDim.x) {
      const int c = idx / W, j = idx - c * W;
      const int p = t0 - HALO + j;
      if (!outside(p, T, vt))
        tilefma::cp_async4_zfill(xraw + c * NR + j, xb + (size_t)c * T + p,
                                 true);
    }
    tilefma::cp_async_commit();
  };

  // 0. the weights: the first layers' bulk copies in flight (RESIDENT)
  //    while x is staged
  tilemma::stage_start<KIND>(st, chain);
  bool fetched = false;     // this item's raw x prefetched into xraw
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int b = item / tiles;
    const int t0 = (item - b * tiles) * tile;
    const int n = min(tile, T - t0);
    const int W = n + 2 * HALO;
    const int p0 = t0 - HALO;
    const int vt = valid_to[b];
    const float* xb = x + (size_t)b * C * T;
    const tilemma::Win win{p0, T, t0, n};
    tilemma::stage_item<KIND>(st, chain, W, p0);

    // 1. x on the whole window, zero outside [0, T) and past valid_to and
    //    in the padding channels, rounded to bfloat16
    if (fetched) {
      tilefma::cp_async_wait<0>();
      __syncthreads();
    }
    const int C16 = tilemma::round16(C);
    for (int idx = threadIdx.x; idx < C16 * W; idx += blockDim.x) {
      const int c = idx / W, j = idx - c * W;
      const int p = p0 + j;
      float v = 0.f;
      if (c < C && !outside(p, T, vt))
        v = fetched ? xraw[c * NR + j] : xb[(size_t)c * T + p];
      xo[j * RC + c] = __float2bfloat16_rn(v);
    }
    __syncthreads();
    // the next item's x in flight while this one computes
    fetched = prefetch && item + (int)gridDim.x < items;
    if (fetched) fetch_x(item + gridDim.x);
    // 2. h1 = relu(conv1(x)), masked
    tilemma::staged_layer<3, KIND>(st, chain, 0, xo, RC, NR,
                             Out{eb1, true, true, vt, nullptr, nullptr,
                                 nullptr, 0, opA, RG}, win);
    // 3. h2 = relu(conv2(h1)), not masked
    tilemma::staged_layer<3, KIND>(st, chain, 1, opA, RG, NR,
                             Out{eb2, true, false, T, nullptr, nullptr,
                                 nullptr, 0, opB, RG}, win);
    // 4. logits = W3 h2 + b3 into the K float32 rows; q = softmax over K
    //    (row max clamped at -1e30) in place, and as the codebook's operand
    tilemma::staged_layer<1, KIND>(st, chain, 2, opB, RG, NR,
                             Out{eb3, false, false, T, nullptr, nullptr, qs,
                                 WS, nullptr, 0}, win);
    for (int j = 2 + threadIdx.x; j < W - 2; j += blockDim.x) {
      float m = -INFINITY;
      for (int k = 0; k < K; ++k) m = fmaxf(m, qs[k * WS + j]);
      const float msafe = fmaxf(m, NEG);
      float z = 0.f;
      for (int k = 0; k < K; ++k) {
        const float e = expf(qs[k * WS + j] - msafe);
        qs[k * WS + j] = e;
        z += e;
      }
      for (int k = 0; k < K; ++k) {
        const float q = qs[k * WS + j] / z;
        qs[k * WS + j] = q;
        opA[j * RG + k] = __float2bfloat16_rn(q);
      }
    }
    tilemma::zero_pad(opA, RG, K, 2, W - 2);
    __syncthreads();
    // 5. e = E^T q, masked
    tilemma::staged_layer<1, KIND>(st, chain, 3, opA, RG, NR,
                             Out{nullptr, false, true, vt, nullptr, nullptr,
                                 nullptr, 0, opB, RG}, win);
    // 6. hd1 = relu(dconv1(e)), masked
    tilemma::staged_layer<3, KIND>(st, chain, 4, opB, RG, NR,
                             Out{db1, true, true, vt, nullptr, nullptr,
                                 nullptr, 0, opA, RG}, win);
    // 7. hd2 = relu(dconv2(hd1)), not masked
    tilemma::staged_layer<3, KIND>(st, chain, 5, opA, RG, NR,
                             Out{db2, true, false, T, nullptr, nullptr,
                                 nullptr, 0, opB, RG}, win);
    // 8. (mu, logvar) = W hd2 + b on the tile into the 2C float32 rows
    tilemma::staged_layer<1, KIND>(st, chain, 6, opB, RG, NR,
                             Out{db3, false, false, T, nullptr, nullptr, F,
                                 WS, nullptr, 0}, win);
    for (int idx = threadIdx.x; idx < 2 * C * n; idx += blockDim.x) {
      const int o = idx / n, jj = idx - o * n;
      float* dst = o < C ? mu + ((size_t)b * C + o) * T
                         : logvar + ((size_t)b * C + (o - C)) * T;
      dst[t0 + jj] = F[o * WS + HALO + jj];
    }
    for (int idx = threadIdx.x; idx < K * n; idx += blockDim.x) {
      const int k = idx / n, jj = idx - k * n;
      q_out[((size_t)b * K + k) * T + t0 + jj] = qs[k * WS + HALO + jj];
    }
  }
}

inline int max3(int a, int b, int c) { return a > b ? (a > c ? a : c) : (b > c ? b : c); }

// Rows of a ping-pong buffer: the widest activation a stage leaves there,
// the 2C rows of (mu, logvar) among them.
inline int buffer_rows(int C, int H1, int H2, int D) {
  const int h = max3(H1, H2, D);
  return h > 2 * C ? h : 2 * C;
}

}  // namespace

// Values of the packed weights: floats (bf16 = 0), or the bfloat16 mode's
// bfloat16 values (bf16 = 1).
extern "C" long long vqhmm_fused_infer_packed_floats(int C, int H1, int H2,
                                                     int K, int D, int bf16) {
  return bf16 ? packed_bf16(C, H1, H2, K, D).total
              : packed(C, H1, H2, K, D).total;
}

// Dynamic shared memory of a block at tile width `tile` in the mode (the
// bfloat16 mode's with its weights where stage_plan puts them).
extern "C" int vqhmm_fused_infer_smem_bytes(int C, int H1, int H2, int K,
                                            int D, int tile, int bf16) {
  if (bf16) return bf16_stage(C, H1, H2, K, D, tile).bytes;
  return (int)(sizeof(float) * (2 * tilefma::WBUF + tilefma::ROW_PAD +
                                (size_t)row_stride(tile) *
                                    (C + 2 * buffer_rows(C, H1, H2, D) + K)));
}

// Pack the torch weights (Conv1d (O, I, W), Embedding (K, D)) into dst in
// the mode's order: floats in tile_fma.cuh's staging order (bf16 = 0),
// bfloat16 values in mma fragment order (bf16 = 1); and raise the mode's
// kernel's dynamic shared-memory limit to a block's most, so that a
// launch sets no attribute.
extern "C" int vqhmm_fused_infer_pack(const float* ew1, const float* ew2,
                                      const float* ew3, const float* emb,
                                      const float* dw1, const float* dw2,
                                      const float* dw3, void* dst, int C,
                                      int H1, int H2, int K, int D, int bf16,
                                      void* stream) {
  if (bf16 != 0 && bf16 != 1) return (int)cudaErrorInvalidValue;
  const void* kernels[3] = {
      (const void*)fused_infer_bf16_kernel<tilemma::DIRECT>,
      (const void*)fused_infer_bf16_kernel<tilemma::RESIDENT>,
      (const void*)fused_infer_bf16_kernel<tilemma::RING>};
  cudaError_t err = cudaSuccess;
  for (int k = 0; k < (bf16 ? 3 : 1) && err == cudaSuccess; ++k)
    err = cudaFuncSetAttribute(
        bf16 ? kernels[k] : (const void*)fused_infer_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    const Packed at = packed_bf16(C, H1, H2, K, D);
    const MmaPackJobs jobs{{{ew1, H1, C, 3, 0, at.ew1},
                            {ew2, H2, H1, 3, 0, at.ew2},
                            {ew3, K, H2, 1, 0, at.ew3},
                            {emb, D, K, 1, 1, at.emb},
                            {dw1, D, D, 3, 0, at.dw1},
                            {dw2, D, D, 3, 0, at.dw2},
                            {dw3, 2 * C, D, 1, 0, at.dw3}}};
    infer_pack_bf16_kernel<<<(unsigned)((at.total + 255) / 256), 256, 0, s>>>(
        jobs, reinterpret_cast<tilemma::bf16*>(dst));
  } else {
    const Packed at = packed(C, H1, H2, K, D);
    const PackJobs jobs{{{ew1, H1, C, 3, 0, at.ew1},
                         {ew2, H2, H1, 3, 0, at.ew2},
                         {ew3, K, H2, 1, 0, at.ew3},
                         {emb, D, K, 1, 1, at.emb},
                         {dw1, D, D, 3, 0, at.dw1},
                         {dw2, D, D, 3, 0, at.dw2},
                         {dw3, 2 * C, D, 1, 0, at.dw3}}};
    infer_pack_kernel<<<(unsigned)((at.total + 255) / 256), 256, 0, s>>>(
        jobs, reinterpret_cast<float*>(dst));
  }
  return (int)cudaGetLastError();
}

// The forward in the mode (bf16 0: float32, 1: bfloat16 operands) from
// weights vqhmm_fused_infer_pack packed in that mode.  grid: the bfloat16
// mode's blocks, 1 to B * ceil(T / tile) (a persistent grid walks the
// items); the float32 mode takes a block an item and passes 0.
extern "C" int vqhmm_fused_infer(
    const float* x, const int* valid_to, const void* packed_weights,
    const float* eb1, const float* eb2, const float* eb3, const float* db1,
    const float* db2, const float* db3, float* mu, float* logvar, float* q,
    int B, int C, int T, int H1, int H2, int K, int D, int tile, int bf16,
    int grid, void* stream) {
  const int maxH = max3(H1, H2, D);
  const int smem = vqhmm_fused_infer_smem_bytes(C, H1, H2, K, D, tile, bf16);
  if ((tile != 16 && tile != 32 && tile != 64) || (bf16 != 0 && bf16 != 1))
    return (int)cudaErrorInvalidValue;
  const int tiles = (T + tile - 1) / tile;
  const long long blocks = (long long)tiles * B;
  if (B <= 0 || T <= 0 || K <= 0 || blocks > INT_MAX ||
      smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    if (grid < 1 || grid > blocks) return (int)cudaErrorInvalidValue;
    const tilemma::bf16* w =
        reinterpret_cast<const tilemma::bf16*>(packed_weights);
    switch (bf16_stage(C, H1, H2, K, D, tile).kind) {
      case tilemma::RESIDENT:
        fused_infer_bf16_kernel<tilemma::RESIDENT>
            <<<(unsigned)grid, MMA_THREADS, smem, s>>>(
                x, valid_to, w, eb1, eb2, eb3, db1, db2, db3, mu, logvar, q,
                C, T, H1, H2, K, D, tile, tiles, (int)blocks);
        break;
      case tilemma::RING:
        fused_infer_bf16_kernel<tilemma::RING>
            <<<(unsigned)grid, MMA_THREADS, smem, s>>>(
                x, valid_to, w, eb1, eb2, eb3, db1, db2, db3, mu, logvar, q,
                C, T, H1, H2, K, D, tile, tiles, (int)blocks);
        break;
      default:
        fused_infer_bf16_kernel<tilemma::DIRECT>
            <<<(unsigned)grid, MMA_THREADS, smem, s>>>(
                x, valid_to, w, eb1, eb2, eb3, db1, db2, db3, mu, logvar, q,
                C, T, H1, H2, K, D, tile, tiles, (int)blocks);
    }
    return (int)cudaGetLastError();
  }
  if (grid != 0) return (int)cudaErrorInvalidValue;
  // a slab holds at least one input channel of every output
  if (3 * tilefma::round4(maxH) > tilefma::WBUF ||
      tilefma::round4(K) > tilefma::WBUF ||
      tilefma::round4(2 * C) > tilefma::WBUF)
    return (int)cudaErrorInvalidValue;
  fused_infer_kernel<<<(unsigned)blocks, block_threads(tile, maxH), smem, s>>>(
      x, valid_to, reinterpret_cast<const float*>(packed_weights), eb1, eb2,
      eb3, db1, db2, db3, mu, logvar, q, C, T, H1, H2, K, D, tile, tiles,
      buffer_rows(C, H1, H2, D));
  return (int)cudaGetLastError();
}

extern "C" const char* vqhmm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
