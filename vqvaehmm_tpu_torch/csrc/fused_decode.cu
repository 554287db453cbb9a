// The HMM evidence, and the one-kernel Viterbi decode from raw (x, u) to
// states, of the VAE-HMM for Hopper (sm_90a).
//
// Replaces two TPU kernels of vqvaehmm_tpu/ops/pallas_decode.py:
//   _evidence_kernel -> fused_evidence_kernel (kernel 11): encoder ->
//     log-softmax over the K regimes (log_obs); prior MLP -> log-softmax
//     over each row of K transitions (log_A);
//   _kernel -> fused_decode_kernel (kernel 10): the same evidence, inert
//     padding past each sequence's length, the max-plus recursion and the
//     backtrace.
// The Python wrappers and their plain PyTorch versions are in
// vqvaehmm_tpu_torch/ops/fused_decode.py.  Both kernels compute the
// evidence with the device functions of encoder_fma.cuh (shared with the
// encoder kernel, on tile_fma.cuh's register tile) from the weights
// vqhmm_encoder_pack lays out, and the decode runs the segmented max-plus
// scan of maxplus_scan.cuh, as the Viterbi kernel (viterbi.cu, kernel B)
// does: kernel 10 gives the bits of kernel 11 followed by kernel B.
//
// Layout: x (B, C, T) float32 contiguous; u (B, U, T) or (B, T, U), read
// through its strides; lengths (B,) int32 or null (both kernels bound the
// encoder at one scalar, max(lengths), T where null, which each warp
// reduces for itself); log_obs (B, T, K) and log_A (B, T, K, K) float32
// contiguous, the layouts ops/hmm.py and the Viterbi kernel read; states
// (B, T) int32.
//
// Semantics.  The evidence applies no length masking: ops/hmm.py masks
// downstream.  The decode makes a step t >= L inert (a zero observation
// and an identity transition), so the path freezes at t = L - 1; delta_0 =
// log_pi + obs_0 and log_A at t = 0 is unused (maxplus_scan.cuh).  Only
// on request (`inert`, which the Viterbi decode sets, whose scan replaces
// every step t >= L by the inert step) and where lengths is given, an
// evidence block whose tile starts at or past its sequence's length
// computes nothing: it writes the inert step into the tile's steps (log_obs
// 0, log_A the identity) and returns.  Every other tile, the one that
// straddles L included, is computed as without the request.
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
// Design, decode.  A cooperative launch of persistent blocks, all
// resident at once (the launcher sizes the grid by the occupancy the
// runtime reports), with four grid-wide barriers.  Each block takes the
// tiles blockIdx.x, blockIdx.x + gridDim.x, ... (`ntb` at most) and
// keeps each tile's log_obs, log_A and backpointer words in shared memory
// from the first phase to the last (about 1.5 KB a tile of 32 at K = 3),
// so the evidence of a sequence is computed on as many SMs as it has
// tiles and never reaches device memory.  Phases: the tile's evidence as
// kernel 11 computes it, then (a) of its segments (a tile holds whole
// segments); barrier; (b) the fold of each sequence on the first warp of
// one block, its products staged into shared memory a chunk at a time
// (chunk_floats), a chunk of the two-level fold a lane; barrier; (c) the
// rerun of the
// tile's segments; barrier; (d) the reverse pass of each sequence on the
// same warp, the selector maps staged the same way; barrier; (e) the
// tile's backtrace.  Only the per-segment aggregates
// cross blocks, through a small scratch in device memory (products,
// incoming deltas, the end delta, selector maps, end states: under 60
// bytes a segment at K = 3), read with ld.global.cg so that no stale L1
// line is seen.  A thread-block cluster a sequence was the other design:
// at most 8 (16) blocks, so at (1, 2327) its 73 tiles of 32 would take
// 9 rounds of a block's chain of layers, where kernel 11 takes one.
//
// Bound.  A token costs about 17.7 kFLOP of fp32 FMA (the encoder 14.4,
// the prior MLP 3.3) against 36 bytes read and 48 written by the evidence
// kernel, or 4 written by the decode: both are bound by arithmetic and
// its shared-memory loads, and at small B by one block's chain of layers;
// the decode adds the scan's serial depth (the fold and the reverse pass
// on one warp) and its four grid barriers, and keeps every tile of the
// batch resident, which bounds B * T (the launcher refuses a plan whose
// tiles do not fit).
//
// The bfloat16-operand mode (the TPU kernels' highest=False, taken by a
// float32 model whose matmul_precision is not "highest"): the same two
// designs with the evidence stages of encoder_mma.cuh, each layer an
// implicit GEMM of mma.sync.m16n8k16 (tile_mma.cuh) on bfloat16 operands
// with float32 sums, the weights packed once a model in mma fragment order
// (vqhmm_encoder_pack, bf16 = 1): fused_evidence_bf16_kernel (blocks of
// encmma::THREADS threads, split as the float32 kernel) and
// fused_decode_kernel<K, true, DIRECT> (the same persistent blocks, phases
// and scan, its weights read from L2).  The log-softmax, the scan and the
// backtrace are the float32 mode's.  Its bound is the card's dense bf16
// rate, 989 TFLOP/s: the evidence is then bound by its bytes at every
// shape.  What held the evidence's first design was its layers' weights,
// read from L2 on each layer's critical path (PERF.md, chip_smoke.py
// --scan-clocks); its second design, fused_evidence_bf16_staged_kernel,
// stages the weights of the block's stage in shared memory ahead of its
// layers (tile_mma.cuh::staged_layer) where the grid leaves an SM a block
// at most, with the same sums, so its outputs, and kernel 10's evidence,
// are bit-equal to the first's; on larger grids the first design runs
// (evidence_stage).  The decode's second design,
// fused_decode_kernel<K, true, RESIDENT>, stages the five layers' weights
// once a block, before its first tile, and computes each of its tiles'
// evidence from them (staged_tile_evidence), with the same sums; its
// plan takes it where its blocks keep the first design's tiles a block
// (decode_choice), and the scan phases are the first design's.

#include <cuda_runtime.h>
#include <climits>
#include <cstddef>
#include <cstdint>

#include <cooperative_groups.h>

#include "encoder_fma.cuh"
#include "encoder_mma.cuh"
#include "maxplus_scan.cuh"

namespace {

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

// Where `inert` and lengths is given: whether the tile at t0 of sequence b
// starts at or past the sequence's length.  The same for every thread of
// the block, so the block may return before its first barrier.
__device__ __forceinline__ bool tile_inert(const int* __restrict__ lengths,
                                           int inert, int b, int t0) {
  return inert && lengths != nullptr && t0 >= lengths[b];
}

// A tile's n steps left inert: log_obs 0 and log_A the identity (0 on the
// diagonal, -inf off it), the values ops/hmm.py::_mask_inputs and
// maxplus_scan.cuh::step put in their place (null: the stage did not run
// here).
__device__ __forceinline__ void write_inert(int K, int n, float* obs,
                                            float* trans) {
  const int KK = K * K;
  if (obs != nullptr)
    for (int idx = threadIdx.x; idx < n * K; idx += blockDim.x) obs[idx] = 0.f;
  if (trans != nullptr)
    for (int idx = threadIdx.x; idx < n * KK; idx += blockDim.x) {
      const int e = idx % KK;
      trans[idx] = e / K == e % K ? 0.f : -INFINITY;
    }
}

// Bias and log-softmax in place, a (step, row) a thread, rows [rlo, rhi):
// row K the regimes, row r < K the transitions out of regime r.  Ends
// with a __syncthreads.
__device__ __forceinline__ void tile_log_softmax(const encfma::Rows& s,
                                                 const encfma::Weights& W,
                                                 int K, int n, int WS,
                                                 int rlo, int rhi) {
  const int per = rhi - rlo;
  for (int idx = threadIdx.x; idx < n * per; idx += blockDim.x) {
    const int j = idx / per, r = rlo + idx - j * per;
    if (r == K)
      encfma::log_softmax_biased(s.lg + encfma::HALO + j, W.eb3, K, WS);
    else
      encfma::log_softmax_biased(s.ap + (size_t)r * K * WS + encfma::HALO + j,
                                 W.pb2 + r * K, K, WS);
  }
  __syncthreads();
}

// A tile's n steps of log_obs (n * K) and log_A (n * K * K), each
// step-major and contiguous, from the window rows to obs and trans (null:
// the stage did not run here).
__device__ __forceinline__ void write_tile(const encfma::Rows& s, int K,
                                           int n, int WS, float* obs,
                                           float* trans) {
  const int KK = K * K;
  if (obs != nullptr)
    for (int idx = threadIdx.x; idx < n * K; idx += blockDim.x) {
      const int j = idx / K;
      obs[idx] = s.lg[(idx - j * K) * WS + encfma::HALO + j];
    }
  if (trans != nullptr)
    for (int idx = threadIdx.x; idx < n * KK; idx += blockDim.x) {
      const int j = idx / KK;
      trans[idx] = s.ap[(idx - j * KK) * WS + encfma::HALO + j];
    }
}

__global__ void __launch_bounds__(encfma::MAX_THREADS, 2)
    fused_evidence_kernel(const float* __restrict__ x,
                          const float* __restrict__ u, long long u_sb,
                          long long u_sc, long long u_st,
                          const int* __restrict__ lengths, encfma::Weights W,
                          float* __restrict__ log_obs,
                          float* __restrict__ log_A, encfma::Dims d, int B,
                          int T, int tile, int tiles, int split,
                          int inert) {
  extern __shared__ __align__(16) float smem[];
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
  if (tile_inert(lengths, inert, b, t0)) {
    write_inert(K, n,
                stage != 1 ? log_obs + ((size_t)b * T + t0) * K : nullptr,
                stage != 0 ? log_A + ((size_t)b * T + t0) * KK : nullptr);
    return;
  }

  if (stage != 1)
    encfma::encoder_stage(x + (size_t)b * d.C * T, W, d, T, t0, n, WS,
                          batch_bound(lengths, B, T), s, pipe,
                          stage == 2 ? encfma::prior_first(W, d)
                                     : tilefma::no_next());
  if (stage != 0)
    encfma::prior_stage(u + b * u_sb, u_sc, u_st, W, d, t0, n, WS, s, pipe);
  tile_log_softmax(s, W, K, n, WS, stage == 0 ? K : 0,
                   stage == 1 ? K : K + 1);
  write_tile(s, K, n, WS,
             stage != 1 ? log_obs + ((size_t)b * T + t0) * K : nullptr,
             stage != 0 ? log_A + ((size_t)b * T + t0) * KK : nullptr);
}

// The float32 rows of a bfloat16-mode block as the log-softmax and the
// tile writer read them.
__device__ __forceinline__ encfma::Rows tile_rows(const encmma::Ops& s) {
  encfma::Rows r{};
  r.lg = s.lg;
  r.ap = s.ap;
  return r;
}

// Kernel 11's blocks in the mode: the operands (encmma::smem_bytes), then,
// where `staged`, the weights as tile_mma.cuh::stage_plan places them
// beside them; else none (DIRECT, read from L2).  The caller stages where
// the grid leaves an SM a block at most: a block's chain of layers is then
// the critical path, and its weights' latency is what holds it.  On a
// larger grid the other blocks' warps hide that latency, and each block's
// copy of its weights costs more than it saves (kernel 11's chain is two
// to five short layers; PERF.md), so the first design's kernel,
// which reads L2, runs there.
__host__ __device__ inline tilemma::StagePlan evidence_stage(
    const encfma::Dims& d, int tile, bool staged) {
  const int base = encmma::smem_bytes(d, tile);
  if (!staged) return tilemma::StagePlan{tilemma::DIRECT, 0, base};
  return tilemma::stage_plan(base, 0, encmma::packed(d).total,
                             encfma::SMEM_LIMIT);
}

// The bfloat16 mode of fused_evidence_kernel: the same blocks, stages and
// outputs, the layers on the tensor cores (encoder_mma.cuh); W.wp holds
// the weights vqhmm_encoder_pack packed in the bfloat16 mode.
__global__ void __launch_bounds__(encmma::THREADS, encmma::BLOCKS_PER_SM)
    fused_evidence_bf16_kernel(const float* __restrict__ x,
                               const float* __restrict__ u, long long u_sb,
                               long long u_sc, long long u_st,
                               const int* __restrict__ lengths,
                               encfma::Weights W,
                               float* __restrict__ log_obs,
                               float* __restrict__ log_A, encfma::Dims d,
                               int B, int T, int tile, int tiles, int split,
                               int inert) {
  extern __shared__ __align__(16) unsigned char smem_b[];
  const encmma::Ops s = encmma::carve(smem_b, d, tile);
  const tilemma::bf16* wp = reinterpret_cast<const tilemma::bf16*>(W.wp);
  const int K = d.K, KK = d.K * d.K;
  // stage 0: the encoder, 1: the prior, 2: both
  const int unit = split ? (int)(blockIdx.x >> 1) : (int)blockIdx.x;
  const int stage = split ? (int)(blockIdx.x & 1) : 2;
  const int b = unit / tiles;
  const int t0 = (unit - b * tiles) * tile;
  const int n = min(tile, T - t0);
  if (tile_inert(lengths, inert, b, t0)) {
    write_inert(K, n,
                stage != 1 ? log_obs + ((size_t)b * T + t0) * K : nullptr,
                stage != 0 ? log_A + ((size_t)b * T + t0) * KK : nullptr);
    return;
  }

  if (stage != 1)
    encmma::encoder_stage(x + (size_t)b * d.C * T, wp, W.eb1, W.eb2, d, T,
                          t0, n, batch_bound(lengths, B, T), s,
                          encmma::raw_logits(s));
  if (stage != 0)
    encmma::prior_stage(u + b * u_sb, u_sc, u_st, wp, W.pb1, d, T, t0, n, s);
  const encfma::Rows r = tile_rows(s);
  tile_log_softmax(r, W, K, n, s.WS, stage == 0 ? K : 0,
                   stage == 1 ? K : K + 1);
  write_tile(r, K, n, s.WS,
             stage != 1 ? log_obs + ((size_t)b * T + t0) * K : nullptr,
             stage != 0 ? log_A + ((size_t)b * T + t0) * KK : nullptr);
}

// The same with the weights staged in shared memory ahead of the block's
// chain (tile_mma.cuh::staged_layer: the encoder's three layers, the
// prior's two, or a split block's own stage's; RESIDENT or RING, one
// instance each), where the grid leaves an SM a block at most; the sums
// are fused_evidence_bf16_kernel's, so are the outputs.
template <int KIND>
__global__ void __launch_bounds__(encmma::THREADS, encmma::BLOCKS_PER_SM)
    fused_evidence_bf16_staged_kernel(const float* __restrict__ x,
                               const float* __restrict__ u, long long u_sb,
                               long long u_sc, long long u_st,
                               const int* __restrict__ lengths,
                               encfma::Weights W,
                               float* __restrict__ log_obs,
                               float* __restrict__ log_A, encfma::Dims d,
                               int B, int T, int tile, int tiles, int split,
                               int inert) {
  extern __shared__ __align__(16) unsigned char smem_b[];
  using tilemma::Out;
  const encmma::Ops s = encmma::carve(smem_b, d, tile);
  const int K = d.K, KK = d.K * d.K;
  // stage 0: the encoder, 1: the prior, 2: both
  const int unit = split ? (int)(blockIdx.x >> 1) : (int)blockIdx.x;
  const int stage = split ? (int)(blockIdx.x & 1) : 2;
  const int b = unit / tiles;
  const int t0 = (unit - b * tiles) * tile;
  const int n = min(tile, T - t0);
  const bool enc = stage != 1, pri = stage != 0;
  // before the weights' bulk copies are asked for
  if (tile_inert(lengths, inert, b, t0)) {
    write_inert(K, n, enc ? log_obs + ((size_t)b * T + t0) * K : nullptr,
                pri ? log_A + ((size_t)b * T + t0) * KK : nullptr);
    return;
  }
  const int Wn = n + 2 * encfma::HALO;
  const int p0 = t0 - encfma::HALO;
  const int vt = batch_bound(lengths, B, T);
  unsigned char* after = smem_b + encmma::smem_bytes(d, tile);
  const encmma::Packed at = encmma::packed(d);
  tilemma::Staged st;
  st.slots = evidence_stage(d, tile, KIND != tilemma::DIRECT).slots;
  st.wp = reinterpret_cast<const tilemma::bf16*>(W.wp);
  st.bar = reinterpret_cast<uint64_t*>(after);
  st.ring_chain = reinterpret_cast<tilemma::ChainLayer*>(
      after + 8 * 2 * tilemma::RING_SLOTS);
  st.sw = reinterpret_cast<tilemma::bf16*>(after + tilemma::CTRL_BYTES);
  // the chain: the encoder's layers 0-2, the prior's 3-4; the block's
  // range of it by its stage
  const auto chain = [&](int l) {
    switch (l) {
      case 0: return tilemma::ChainLayer{at.w1, d.H1, d.C, 3, 1, 1};
      case 1: return tilemma::ChainLayer{at.w2, d.H2, d.H1, 3, 2, 2};
      case 2: return tilemma::ChainLayer{at.w3, K, d.H2, 1, 2, 2};
      case 3: return tilemma::ChainLayer{at.p1, d.HP, d.U, 1, 2, 2};
      case 4: return tilemma::ChainLayer{at.p2, KK, d.HP, 1, 2, 2};
      default: return tilemma::ChainLayer{0, 0, 0, 0, 0, 0};
    }
  };
  st.l0 = enc ? 0 : 3;
  st.l1 = pri ? 5 : 3;
  const tilemma::Win win{p0, T, t0, n};
  tilemma::stage_start<KIND>(st, chain);
  tilemma::stage_item<KIND>(st, chain, Wn, p0);

  // x on the whole window, zero outside [0, T) and past the bound and in
  // the padding channels; u on the tile's own steps; both rounded
  const float* xb = x + (size_t)b * d.C * T;
  const float* ub = u + b * u_sb;
  const int C16 = enc ? tilemma::round16(d.C) : 0;
  for (int idx = threadIdx.x; idx < C16 * Wn; idx += blockDim.x) {
    const int c = idx / Wn, j = idx - c * Wn;
    const int p = p0 + j;
    const float v = (c < d.C && !encfma::outside(p, T, vt))
                        ? xb[(size_t)c * T + p] : 0.f;
    s.xo[j * s.RC + c] = __float2bfloat16_rn(v);
  }
  const int U16 = pri ? tilemma::round16(d.U) : 0;
  for (int idx = threadIdx.x; idx < U16 * n; idx += blockDim.x) {
    const int c = idx / n, j = idx - c * n;
    const float v = c < d.U ? ub[c * u_sc + (long long)(t0 + j) * u_st] : 0.f;
    s.uo[(encfma::HALO + j) * s.RU + c] = __float2bfloat16_rn(v);
  }
  __syncthreads();
  // h1 = relu(conv1(x)), zero outside the sequence and past the bound;
  // h2 = relu(conv2(h1)) on the tile, not masked; the raw logits
  if (enc)
    tilemma::staged_layer<3, KIND>(st, chain, 0, s.xo, s.RC, s.NR,
                                   Out{W.eb1, true, true, vt, nullptr,
                                       nullptr, nullptr, 0, s.a, s.RG}, win);
  if (enc)
    tilemma::staged_layer<3, KIND>(st, chain, 1, s.a, s.RG, s.NR,
                                   Out{W.eb2, true, false, T, nullptr,
                                       nullptr, nullptr, 0, s.b, s.RG}, win);
  if (enc)
    tilemma::staged_layer<1, KIND>(st, chain, 2, s.b, s.RG, s.NR,
                                   encmma::raw_logits(s), win);
  // hp = relu(fc1(u)) on the tile; the raw transition logits
  if (pri)
    tilemma::staged_layer<1, KIND>(st, chain, 3, s.uo, s.RU, s.NR,
                                   Out{W.pb1, true, false, T, nullptr,
                                       nullptr, nullptr, 0, s.a, s.RG}, win);
  if (pri)
    tilemma::staged_layer<1, KIND>(st, chain, 4, s.a, s.RG, s.NR,
                                   Out{nullptr, false, false, T, nullptr,
                                       nullptr, s.ap, s.WS, nullptr, 0}, win);
  const encfma::Rows r = tile_rows(s);
  tile_log_softmax(r, W, K, n, s.WS, stage == 0 ? K : 0,
                   stage == 1 ? K : K + 1);
  write_tile(r, K, n, s.WS,
             enc ? log_obs + ((size_t)b * T + t0) * K : nullptr,
             pri ? log_A + ((size_t)b * T + t0) * KK : nullptr);
}

// Floats of a block of the decode before the tile store: the evidence
// stage's shared memory in the mode, rounded to 16 bytes.
template <bool BF16>
__host__ __device__ inline int decode_stage_floats(const encfma::Dims& d,
                                                   int tile) {
  const int bytes = BF16 ? encmma::smem_bytes(d, tile)
                         : encfma::smem_bytes(d, tile);
  return (bytes / 4 + 3) & ~3;
}

// Floats of a decode block's staged weights after its stage region, where
// RESIDENT: the control region (the layers' barriers) and the five
// layers' packed values; none where the weights are read from L2.
template <int KIND>
__host__ __device__ inline int decode_weight_floats(const encfma::Dims& d) {
  return KIND == tilemma::RESIDENT
             ? (tilemma::CTRL_BYTES + 2 * (int)encmma::packed(d).total) / 4
             : 0;
}

// Floats of one tile in the store: log_obs (tile * K), log_A
// (tile * K * K), the backpointer words (tile).
__host__ __device__ inline int tile_floats(int K, int tile) {
  return tile * (K + K * K + 1);
}

// Floats of the chunk through which the fold stages the products of a
// group of its chunks, and the reverse pass the selector maps (that many
// at a time): the products of the 64 segments of a one-level fold, and
// at least 2048 (at K = 3 the 146 segments of T = 2327 in one load).
__host__ __device__ inline int chunk_floats(int K) {
  return 64 * K * K > 2048 ? 64 * K * K : 2048;
}

// Floats of a decode block's scratch for the fold and the reverse pass:
// the chunk, then 32 chunk products and 32 chunk deltas (one each a lane
// of the first warp), then the reverse pass's 2 * 32 + 1 words.
__host__ __device__ inline int scratch_floats(int K) {
  return chunk_floats(K) + 32 * (K * K + K) + 68;
}

// Threads a decode block at most: with __launch_bounds__(DECODE_THREADS,
// 2) a thread keeps up to 102 registers (at the 64 of kernel 11 the
// scan's state spilled) and two blocks share an SM.
constexpr int DECODE_THREADS = 320;

// Dynamic shared memory of a decode block holding ntb tiles: the stage,
// the staged weights, the tile store, the scratch.
template <bool BF16, int KIND>
inline long long decode_smem(const encfma::Dims& d, int tile, int ntb) {
  return 4LL * (decode_stage_floats<BF16>(d, tile) +
                decode_weight_floats<KIND>(d) +
                (long long)ntb * tile_floats(d.K, tile) + scratch_floats(d.K));
}

// One tile's place: sequence b, first step t0, n steps.
struct TileAt {
  int b, t0, n;
};

__device__ __forceinline__ TileAt tile_at(int unit, int tiles, int tile,
                                          int T) {
  TileAt at;
  at.b = unit / tiles;
  at.t0 = (unit - at.b * tiles) * tile;
  at.n = min(tile, T - at.t0);
  return at;
}

// One tile's evidence as kernel 11 computes it in the mode, from the stage
// region at smem into the store: so (n * K) and sa (n * K * K).  No
// barrier after the write.
template <bool BF16>
__device__ __forceinline__ void tile_evidence(
    float* smem, const float* __restrict__ x, const float* __restrict__ u,
    long long u_sb, long long u_sc, long long u_st, const encfma::Weights& W,
    const encfma::Dims& d, int T, int tile, const TileAt& at, int vt,
    float* so, float* sa) {
  if constexpr (BF16) {
    const encmma::Ops s =
        encmma::carve(reinterpret_cast<unsigned char*>(smem), d, tile);
    const tilemma::bf16* wp = reinterpret_cast<const tilemma::bf16*>(W.wp);
    encmma::encoder_stage(x + (size_t)at.b * d.C * T, wp, W.eb1, W.eb2, d,
                          T, at.t0, at.n, vt, s, encmma::raw_logits(s));
    encmma::prior_stage(u + at.b * u_sb, u_sc, u_st, wp, W.pb1, d, T, at.t0,
                        at.n, s);
    const encfma::Rows r = tile_rows(s);
    tile_log_softmax(r, W, d.K, at.n, s.WS, 0, d.K + 1);
    write_tile(r, d.K, at.n, s.WS, so, sa);
  } else {
    const int WS = encfma::row_stride(tile);
    const encfma::Rows s = encfma::carve(smem, d, WS);
    tilefma::Pipe pipe{smem, 0, false};
    encfma::encoder_stage(x + (size_t)at.b * d.C * T, W, d, T, at.t0, at.n,
                          WS, vt, s, pipe, encfma::prior_first(W, d));
    encfma::prior_stage(u + at.b * u_sb, u_sc, u_st, W, d, at.t0, at.n, WS,
                        s, pipe);
    tile_log_softmax(s, W, d.K, at.n, WS, 0, d.K + 1);
    write_tile(s, d.K, at.n, WS, so, sa);
  }
}

// The five layers of the evidence as a chain of tile_mma.cuh's staged
// layers: the encoder's 0-2, the prior's 3-4 (fused_evidence_bf16_staged_
// kernel's chain), each computed from the widths where it is asked for, so
// that nothing of the chain stays live in registers across the kernel.
struct EvidenceChain {
  const encfma::Dims& d;
  __device__ __forceinline__ tilemma::ChainLayer operator()(int l) const {
    const encmma::Packed at = encmma::packed(d);
    switch (l) {
      case 0: return tilemma::ChainLayer{at.w1, d.H1, d.C, 3, 1, 1};
      case 1: return tilemma::ChainLayer{at.w2, d.H2, d.H1, 3, 2, 2};
      case 2: return tilemma::ChainLayer{at.w3, d.K, d.H2, 1, 2, 2};
      case 3: return tilemma::ChainLayer{at.p1, d.HP, d.U, 1, 2, 2};
      case 4: return tilemma::ChainLayer{at.p2, d.K * d.K, d.HP, 1, 2, 2};
      default: return tilemma::ChainLayer{0, 0, 0, 0, 0, 0};
    }
  }
};

// One tile's evidence as tile_evidence<true> computes it, each layer's
// weights read from the block's resident copy (tile_mma.cuh::staged_layer):
// x and u staged together, then the five layers, the log-softmax and the
// write into the store.  The sums are tile_evidence's, so are the bits.
// No barrier after the write.
__device__ __forceinline__ void staged_tile_evidence(
    tilemma::Staged& st, const EvidenceChain& chain, float* smem,
    const float* __restrict__ x, const float* __restrict__ u,
    long long u_sb, long long u_sc, long long u_st, const encfma::Weights& W,
    const encfma::Dims& d, int T, int tile, const TileAt& at, int vt,
    float* so, float* sa) {
  using tilemma::Out;
  constexpr int R = tilemma::RESIDENT;
  const encmma::Ops s =
      encmma::carve(reinterpret_cast<unsigned char*>(smem), d, tile);
  const int Wn = at.n + 2 * encfma::HALO;
  const int p0 = at.t0 - encfma::HALO;
  const tilemma::Win win{p0, T, at.t0, at.n};
  tilemma::stage_item<R>(st, chain, Wn, p0);
  // x on the whole window, zero outside [0, T) and past the bound and in
  // the padding channels; u on the tile's own steps; both rounded
  const float* xb = x + (size_t)at.b * d.C * T;
  const float* ub = u + at.b * u_sb;
  const int C16 = tilemma::round16(d.C);
  for (int idx = threadIdx.x; idx < C16 * Wn; idx += blockDim.x) {
    const int c = idx / Wn, j = idx - c * Wn;
    const int p = p0 + j;
    const float v = (c < d.C && !encfma::outside(p, T, vt))
                        ? xb[(size_t)c * T + p] : 0.f;
    s.xo[j * s.RC + c] = __float2bfloat16_rn(v);
  }
  const int U16 = tilemma::round16(d.U);
  for (int idx = threadIdx.x; idx < U16 * at.n; idx += blockDim.x) {
    const int c = idx / at.n, j = idx - c * at.n;
    const float v =
        c < d.U ? ub[c * u_sc + (long long)(at.t0 + j) * u_st] : 0.f;
    s.uo[(encfma::HALO + j) * s.RU + c] = __float2bfloat16_rn(v);
  }
  __syncthreads();
  // h1 = relu(conv1(x)), zero outside the sequence and past the bound;
  // h2 = relu(conv2(h1)) on the tile, not masked; the raw logits; hp =
  // relu(fc1(u)) on the tile; the raw transition logits
  tilemma::staged_layer<3, R>(st, chain, 0, s.xo, s.RC, s.NR,
                              Out{W.eb1, true, true, vt, nullptr, nullptr,
                                  nullptr, 0, s.a, s.RG}, win);
  tilemma::staged_layer<3, R>(st, chain, 1, s.a, s.RG, s.NR,
                              Out{W.eb2, true, false, T, nullptr, nullptr,
                                  nullptr, 0, s.b, s.RG}, win);
  tilemma::staged_layer<1, R>(st, chain, 2, s.b, s.RG, s.NR,
                              encmma::raw_logits(s), win);
  tilemma::staged_layer<1, R>(st, chain, 3, s.uo, s.RU, s.NR,
                              Out{W.pb1, true, false, T, nullptr, nullptr,
                                  nullptr, 0, s.a, s.RG}, win);
  tilemma::staged_layer<1, R>(st, chain, 4, s.a, s.RG, s.NR,
                              Out{nullptr, false, false, T, nullptr, nullptr,
                                  s.ap, s.WS, nullptr, 0}, win);
  const encfma::Rows r = tile_rows(s);
  tile_log_softmax(r, W, d.K, at.n, s.WS, 0, d.K + 1);
  write_tile(r, d.K, at.n, s.WS, so, sa);
}

// KIND: where the evidence's weights are, DIRECT (read from L2, each
// tile through tile_evidence) or, in the bfloat16 mode, RESIDENT (staged
// once a block after the stage region, staged_tile_evidence; blocks of
// encmma::THREADS, up to 128 registers a thread: at the DIRECT instances'
// 96 it spilled).  Nothing of RESIDENT's is compiled into a DIRECT
// instance, whose code is the first design's.
template <int K, bool BF16, int KIND>
__global__ void __launch_bounds__(
    KIND == tilemma::RESIDENT ? encmma::THREADS : DECODE_THREADS, 2)
    fused_decode_kernel(const float* __restrict__ x,
                        const float* __restrict__ u, long long u_sb,
                        long long u_sc, long long u_st,
                        const int* __restrict__ lengths, encfma::Weights W,
                        const float* __restrict__ log_pi, float* agg,
                        unsigned* sel, int* ends, int* __restrict__ states,
                        encfma::Dims d, int B, int T, int tile, int tiles,
                        int ntb) {
  extern __shared__ __align__(16) float smem[];
  namespace cg = cooperative_groups;
  cg::grid_group grid = cg::this_grid();
  constexpr int KK = K * K;
  constexpr int AG = KK + K;          // scratch floats a segment
  const int tf = tile_floats(K, tile);
  float* store = smem + decode_stage_floats<BF16>(d, tile);
  if constexpr (KIND == tilemma::RESIDENT)
    store += decode_weight_floats<KIND>(d);
  float* chunk = store + ntb * tf;
  const int S = mpscan::seg_len(T), G = mpscan::num_segments(T);
  const int units = B * tiles;
  const int vt = batch_bound(lengths, B, T);
  // RESIDENT: the five layers' bulk copies, the first two in flight while
  // the first tile's x and u are staged
  tilemma::Staged st;
  if constexpr (KIND == tilemma::RESIDENT) {
    unsigned char* w = reinterpret_cast<unsigned char*>(
        smem + decode_stage_floats<BF16>(d, tile));
    st.wp = reinterpret_cast<const tilemma::bf16*>(W.wp);
    st.bar = reinterpret_cast<uint64_t*>(w);
    st.ring_chain = nullptr;
    st.sw = reinterpret_cast<tilemma::bf16*>(w + tilemma::CTRL_BYTES);
    st.slots = 0;
    st.l0 = 0;
    st.l1 = 5;
    tilemma::stage_start<KIND>(st, EvidenceChain{d});
  }

  // the evidence of each tile, then (a) on its segments
  for (int k = 0; k < ntb; ++k) {
    const int unit = blockIdx.x + k * gridDim.x;
    if (unit >= units) break;
    const TileAt at = tile_at(unit, tiles, tile, T);
    float* so = store + k * tf;
    float* sa = so + tile * K;
    if constexpr (KIND == tilemma::RESIDENT)
      staged_tile_evidence(st, EvidenceChain{d}, smem, x, u, u_sb, u_sc,
                           u_st, W, d, T, tile, at, vt, so, sa);
    else
      tile_evidence<BF16>(smem, x, u, u_sb, u_sc, u_st, W, d, T, tile, at,
                          vt, so, sa);
    __syncthreads();
    unsigned* sb = reinterpret_cast<unsigned*>(sa + tile * KK);
    const int L = lengths ? lengths[at.b] : T;
    for (int i = threadIdx.x; i * S < at.n; i += blockDim.x) {
      const int gs = at.t0 + i * S, g = gs / S, gn = min(S, T - gs);
      const float* a = sa + i * S * KK;
      const float* o = so + i * S * K;
      float* ab = agg + (size_t)at.b * G * AG;
      if (g == 0) {
        float dd[K];
        mpscan::seed<K>(dd, log_pi, o, L);
        mpscan::segment_rerun<K>(dd, a + KK, KK, o + K, 1, gn - 1, L, sb + 1);
        // delta_{T-1} where G == 1, else the incoming delta of segment 1
        float* dst = G == 1 ? ab : ab + AG + KK;
#pragma unroll
        for (int j = 0; j < K; ++j) dst[j] = dd[j];
      } else if (g < G - 1) {
        mpscan::segment_product<K>(a, KK, o, gs, gn, L, ab + (size_t)g * AG);
      }
    }
  }
  grid.sync();

  // (b) the fold of each sequence, on the first warp of one block, a
  // group of up to 32 of its chunks (maxplus_scan.cuh::fold_chunk) at a
  // time, a chunk a lane: the group's products staged into the chunk;
  // (b1) each chunk's product but the last chunk's; (b2) on the first lane
  // the chunks' incoming deltas, folded over the chunk products; (b3) each
  // chunk's incoming deltas, folded over its own products
  const int nchunk = chunk_floats(K);
  float* qbuf = chunk + nchunk;
  float* cin = qbuf + 32 * KK;
  if (threadIdx.x < 32 && G >= 3)
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
      float* ab = agg + (size_t)b * G * AG;
      const int C = mpscan::fold_chunk(G), nc = (G + C - 1) / C;
      const int per = min(32, nchunk / (C * KK));
      const int lane = threadIdx.x;
      float x[K];
#pragma unroll
      for (int j = 0; j < K; ++j) x[j] = __ldcg(ab + AG + KK + j);
      for (int c0 = 0; c0 < nc; c0 += per) {
        const int c1 = min(nc, c0 + per);
        const int g0 = max(1, c0 * C), g1 = min(c1 * C, G - 1);
        for (int idx = lane; idx < (g1 - g0) * KK; idx += 32) {
          const int i = idx / KK;
          chunk[idx] = __ldcg(ab + (size_t)(g0 + i) * AG + (idx - i * KK));
        }
        __syncwarp();
        const int c = c0 + lane;
        const int first = max(1, c * C), end = min(c * C + C, G);
        if (c < nc - 1 && c < c1) {
          float Q[K][K];
#pragma unroll
          for (int i = 0; i < K; ++i)
#pragma unroll
            for (int j = 0; j < K; ++j) Q[i][j] = chunk[(first - g0) * KK + i * K + j];
          for (int g = first + 1; g < end; ++g)
#pragma unroll
            for (int i = 0; i < K; ++i)
              mpscan::fold<K>(Q[i], chunk + (g - g0) * KK);
#pragma unroll
          for (int i = 0; i < K; ++i)
#pragma unroll
            for (int j = 0; j < K; ++j) qbuf[lane * KK + i * K + j] = Q[i][j];
        }
        __syncwarp();
        if (lane == 0)
          for (int cc = c0; cc < c1; ++cc) {
#pragma unroll
            for (int j = 0; j < K; ++j) cin[(cc - c0) * K + j] = x[j];
            if (cc < nc - 1) mpscan::fold<K>(x, qbuf + (cc - c0) * KK);
          }
        __syncwarp();
        if (c < c1) {
          float y[K];
#pragma unroll
          for (int j = 0; j < K; ++j) y[j] = cin[lane * K + j];
          for (int g = first; g < end; ++g) {
            float* in = ab + (size_t)g * AG + KK;
#pragma unroll
            for (int j = 0; j < K; ++j) in[j] = y[j];
            if (g + 1 < end) mpscan::fold<K>(y, chunk + (g - g0) * KK);
          }
        }
        __syncwarp();
      }
    }
  grid.sync();

  // (c) the rerun of each tile's segments 1..
  for (int k = 0; k < ntb; ++k) {
    const int unit = blockIdx.x + k * gridDim.x;
    if (unit >= units) break;
    const TileAt at = tile_at(unit, tiles, tile, T);
    const float* so = store + k * tf;
    const float* sa = so + tile * K;
    unsigned* sb = reinterpret_cast<unsigned*>(store + k * tf + tile * (K + KK));
    const int L = lengths ? lengths[at.b] : T;
    float* ab = agg + (size_t)at.b * G * AG;
    for (int i = threadIdx.x; i * S < at.n; i += blockDim.x) {
      const int gs = at.t0 + i * S, g = gs / S, gn = min(S, T - gs);
      if (g == 0) continue;
      float dd[K];
#pragma unroll
      for (int j = 0; j < K; ++j) dd[j] = __ldcg(ab + (size_t)g * AG + KK + j);
      sel[(size_t)at.b * G + g] = mpscan::segment_rerun<K>(
          dd, sa + i * S * KK, KK, so + i * S * K, gs, gn, L, sb + i * S);
      if (g == G - 1) {
#pragma unroll
        for (int j = 0; j < K; ++j) ab[(size_t)g * AG + j] = dd[j];
      }
    }
  }
  grid.sync();

  // (d) the final state of each sequence, then its segments' end states,
  // on the first warp of one block, the selector maps staged a chunk at a
  // time
  unsigned* rev = reinterpret_cast<unsigned*>(cin + 32 * K);
  if (threadIdx.x < 32)
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
      const float* fin = agg + ((size_t)b * G + G - 1) * AG;
      unsigned* words = reinterpret_cast<unsigned*>(chunk);
      int* eb = ends + (size_t)b * G;
      int st = 0;
      if (threadIdx.x == 0) {
        float dd[K], best;
#pragma unroll
        for (int j = 0; j < K; ++j) dd[j] = __ldcg(fin + j);
        st = mpscan::first_argmax<K>(dd, &best);
        eb[G - 1] = st;
      }
      for (int hi = G - 1; hi >= 1; hi -= nchunk) {
        const int lo = max(1, hi - nchunk + 1);
        for (int i = threadIdx.x; i <= hi - lo; i += 32)
          words[i] = __ldcg(sel + (size_t)b * G + lo + i);
        __syncwarp();
        const int nl = mpscan::reverse_threads(hi - lo + 1, 32);
        st = mpscan::reverse_pass<K>(words, lo, hi, st, threadIdx.x, nl, rev,
                                     reinterpret_cast<int*>(rev + nl), eb,
                                     [] { __syncwarp(); });
      }
    }
  grid.sync();

  // (e) each tile's backtrace
  for (int k = 0; k < ntb; ++k) {
    const int unit = blockIdx.x + k * gridDim.x;
    if (unit >= units) break;
    const TileAt at = tile_at(unit, tiles, tile, T);
    const unsigned* sb =
        reinterpret_cast<const unsigned*>(store + k * tf + tile * (K + KK));
    for (int i = threadIdx.x; i * S < at.n; i += blockDim.x) {
      const int gs = at.t0 + i * S;
      mpscan::segment_backtrace(__ldcg(ends + (size_t)at.b * G + gs / S),
                                sb + i * S, min(S, T - gs),
                                states + (size_t)at.b * T + gs);
    }
  }
}

// The decode's launch plan at tile width `tile` for the instance KIND:
// the fewest tiles a block (ntb) for which the resident blocks (the
// runtime's occupancy of this kernel at that shared memory, on every SM)
// cover the B * ceil(T / tile) tiles.  out = {grid, ntb, threads, smem}.
template <int K, bool BF16, int KIND>
cudaError_t decode_plan(const encfma::Dims& d, int B, int T, int tile,
                        int* out) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fused_decode_kernel<K, BF16, KIND>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               encfma::SMEM_LIMIT);
  if (err != cudaSuccess) return err;
  int G = d.H1 > d.H2 ? d.H1 : d.H2;
  G = G > d.HP ? G : d.HP;
  const int threads = BF16 ? encmma::THREADS
                           : encfma::block_threads(tile, G, DECODE_THREADS);
  const long long units = (long long)B * ((T + tile - 1) / tile);
  for (int ntb = 1;; ++ntb) {
    const long long smem = decode_smem<BF16, KIND>(d, tile, ntb);
    if (smem > encfma::SMEM_LIMIT) return cudaErrorInvalidValue;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_decode_kernel<K, BF16, KIND>, threads, (size_t)smem);
    if (err != cudaSuccess) return err;
    if ((long long)per_sm * sms * ntb >= units) {
      out[0] = (int)((units + ntb - 1) / ntb);
      out[1] = ntb;
      out[2] = threads;
      out[3] = (int)smem;
      return cudaSuccess;
    }
  }
}

// The decode's design and plan: the first design's (the weights read from
// L2); in the bfloat16 mode where `staged`, the second's (RESIDENT) where
// its blocks, holding the weights too, still cover every tile at the
// first design's tiles a block, so that staging raises no ntb and refuses
// no shape the first design takes.  out = {grid, ntb, threads, smem,
// kind}.
template <int K, bool BF16>
cudaError_t decode_choice(const encfma::Dims& d, int B, int T, int tile,
                          bool staged, int* out) {
  const cudaError_t err =
      decode_plan<K, BF16, tilemma::DIRECT>(d, B, T, tile, out);
  out[4] = tilemma::DIRECT;
  if constexpr (BF16) {
    int s[4];
    if (err == cudaSuccess && staged &&
        decode_plan<K, true, tilemma::RESIDENT>(d, B, T, tile, s) ==
            cudaSuccess &&
        s[1] == out[1]) {
      for (int i = 0; i < 4; ++i) out[i] = s[i];
      out[4] = tilemma::RESIDENT;
    }
  }
  return err;
}

template <int K, bool BF16>
cudaError_t launch_decode(const float* x, const float* u, long long u_sb,
                          long long u_sc, long long u_st, const int* lengths,
                          encfma::Weights W, const float* log_pi, float* agg,
                          unsigned* sel, int* ends, int* states,
                          encfma::Dims d, int B, int T, int tile, bool staged,
                          cudaStream_t stream) {
  int plan[5];
  const cudaError_t err = decode_choice<K, BF16>(d, B, T, tile, staged, plan);
  if (err != cudaSuccess) return err;
  int tiles = (T + tile - 1) / tile, ntb = plan[1];
  void* args[] = {(void*)&x,       (void*)&u,    (void*)&u_sb,
                  (void*)&u_sc,    (void*)&u_st, (void*)&lengths,
                  (void*)&W,       (void*)&log_pi, (void*)&agg,
                  (void*)&sel,     (void*)&ends, (void*)&states,
                  (void*)&d,       (void*)&B,    (void*)&T,
                  (void*)&tile,    (void*)&tiles, (void*)&ntb};
  const void* kernel = (const void*)fused_decode_kernel<K, BF16,
                                                       tilemma::DIRECT>;
  if constexpr (BF16)
    if (plan[4] == tilemma::RESIDENT)
      kernel = (const void*)fused_decode_kernel<K, true, tilemma::RESIDENT>;
  return cudaLaunchCooperativeKernel(kernel, dim3(plan[0]), dim3(plan[2]),
                                     args, (size_t)plan[3], stream);
}

}  // namespace

// Dynamic shared memory of an evidence block at tile width `tile`; bf16:
// the bfloat16-operand mode's, its weights where evidence_stage puts them
// (staged: in shared memory where they fit; else read from L2).
extern "C" int vqhmm_fused_evidence_smem_bytes(int C, int H1, int H2, int K,
                                               int U, int HP, int tile,
                                               int bf16, int staged) {
  const encfma::Dims d{C, H1, H2, K, U, HP};
  return bf16 ? evidence_stage(d, tile, staged != 0).bytes
              : encfma::smem_bytes(d, tile);
}

// packed_weights: vqhmm_encoder_pack's layout with the prior (HP > 0), in
// the same mode; lengths may be null.  bf16: the bfloat16-operand mode,
// which stages no weights in slabs (no weight-buffer bound); staged: its
// weights in shared memory where they fit (evidence_stage), else read from
// L2; inert: the tiles that start at or past their sequence's length left
// inert (see Semantics), for a consumer that masks them as the Viterbi
// scan does.
extern "C" int vqhmm_fused_evidence(
    const float* x, const float* u, long long u_sb, long long u_sc,
    long long u_st, const int* lengths, const void* packed_weights,
    const float* eb1, const float* eb2, const float* eb3, const float* pb1,
    const float* pb2, float* log_obs, float* log_A, int B, int C, int T,
    int U, int H1, int H2, int K, int HP, int tile, int split, int bf16,
    int staged, int inert, void* stream) {
  const encfma::Dims d{C, H1, H2, K, U, HP};
  const int smem = vqhmm_fused_evidence_smem_bytes(C, H1, H2, K, U, HP, tile,
                                                   bf16, staged);
  if (!encfma::tile_ok(tile) || B <= 0 || T <= 0 || U <= 0 || HP <= 0 ||
      K <= 0 || !(bf16 || encfma::layers_fit(d)) ||
      smem > encfma::SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const int tiles = (T + tile - 1) / tile;
  const long long blocks = (long long)tiles * B * (split ? 2 : 1);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const int kind = evidence_stage(d, tile, staged != 0).kind;
  const void* kernel =
      !bf16 ? (const void*)fused_evidence_kernel
      : kind == tilemma::RESIDENT
          ? (const void*)fused_evidence_bf16_staged_kernel<tilemma::RESIDENT>
      : kind == tilemma::RING
          ? (const void*)fused_evidence_bf16_staged_kernel<tilemma::RING>
          : (const void*)fused_evidence_bf16_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const encfma::Weights W{reinterpret_cast<const float*>(packed_weights),
                          eb1, eb2, eb3, pb1, pb2};
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
#define VQHMM_EVIDENCE_BF16(KERNEL)                                       \
  KERNEL<<<(unsigned)blocks, encmma::THREADS, smem, st>>>(                 \
      x, u, u_sb, u_sc, u_st, lengths, W, log_obs, log_A, d, B, T, tile,   \
      tiles, split ? 1 : 0, inert ? 1 : 0)
    if (kind == tilemma::RESIDENT)
      VQHMM_EVIDENCE_BF16(fused_evidence_bf16_staged_kernel<tilemma::RESIDENT>);
    else if (kind == tilemma::RING)
      VQHMM_EVIDENCE_BF16(fused_evidence_bf16_staged_kernel<tilemma::RING>);
    else
      VQHMM_EVIDENCE_BF16(fused_evidence_bf16_kernel);
#undef VQHMM_EVIDENCE_BF16
  } else {
    int G = H1 > H2 ? H1 : H2;
    G = G > HP ? G : HP;
    fused_evidence_kernel<<<(unsigned)blocks, encfma::block_threads(tile, G),
                            smem, st>>>(x, u, u_sb, u_sc, u_st, lengths, W,
                                        log_obs, log_A, d, B, T, tile, tiles,
                                        split ? 1 : 0, inert ? 1 : 0);
  }
  return (int)cudaGetLastError();
}

#define VQHMM_DECODE_SWITCH(CALL)                                        \
  switch (K) {                                                           \
    case 1: return (int)CALL(1);                                         \
    case 2: return (int)CALL(2);                                         \
    case 3: return (int)CALL(3);                                         \
    case 4: return (int)CALL(4);                                         \
    case 5: return (int)CALL(5);                                         \
    case 6: return (int)CALL(6);                                         \
    case 7: return (int)CALL(7);                                         \
    case 8: return (int)CALL(8);                                         \
    default: return (int)cudaErrorInvalidValue;                          \
  }

// bf16: the bfloat16 mode, which stages no weights in slabs (no
// weight-buffer bound).
static bool decode_dims_ok(const encfma::Dims& d, int B, int T, int tile,
                           bool bf16) {
  return encfma::tile_ok(tile) && B > 0 && T > 0 && d.U > 0 && d.HP > 0 &&
         (bf16 || encfma::layers_fit(d)) && (long long)B * T <= INT_MAX;
}

// The decode's design and plan for the current device in either mode
// (decode_choice; staged 0: the first design's alone): out = {grid, ntb,
// threads, smem, kind}; an error where no number of tiles a block fits a
// block's shared memory with every tile resident.
extern "C" int vqhmm_fused_decode_plan(int B, int C, int T, int U, int H1,
                                       int H2, int K, int HP, int tile,
                                       int bf16, int staged, int* out) {
  const encfma::Dims d{C, H1, H2, K, U, HP};
  if (!decode_dims_ok(d, B, T, tile, bf16)) return (int)cudaErrorInvalidValue;
#define VQHMM_PLAN(KV)                                                  \
  (bf16 ? decode_choice<KV, true>(d, B, T, tile, staged != 0, out)      \
        : decode_choice<KV, false>(d, B, T, tile, false, out))
  VQHMM_DECODE_SWITCH(VQHMM_PLAN)
#undef VQHMM_PLAN
}

// packed_weights as for the evidence, in the same mode; lengths may be
// null; agg a scratch of B * G * (K * K + K) floats, sel and ends of B * G
// words (G the segments of maxplus_scan.cuh).  K is bounded by the 4-bit
// backpointers and the template instances.  staged: the design
// vqhmm_fused_decode_plan chooses; 0: the first design.
extern "C" int vqhmm_fused_decode(
    const float* x, const float* u, long long u_sb, long long u_sc,
    long long u_st, const int* lengths, const void* packed_weights,
    const float* eb1, const float* eb2, const float* eb3, const float* pb1,
    const float* pb2, const float* log_pi, float* agg, unsigned* sel,
    int* ends, int* states, int B, int C, int T, int U, int H1, int H2, int K,
    int HP, int tile, int bf16, int staged, void* stream) {
  const encfma::Dims d{C, H1, H2, K, U, HP};
  if (!decode_dims_ok(d, B, T, tile, bf16)) return (int)cudaErrorInvalidValue;
  const encfma::Weights W{reinterpret_cast<const float*>(packed_weights),
                          eb1, eb2, eb3, pb1, pb2};
  cudaStream_t st = (cudaStream_t)stream;
#define VQHMM_LAUNCH(KV)                                                     \
  (bf16 ? launch_decode<KV, true>(x, u, u_sb, u_sc, u_st, lengths, W, log_pi, \
                                  agg, sel, ends, states, d, B, T, tile,      \
                                  staged != 0, st)                            \
        : launch_decode<KV, false>(x, u, u_sb, u_sc, u_st, lengths, W,        \
                                   log_pi, agg, sel, ends, states, d, B, T,   \
                                   tile, false, st))
  VQHMM_DECODE_SWITCH(VQHMM_LAUNCH)
#undef VQHMM_LAUNCH
}
