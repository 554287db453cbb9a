// Tensor-core layers over a time window held in shared memory: the
// building block of the training step's bfloat16 mode (fused_train.cu), in
// which both operands of every product are bfloat16 and the sums float32.
//
// A layer is out[o][j] = sum_{k,i} w[o][i][k] * in[i][j - TAPS/2 + k] over
// window positions j in [lo, hi), TAPS = 3 (a k=3 convolution) or 1 (a 1x1
// convolution or a dense product), computed as an implicit GEMM with
// mma.sync.m16n8k16 (bf16 x bf16 -> f32): M the output channels, N the
// window's steps, the reduction over (tap, input channel) in chunks of 16,
// tap-major (chunk c = tap k, input channels [16 g, 16 g + 16)).
//
// Layouts:
//  * the operand of a layer (its input activation) is bfloat16 in shared
//    memory, time-major: in[j * RS + i], RS = op_stride(I) values a row.  A
//    tap is then a row offset into the same buffer, and the 8 x 8 blocks an
//    ldmatrix reads are 16-byte rows; RS * 2 bytes is an odd multiple of 16,
//    so the 8 rows of a block fall on distinct banks.  Channels [I,
//    round16(I)) of every row a valid output reads are zero (the previous
//    layer's epilogue writes them), so the zero-padded weights meet zeros;
//  * the weights are packed once a call by the caller's pack kernel
//    (pack_fragments), rounded to bfloat16, in the order the mma's A
//    operand takes them: for each m-tile of 16 output channels, each chunk
//    is one 512-byte fragment, 16 bytes a lane, so a warp loads a fragment
//    as one coalesced 16-byte load a lane (from L1 or L2: no staging, no
//    barrier within a layer; the inference kernels stage them in shared
//    memory instead, staged_layer below).  Outputs [O, round16(O)) have
//    zero weights;
//  * a warp owns an item of 16 output channels (an m-tile) x up to 48
//    steps (MMA_PAIRS pairs of n-tiles of 8) and keeps its float32 sums in
//    registers over the whole reduction, so a weight fragment is loaded
//    once a block where a layer's window fits one item (a tile of 32
//    steps), and feeds up to six mma; the fragments are loaded two
//    chunks ahead.  Where a layer has fewer m-tiles than the block has
//    warps, its window is split over more items so that every warp works.
//    (Items of up to 80 steps were slower on the card: more registers, a
//    longer epilogue.)
//
// The epilogue (Out) works on the float32 sums: it adds the bias in
// float32, applies the ReLU, the masks and the gate exactly as the float32
// kernels' finish() does, and writes the value where it is needed: the
// scratch rows of the block's own steps, float32 rows in shared memory
// (for a softmax or the NLL), and the next layer's bfloat16 operand.
//
// Each output's sum is a fixed sequence: the chunks in order, each chunk's
// 16 products summed by one mma from zero and its float32 partial sum
// added to the output's (mma_chunk), so a call repeats bit for bit; the
// order inside an mma is the tensor core's own.  A product of two bfloat16 values is exact in
// float32, so the mode differs from its plain version only in the order of
// the float32 sums.
//
// pack_fragments also packs the transposed layer (the gradient with
// respect to the layer's input): output channel a and input channel b of
// the transposed layer read w[b][a][TAPS - 1 - k], as tile_fma.cuh's
// pack_weights does.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace tilemma {

using bf16 = __nv_bfloat16;

__host__ __device__ inline int round16(int n) { return (n + 15) & ~15; }

// bfloat16 values a row of an operand buffer of n channels: the channels
// rounded up to a chunk, and 8 more, so that a row is an odd number of
// 16-byte words.
__host__ __device__ inline int op_stride(int n) { return round16(n) + 8; }

// bfloat16 values of a packed layer: round16(O) x taps x round16(I).
__host__ __device__ inline long long packed_elems(int O, int I, int taps) {
  return (long long)round16(O) * taps * round16(I);
}

// The (output channel o, input channel i, tap k) of value `local` of a
// layer packed for the mma: fragment f = m-tile * chunks + chunk holds 256
// values, 8 a lane; value e of lane l is the A operand's a_e of
// mma.m16n8k16 (PTX ISA: row groupID + 8 for a2, a3, a6, a7; column
// 2 threadID_in_group + (e & 1), + 8 for e >= 4).
__host__ __device__ inline void fragment_entry(long long local, int I,
                                               int taps, int& o, int& i,
                                               int& k) {
  const int groups = round16(I) >> 4;
  const int chunks = taps * groups;
  const long long f = local >> 8;
  const int lane = (int)(local >> 3) & 31, e = (int)local & 7;
  const int mt = (int)(f / chunks), c = (int)(f - (long long)mt * chunks);
  k = c / groups;
  const int g = c - k * groups;
  o = 16 * mt + (lane >> 2) + 8 * ((e >> 1) & 1);
  i = 16 * g + 2 * (lane & 3) + (e & 1) + 8 * (e >> 2);
}

// One layer to pack: w the torch tensor (O, I, taps), or, with trans, the
// tensor (I, O, taps) of the layer whose transpose this is; `at` its first
// value in the packed buffer (a multiple of 256).
struct PackJob {
  const float* w;
  int O, I, taps, trans;
  long long at;
};

// dst[job.at + local] for every job, by the whole grid: the weights
// rounded to the nearest bfloat16 (ties to even, as XLA's convert rounds).
__device__ __forceinline__ void pack_fragments(const PackJob* jobs, int njobs,
                                               bf16* __restrict__ dst) {
  const PackJob& last = jobs[njobs - 1];
  const long long total = last.at + packed_elems(last.O, last.I, last.taps);
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    int ji = 0;
    while (ji + 1 < njobs && idx >= jobs[ji + 1].at) ++ji;
    const PackJob& job = jobs[ji];
    int o, i, k;
    fragment_entry(idx - job.at, job.I, job.taps, o, i, k);
    float v = 0.f;
    if (o < job.O && i < job.I)
      v = job.trans
              ? job.w[((size_t)i * job.O + o) * job.taps + (job.taps - 1 - k)]
              : job.w[((size_t)o * job.I + i) * job.taps + k];
    dst[idx] = __float2bfloat16_rn(v);
  }
}

// acc += A B for one chunk: the mma sums the chunk's 16 products from
// zero, and the chunk's float32 partial sum is added to acc with a
// float32 add (rounded to nearest).  The tensor core's own additions do
// not round to nearest: carried through a whole reduction they left the
// gradients 1.9x (the probe shape) to 23x ((8, 200)) further from the
// plain version than chunk partials do (NVIDIA H100).
__device__ __forceinline__ void mma_chunk(float (&acc)[4], const uint4& a,
                                          uint32_t b0, uint32_t b1) {
  float d[4];
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1),
        "f"(0.f));
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += d[e];
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// The block's window: window position 0 is time p0; the block's own steps
// are [t0, t0 + n); rows of the scratch are T floats.
struct Win {
  int p0, T, t0, n;
};

// Where a layer's outputs go, and what the epilogue does on the way:
// v = sum + bias[o] (bias may be null), through a ReLU if relu; zero where
// `mask` and the step lies outside [0, T) or at or past `limit`; zero where
// `gate` (scratch rows of T floats, the activation whose ReLU the gradient
// passes) is given and is not positive there (tile_fma.cuh's finish).
// Then v goes to dst (scratch rows of T floats, the block's own steps), to
// f32 (shared rows f32[o * WS + j]) and, rounded to bfloat16, to op (the
// next layer's operand, op[j * RS + o]), each where given.
struct Out {
  const float* bias;
  bool relu, mask;
  int limit;
  const float* gate;
  float* dst;
  float* f32;
  int WS;
  bf16* op;
  int RS;
};

// Two neighbouring floats of a row at `at`, at[0] and at[1] where ok0 and
// ok1, as one 8-byte access where both are wanted and the pair is aligned.
__device__ __forceinline__ float2 load2(const float* at, bool ok0, bool ok1) {
  if (ok0 && ok1 && (reinterpret_cast<uintptr_t>(at) & 7) == 0)
    return *reinterpret_cast<const float2*>(at);
  return make_float2(ok0 ? at[0] : 1.f, ok1 ? at[1] : 1.f);
}
__device__ __forceinline__ void store2(float* at, bool ok0, bool ok1,
                                       float v0, float v1) {
  if (ok0 && ok1 && (reinterpret_cast<uintptr_t>(at) & 7) == 0) {
    *reinterpret_cast<float2*>(at) = make_float2(v0, v1);
    return;
  }
  if (ok0) at[0] = v0;
  if (ok1) at[1] = v1;
}

// The epilogue of a pair of n-tiles: the 8 sums acc[q][e] a lane holds,
// output channel o0 + 8 (e / 2) (bias b[e / 2] already read) and window
// position j0 + 8 q + 2 (lane & 3) + (e & 1), stored where j lies in
// [lo, hi).  A lane's two neighbouring steps of a row are one 8-byte read
// of the gate and one 8-byte write of the scratch where aligned (the
// layer starts its n-tiles on an even step), so a warp's access to a row
// is one whole 32-byte sector; the gate values are all read before any
// value is stored, so the reads overlap.
__device__ __forceinline__ void emit_pair(const Out& y, const Win& w, int O,
                                          int lo, int hi, int o0, int j0,
                                          const float (&b)[2],
                                          const float (&acc0)[4],
                                          const float (&acc1)[4]) {
  const int lane = threadIdx.x & 31;
  float2 g[2][2];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = o0 + 8 * h;
      const int p = w.p0 + j0 + 8 * q + 2 * (lane & 3);
      g[q][h] = make_float2(1.f, 1.f);
      if (y.gate != nullptr && o < O)
        g[q][h] = load2(y.gate + (long long)o * w.T + p, p >= 0 && p < w.T,
                        p + 1 >= 0 && p + 1 < w.T);
    }
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = o0 + 8 * h;
      if (o >= O) continue;
      const int j = j0 + 8 * q + 2 * (lane & 3);
      float v[2];
      bool own[2];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int p = w.p0 + j + s;
        float x = (q == 0 ? acc0[2 * h + s] : acc1[2 * h + s]) + b[h];
        if (y.relu) x = fmaxf(x, 0.f);
        const bool inside = p >= 0 && p < w.T;
        if (y.mask && (!inside || p >= y.limit)) x = 0.f;
        if (!((s == 0 ? g[q][h].x : g[q][h].y) > 0.f)) x = 0.f;
        v[s] = x;
        const bool valid = j + s >= lo && j + s < hi;
        own[s] = valid && p >= w.t0 && p < w.t0 + w.n;
        if (!valid) continue;
        if (y.f32 != nullptr) y.f32[o * y.WS + j + s] = x;
        if (y.op != nullptr)
          y.op[(j + s) * y.RS + o] = __float2bfloat16_rn(x);
      }
      if (y.dst != nullptr)
        store2(y.dst + (long long)o * w.T + w.p0 + j, own[0], own[1], v[0],
               v[1]);
    }
}

// Zero the channels [n, round16(n)) of an operand's rows [lo, hi).
__device__ __forceinline__ void zero_pad(bf16* op, int RS, int n, int lo,
                                         int hi) {
  const int pad = round16(n) - n;
  for (int idx = threadIdx.x; idx < pad * (hi - lo); idx += blockDim.x) {
    const int j = lo + idx / pad;
    op[j * RS + n + idx % pad] = __float2bfloat16_rn(0.f);
  }
}

// Pairs of n-tiles (16 steps) a warp's item covers at most, and the weight
// fragments a warp keeps in flight.
constexpr int MMA_PAIRS = 3;
constexpr int AHEAD = 2;

// A weight fragment: from L2 (__ldg), or, with SMEM, from fragments
// staged in shared memory (a plain load).
template <bool SMEM>
__device__ __forceinline__ uint4 fragment(const uint4* at) {
  if constexpr (SMEM)
    return *at;
  else
    return __ldg(at);
}

// The whole layer, from the packed weights wp and the operand `in` (RS
// values a row, `rows` rows allocated), through the epilogue `y`.  Rows
// from 2 before lo to 15 past hi - 1 + TAPS/2 are read for the padded
// columns of the first and last n-tiles (never for a stored value); they
// are clamped to the allocation.  SMEM: wp points at the layer's
// fragments staged in shared memory (staged_layer), not at L2.
// Every thread of the block calls it; it ends with a __syncthreads.
template <int TAPS, bool SMEM = false>
__device__ __forceinline__ void layer(const bf16* __restrict__ wp, int O,
                                      int I, const bf16* in, int RS, int rows,
                                      int lo, int hi, const Out& y,
                                      const Win& win) {
  constexpr int H = TAPS / 2;
  const int mtiles = (O + 15) >> 4;
  const int groups = (I + 15) >> 4;
  const int chunks = TAPS * groups;
  // the n-tiles start on an even step (one column before lo where lo's
  // step is odd), so that a lane's two steps are an aligned pair
  const int first = lo - ((win.p0 + lo) & 1);
  const int pairs = (hi - first + 15) >> 4;     // pairs of n-tiles
  const int warps = blockDim.x >> 5;
  // the window in `split` items an m-tile, each of `per` pairs
  int split = (pairs + MMA_PAIRS - 1) / MMA_PAIRS;
  const int fill = (warps + mtiles - 1) / mtiles;
  if (split < fill) split = fill < pairs ? fill : pairs;
  const int per = (pairs + split - 1) / split;
  split = (pairs + per - 1) / per;
  const int lane = threadIdx.x & 31;
  // the row and channel offset this lane addresses for ldmatrix: matrix
  // lane / 8 is n-tile (lane / 16) of a pair, channels +8 for odd matrices
  const int bn = (lane & 7) + ((lane >> 4) << 3);
  const int bk = ((lane >> 3) & 1) << 3;
  const uint4* wf = reinterpret_cast<const uint4*>(wp);
  for (int item = threadIdx.x >> 5; item < mtiles * split; item += warps) {
    const int mt = item % mtiles, sp = item / mtiles;
    const int j0 = first + 16 * per * sp;
    const int np = min(per, pairs - per * sp);
    float acc[2 * MMA_PAIRS][4];
#pragma unroll
    for (int q = 0; q < 2 * MMA_PAIRS; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
    // the weight fragments of chunks c .. c + AHEAD - 1 in flight in a
    // ring of registers, each slot refilled right after its chunk's mma
    // (the loop unrolled over the ring, so that no register waits to be
    // moved: a ring that rotated its registers waited for each load in
    // turn)
    const uint4* a = wf + (size_t)mt * chunks * 32 + lane;
    // SMEM: the bias read before the reduction, off the chain's path
    float bias_ahead[2];
    if constexpr (SMEM) {
      const int o0 = 16 * mt + (lane >> 2);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        bias_ahead[h] = (y.bias != nullptr && o0 + 8 * h < O)
                            ? __ldg(y.bias + o0 + 8 * h)
                            : 0.f;
    }
    uint4 f[AHEAD];
#pragma unroll
    for (int s = 0; s < AHEAD; ++s)
      f[s] = s < chunks ? fragment<SMEM>(a + (size_t)s * 32)
                        : make_uint4(0, 0, 0, 0);
    int k = 0, g = 0;
    for (int c = 0; c < chunks; c += AHEAD) {
#pragma unroll
      for (int s = 0; s < AHEAD; ++s) {
        if (c + s < chunks) {
          const bf16* base = in + 16 * g + bk;
#pragma unroll
          for (int p = 0; p < MMA_PAIRS; ++p) {
            if (p < np) {
              const int r =
                  max(min(j0 + 16 * p + bn - H + k, rows - 1), 0);
              uint32_t b[4];
              ldmatrix_x4(b, base + (size_t)r * RS);
              mma_chunk(acc[2 * p], f[s], b[0], b[1]);
              mma_chunk(acc[2 * p + 1], f[s], b[2], b[3]);
            }
          }
          if (c + s + AHEAD < chunks)
            f[s] = fragment<SMEM>(a + (size_t)(c + s + AHEAD) * 32);
          if (++g == groups) {
            g = 0;
            ++k;
          }
        }
      }
    }
    const int o0 = 16 * mt + (lane >> 2);
    float b[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if constexpr (SMEM)
        b[h] = bias_ahead[h];
      else
        b[h] = (y.bias != nullptr && o0 + 8 * h < O)
                   ? __ldg(y.bias + o0 + 8 * h) : 0.f;
    }
#pragma unroll
    for (int p = 0; p < MMA_PAIRS; ++p)
      if (p < np)
        emit_pair(y, win, O, lo, hi, o0, j0 + 16 * p, b, acc[2 * p],
                  acc[2 * p + 1]);
  }
  if (y.op != nullptr) zero_pad(y.op, y.RS, O, lo, hi);
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Weights staged in shared memory ahead of a block's chain of layers: the
// inference kernels' bfloat16-operand mode (fused_infer.cu's kernel A,
// fused_decode.cu's kernel 11).
//
// layer() above reads each warp's fragments from L2, two chunks ahead, on
// the critical path of every layer, so a block that runs a chain of
// layers on one tile (a request at B = 1) waits for them layer after
// layer, and every item of a split window loads them again.  Here the
// Tensor Memory Accelerator copies them into shared memory:
//  * RESIDENT: at block start, before x is staged, one bulk copy a layer
//    (cp.async.bulk), all issued at once by thread 0, each completing on
//    the layer's own mbarrier; a layer waits only for its own fragments,
//    which arrive while x and the layers before it are computed, and
//    reads them from shared memory.  They stay for every item the block
//    takes (a persistent grid: weights staged once a block);
//  * RING: a chain whose fragments do not fit beside the operands streams
//    them through `slots` slots of SLOT_ELEMS values.  A unit is one chunk
//    of the m-tiles of one round of one layer: a round is `mr` consecutive
//    m-tiles (warps / split), an item each of their `split` parts of the
//    window, so a round's fragments of a chunk are one slot.  Thread 0
//    keeps `slots` units issued ahead of the unit the block consumes,
//    across layer boundaries; a slot is refilled once every warp has
//    arrived on its empty barrier;
//  * DIRECT: where not even two slots fit, layer() reads L2, as before.
// The sums are layer()'s: each output's float32 sum is the same sequence
// of chunk sums (mma_chunk, chunks tap-major) whichever warp computes it,
// so the three give one set of bits, bit-equal to layer() on L2.
// ---------------------------------------------------------------------------

enum WeightKind { DIRECT = 0, RESIDENT = 1, RING = 2 };

// layers of a chain at most (kernel A's seven)
constexpr int MAX_CHAIN = 7;
// a ring's slots at most, and the m-tiles a round at most (a block of
// eight warps: a round is warps / split m-tiles)
constexpr int RING_SLOTS = 8;
constexpr int RING_MTILES = 8;
constexpr int SLOT_ELEMS = RING_MTILES * 256;
// the control region: the barriers (one a layer, or full and empty a
// slot), then the ring's copy of the chain for its producer
constexpr int CTRL_BYTES = 8 * 2 * RING_SLOTS + 32 * 8;
// RESIDENT: the layers whose bulk copy is in flight ahead of the layer
// computing (the first two at block start): a block's copies spread over
// its chain, so that the blocks of a large grid, all starting at once, do
// not ask L2 for every block's every layer together
constexpr int COPY_AHEAD = 2;

// Where a block's dynamic shared memory puts the weights, after `base`
// bytes of operands (a multiple of 16): RESIDENT takes `prefetch` bytes
// of raw inputs, the control region and all `elems` packed values; else
// RING the control region and as many slots as fit, up to RING_SLOTS;
// else DIRECT, the operands alone.  bytes: the block's dynamic shared
// memory.
struct StagePlan {
  int kind, slots, bytes;
};

__host__ __device__ inline StagePlan stage_plan(long long base,
                                                long long prefetch,
                                                long long elems, int limit) {
  const long long resident = base + prefetch + CTRL_BYTES + 2 * elems;
  if (resident <= limit) return StagePlan{RESIDENT, 0, (int)resident};
  long long slots = (limit - base - CTRL_BYTES) / (2 * SLOT_ELEMS);
  slots = slots < RING_SLOTS ? slots : RING_SLOTS;
  if (slots >= 2)
    return StagePlan{RING, (int)slots,
                     (int)(base + CTRL_BYTES + slots * 2 * SLOT_ELEMS)};
  return StagePlan{DIRECT, 0, (int)base};
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// bytes (a multiple of 16) from device memory to shared memory, both
// 16-byte aligned, completing on `bar`'s transaction count
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One layer of a chain: its first value in the packed weights, widths,
// taps, and the window columns it computes, [lo, W - tail).
struct ChainLayer {
  long long at;
  int O, I, taps, lo, tail;
};

// How layer() splits a layer's window into items (its first column,
// pairs of n-tiles, pairs an item, items an m-tile), and the ring's
// rounds of it: mr m-tiles a round.  At most 5 pairs (a window of a tile
// of 64 and its halo), so split stays at most the block's warps.
struct Items {
  int mtiles, chunks, first, pairs, per, split, mr, rounds;
};

__device__ __forceinline__ Items items_of(const ChainLayer& l, int W, int p0,
                                          int warps) {
  Items it;
  it.mtiles = (l.O + 15) >> 4;
  it.chunks = l.taps * ((l.I + 15) >> 4);
  const int lo = l.lo, hi = W - l.tail;
  it.first = lo - ((p0 + lo) & 1);
  it.pairs = (hi - it.first + 15) >> 4;
  int split = (it.pairs + MMA_PAIRS - 1) / MMA_PAIRS;
  const int fill = (warps + it.mtiles - 1) / it.mtiles;
  if (split < fill) split = fill < it.pairs ? fill : it.pairs;
  it.per = (it.pairs + split - 1) / split;
  it.split = (it.pairs + it.per - 1) / it.per;
  it.mr = max(1, warps / it.split);
  it.rounds = (it.mtiles + it.mr - 1) / it.mr;
  return it;
}

// A block's weights: the packed weights in device memory, where the
// fragments (RESIDENT) or slots (RING), the barriers and the ring's copy
// of the chain lie in shared memory, the block's layers [l0, l1) of its
// chain, RESIDENT's layers issued; RING: the units consumed (v, every
// thread alike), the end of the current item's units, and the producer's
// units issued and the cursor (layer, round, chunk) of the next.  The
// chain itself is a callable the kernel passes, chain(l) the ChainLayer l
// (l a constant at every call, so that nothing of it stays live in
// registers across the kernel).
struct Staged {
  const bf16* wp;
  bf16* sw;
  uint64_t* bar;
  ChainLayer* ring_chain;
  int l0, l1, slots, issued, v, end, pl, pr, pc, W, p0;
  Items pit;
};

// The thread that initialises the barriers and issues the copies: lane 0
// of the block's last warp, which a layer of few items leaves idle
// (layer() gives its items to the first warps).
__device__ __forceinline__ bool producer() {
  return threadIdx.x == blockDim.x - 32;
}

// RESIDENT: layer l's first value in the block's staged fragments.
template <class Chain>
__device__ __forceinline__ long long staged_offset(const Staged& st,
                                                   const Chain& chain,
                                                   int l) {
  long long off = 0;
#pragma unroll
  for (int i = 0; i < MAX_CHAIN; ++i)
    if (i >= st.l0 && i < l) {
      const ChainLayer c = chain(i);
      off += packed_elems(c.O, c.I, c.taps);
    }
  return off;
}

// RESIDENT, the producer: layer l's bulk copy, on its own barrier.
template <class Chain>
__device__ __forceinline__ void issue_layer(const Staged& st,
                                            const Chain& chain, int l) {
  const ChainLayer c = chain(l);
  const unsigned bytes = (unsigned)(2 * packed_elems(c.O, c.I, c.taps));
  mbar_expect_tx(st.bar + l, bytes);
  bulk_copy(st.sw + staged_offset(st, chain, l), st.wp + c.at, bytes,
            st.bar + l);
}

// Every thread calls it at block start, once `st` holds the block's range
// of the chain: the producer's warp initialises the barriers and the
// producer writes the ring's copy of the chain and (RESIDENT) issues the
// bulk copies of the first COPY_AHEAD layers, while the other warps go
// on to stage x.  No barrier here: the __syncthreads that ends the
// kernel's staging of x orders the initialisation before any wait.
template <int KIND, class Chain>
__device__ __forceinline__ void stage_start(Staged& st, const Chain& chain) {
  st.v = st.end = st.issued = 0;
  if (KIND != DIRECT && threadIdx.x >= blockDim.x - 32) {
    const int lane = threadIdx.x & 31;
    if (KIND == RESIDENT && lane < MAX_CHAIN) mbar_init(st.bar + lane, 1);
    if (KIND == RING && lane < st.slots) {
      mbar_init(st.bar + lane, 1);
      mbar_init(st.bar + st.slots + lane, blockDim.x >> 5);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    __syncwarp();
    if (KIND == RING && lane == 0) {
#pragma unroll
      for (int l = 0; l < MAX_CHAIN; ++l) st.ring_chain[l] = chain(l);
    }
  }
  if constexpr (KIND == RESIDENT) {
#pragma unroll
    for (int l = 0; l < MAX_CHAIN; ++l)
      if (l >= st.l0 && l < st.l1 && l < st.l0 + COPY_AHEAD) {
        if (producer()) issue_layer(st, chain, l);
        st.issued = l + 1;
      }
  }
}

// RING, the producer: issue units until `slots` are ahead of the unit the
// block consumes or the item's units are all issued.  A slot's next fill
// waits until every warp has released its last unit.
__device__ __forceinline__ void ring_top_up(Staged& st) {
  while (st.issued < st.end && st.issued < st.v + st.slots) {
    const int s = st.issued % st.slots, k = st.issued / st.slots;
    if (k > 0) mbar_wait(st.bar + st.slots + s, (k - 1) & 1);
    const int m0 = st.pr * st.pit.mr;
    const int cnt = min(st.pit.mr, st.pit.mtiles - m0);
    const long long at = st.ring_chain[st.pl].at;
    mbar_expect_tx(st.bar + s, 512u * cnt);
    for (int i = 0; i < cnt; ++i)
      bulk_copy(st.sw + (size_t)s * SLOT_ELEMS + 256 * i,
                st.wp + at + ((size_t)(m0 + i) * st.pit.chunks + st.pc) * 256,
                512u, st.bar + s);
    ++st.issued;
    if (++st.pc == st.pit.chunks) {
      st.pc = 0;
      if (++st.pr == st.pit.rounds) {
        st.pr = 0;
        if (++st.pl < st.l1)
          st.pit = items_of(st.ring_chain[st.pl], st.W, st.p0,
                            blockDim.x >> 5);
      }
    }
  }
}

// Every thread calls it at the start of an item whose window is W columns
// from time p0 (before the item's first layer): RING counts the item's
// units and the producer issues the first of them.
template <int KIND, class Chain>
__device__ __forceinline__ void stage_item(Staged& st, const Chain& chain,
                                           int W, int p0) {
  st.W = W;
  st.p0 = p0;
  if constexpr (KIND == RING) {
    const int warps = blockDim.x >> 5;
    int units = 0;
#pragma unroll
    for (int l = 0; l < MAX_CHAIN; ++l)
      if (l >= st.l0 && l < st.l1) {
        const Items it = items_of(chain(l), W, p0, warps);
        units += it.rounds * it.chunks;
      }
    st.end = st.v + units;
    if (producer()) {
      st.pl = st.l0;
      st.pr = st.pc = 0;
      st.pit = items_of(st.ring_chain[st.l0], W, p0, warps);
      ring_top_up(st);
    }
  }
}

// Layer li of the chain on the ring: for each round, for each chunk, every
// warp waits for the unit, a warp with an item of the round runs its
// mma on the slot's fragment of its m-tile, and every warp releases the
// slot; the epilogue as layer()'s.  Ends with a __syncthreads.
template <int TAPS>
__device__ __forceinline__ void ring_layer(Staged& st, const ChainLayer& l,
                                           const bf16* in, int RS, int rows,
                                           const Out& y, const Win& win) {
  constexpr int H = TAPS / 2;
  const int warps = blockDim.x >> 5, w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const Items it = items_of(l, st.W, win.p0, warps);
  const int groups = (l.I + 15) >> 4;
  const int lo = l.lo, hi = st.W - l.tail;
  const int bn = (lane & 7) + ((lane >> 4) << 3);
  const int bk = ((lane >> 3) & 1) << 3;
  const int slot_mt = w / it.split, part = w - slot_mt * it.split;
  for (int r = 0; r < it.rounds; ++r) {
    const int mt = r * it.mr + slot_mt;
    const bool active = slot_mt < it.mr && mt < it.mtiles;
    const int j0 = it.first + 16 * it.per * part;
    const int np = active ? min(it.per, it.pairs - it.per * part) : 0;
    const int o0 = 16 * mt + (lane >> 2);
    float b[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      b[h] = (active && y.bias != nullptr && o0 + 8 * h < l.O)
                 ? __ldg(y.bias + o0 + 8 * h)
                 : 0.f;
    float acc[2 * MMA_PAIRS][4];
#pragma unroll
    for (int q = 0; q < 2 * MMA_PAIRS; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
    int k = 0, g = 0;
    for (int c = 0; c < it.chunks; ++c) {
      if (producer()) ring_top_up(st);
      __syncwarp();
      const int s = st.v % st.slots;
      mbar_wait(st.bar + s, (st.v / st.slots) & 1);
      if (np > 0) {
        const uint4 f = reinterpret_cast<const uint4*>(
            st.sw + (size_t)s * SLOT_ELEMS + 256 * slot_mt)[lane];
        const bf16* base = in + 16 * g + bk;
#pragma unroll
        for (int p = 0; p < MMA_PAIRS; ++p) {
          if (p < np) {
            const int rr = max(min(j0 + 16 * p + bn - H + k, rows - 1), 0);
            uint32_t bm[4];
            ldmatrix_x4(bm, base + (size_t)rr * RS);
            mma_chunk(acc[2 * p], f, bm[0], bm[1]);
            mma_chunk(acc[2 * p + 1], f, bm[2], bm[3]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(st.bar + st.slots + s);
      ++st.v;
      if (++g == groups) {
        g = 0;
        ++k;
      }
    }
    if (np > 0) {
#pragma unroll
      for (int p = 0; p < MMA_PAIRS; ++p)
        if (p < np)
          emit_pair(y, win, l.O, lo, hi, o0, j0 + 16 * p, b, acc[2 * p],
                    acc[2 * p + 1]);
    }
  }
  if (y.op != nullptr) zero_pad(y.op, y.RS, l.O, lo, hi);
  __syncthreads();
}

// Layer li of the block's chain (li a constant), its window [lo, W -
// tail), from wherever the weights are: RESIDENT issues the copy of the
// layer COPY_AHEAD ahead (once a block), waits for its own (at once
// after the first item) and reads shared memory; RING streams; DIRECT
// reads L2.  Every thread calls it; it ends with a __syncthreads.
template <int TAPS, int KIND, class Chain>
__device__ __forceinline__ void staged_layer(Staged& st, const Chain& chain,
                                             int li, const bf16* in, int RS,
                                             int rows, const Out& y,
                                             const Win& win) {
  const ChainLayer l = chain(li);
  const int lo = l.lo, hi = st.W - l.tail;
  if constexpr (KIND == RESIDENT) {
    const int next = li + COPY_AHEAD;
    if (next < MAX_CHAIN && next < st.l1 && next >= st.issued) {
      if (producer()) issue_layer(st, chain, next);
      st.issued = next + 1;
    }
    mbar_wait(st.bar + li, 0);
    layer<TAPS, true>(st.sw + staged_offset(st, chain, li), l.O, l.I, in,
                      RS, rows, lo, hi, y, win);
  } else if constexpr (KIND == RING) {
    ring_layer<TAPS>(st, l, in, RS, rows, y, win);
  } else {
    layer<TAPS>(st.wp + l.at, l.O, l.I, in, RS, rows, lo, hi, y, win);
  }
}

}  // namespace tilemma
