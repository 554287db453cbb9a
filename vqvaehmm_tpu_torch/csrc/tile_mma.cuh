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
//    barrier within a layer).  Outputs [O, round16(O)) have zero weights;
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

// The whole layer, from the packed weights wp and the operand `in` (RS
// values a row, `rows` rows allocated), through the epilogue `y`.  Rows
// from 2 before lo to 15 past hi - 1 + TAPS/2 are read for the padded
// columns of the first and last n-tiles (never for a stored value); they
// are clamped to the allocation.
// Every thread of the block calls it; it ends with a __syncthreads.
template <int TAPS>
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
    uint4 f[AHEAD];
#pragma unroll
    for (int s = 0; s < AHEAD; ++s)
      f[s] = s < chunks ? __ldg(a + (size_t)s * 32) : make_uint4(0, 0, 0, 0);
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
            f[s] = __ldg(a + (size_t)(c + s + AHEAD) * 32);
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
    for (int h = 0; h < 2; ++h)
      b[h] = (y.bias != nullptr && o0 + 8 * h < O) ? __ldg(y.bias + o0 + 8 * h)
                                                  : 0.f;
#pragma unroll
    for (int p = 0; p < MMA_PAIRS; ++p)
      if (p < np)
        emit_pair(y, win, O, lo, hi, o0, j0 + 16 * p, b, acc[2 * p],
                  acc[2 * p + 1]);
  }
  if (y.op != nullptr) zero_pad(y.op, y.RS, O, lo, hi);
  __syncthreads();
}

}  // namespace tilemma
