// Register-tiled convolution and dense product over a time window held in
// shared memory: the building block of the fused serving forward
// (fused_infer.cu) and of the fused training step (fused_train.cu).
//
// A layer is out[o][j] = sum_{i,k} w[o][i][k] * in[i][j - TAPS/2 + k] over
// window positions j in [lo, hi), TAPS = 3 (a k=3 convolution that reads
// one step of halo a side) or 1 (a 1x1 / dense product).  Rows of `in`
// and `out` are WS floats apart.
//
// What the design does about the card:
//  * one thread computes OB = 4 output channels x JB = 4 time steps, so
//    an input window of JB + TAPS - 1 values, loaded as one 16-byte and
//    one 8-byte word, feeds OB * TAPS * JB FMAs and a weight feeds JB: 5
//    loads for 48 FMAs.  (Tiles of 8 x 4 halve the loads an FMA needs and
//    were slower on the card, at 126 registers a thread and half the
//    warps; so was a warp laid over 4 channel groups x 8 step groups.)
//  * the weights are staged in shared memory a slab of input channels at
//    a time with 16-byte cp.async copies, double-buffered (slab s + 1, or
//    the next layer's first slab, is in flight while slab s is consumed),
//    in the order ws[(i * TAPS + k) * OS + pos]: the 4 weights a thread
//    needs are one aligned 16-byte word, and neighbouring lanes read
//    neighbouring words, so a warp's weight load touches each bank once.
//    A small kernel of the caller first packs the torch tensors
//    (O, I, TAPS) into that order in device memory (pack_weights), so a
//    slab is one contiguous run: staged straight from the torch layout, 4
//    bytes a copy and a 32-byte sector a lane, the copies alone took
//    longer than the arithmetic;
//  * the lanes of a warp run over the groups of output channels first, so
//    they share their input window: those loads are broadcasts, free of
//    bank conflicts at any row stride;
//  * between slabs the partial sums rest in `out` (a float32 store and
//    load keeps every bit), so a layer of any width goes through one
//    fixed-size pair of weight buffers.  A thread's 4 channels lie a
//    quarter of the layer apart (channel_at), so that neighbouring lanes
//    hold neighbouring rows of `out`: with 4 neighbouring channels a
//    thread, a warp's loads and stores of the partial sums fell on 2 of
//    the 32 banks, and a layer of many slabs spent most of its time there.
//
// Every output's FMA chain is fixed: input channels ascending, and for each
// the taps 0, 1, 2 nested, acc = fma(w2, v2, fma(w1, v1, fma(w0, v0, acc))),
// starting from 0; the bias is added after the last slab by the caller.
// The result of an output therefore does not depend on the tile, the
// block, the slab size or the batch.  Arithmetic is fp32 FMA on the CUDA
// cores (the model's contract is full float32: no TF32, no tensor cores).
// The training step's bfloat16 mode does not use this header's layers: its
// products run on the tensor cores (tile_mma.cuh).
//
// pack_weights also packs the transposed layer (the gradient with respect
// to the layer's input): output channel a and input channel b of the
// transposed layer read w[b][a][TAPS - 1 - k].

#pragma once

#include <cuda_runtime.h>

namespace tilefma {

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
// 4 bytes, or zeros where !valid (src must still be a valid address).
__device__ __forceinline__ void cp_async4_zfill(float* dst, const float* src,
                                                bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The output channel at position pos of a packed row of OS = round4(O)
// weights, and back: the 4 weights of a 16-byte word belong to channels
// OS / 4 apart.
__host__ __device__ inline int channel_at(int pos, int OS) {
  return (pos & 3) * (OS >> 2) + (pos >> 2);
}
__host__ __device__ inline int position_of(int o, int OS) {
  const int og = OS >> 2;
  return (o % og) * 4 + o / og;
}

// Floats of a packed layer: wp[(i * taps + k) * OS + pos], OS = round4(O),
// the channels in [O, OS) zero.
__host__ __device__ inline long long packed_floats(int O, int I, int taps) {
  return (long long)I * taps * round4(O);
}

// One layer to pack: w the torch tensor (O, I, taps), or, with trans, the
// tensor (I, O, taps) of the layer whose transpose this is; `at` its first
// float in the packed buffer (a multiple of 4).
struct PackJob {
  const float* w;
  int O, I, taps, trans;
  long long at;
};

// dst[job.at + (i * taps + k) * OS + pos] for every job, by the whole grid.
__device__ __forceinline__ void pack_weights(const PackJob* jobs, int njobs,
                                             float* __restrict__ dst) {
  const long long total = jobs[njobs - 1].at +
      packed_floats(jobs[njobs - 1].O, jobs[njobs - 1].I, jobs[njobs - 1].taps);
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    int ji = 0;
    while (ji + 1 < njobs && idx >= jobs[ji + 1].at) ++ji;
    const PackJob& job = jobs[ji];
    const int OS = round4(job.O);
    const long long local = idx - job.at;
    const int ik = (int)(local / OS), pos = (int)(local - (long long)ik * OS);
    const int o = channel_at(pos, OS);
    const int i = ik / job.taps, k = ik - i * job.taps;
    float v = 0.f;
    if (o < job.O)
      v = job.trans
              ? job.w[((size_t)i * job.O + o) * job.taps + (job.taps - 1 - k)]
              : job.w[((size_t)o * job.I + i) * job.taps + k];
    dst[idx] = v;
  }
}

// `count` floats (a multiple of 4) of a packed slab into ws, 16 bytes a
// copy, neighbouring lanes on neighbouring words.
__device__ __forceinline__ void stage_packed(const float* __restrict__ src,
                                             int count, float* ws) {
  for (int idx = 4 * threadIdx.x; idx < count; idx += 4 * blockDim.x)
    cp_async16(ws + idx, src + idx);
}

// One slab: out[o][j] (+)= sum over the slab's n input channels, for o in
// [0, O) and j in [lo, hi).  `in` points at window position 0 of the
// slab's first input row and lies one float past a 16-byte boundary (as
// every row does: WS is a multiple of 4), and the groups of JB = 4 steps
// start where their input window starts on such a boundary, so a thread
// reads its window as one 16-byte and, for TAPS = 3, one 8-byte word.
// first: start from 0, else from the partial sums in `out`.  Up to 4
// positions before lo and JB past hi are read (and never used for a
// stored value): rows keep JB floats of slack, and a float lies before
// the first row.
template <int TAPS>
__device__ __forceinline__ void fma_slab4(const float* ws, int O, int n,
                                          const float* in, float* out, int WS,
                                          int lo, int hi, bool first) {
  constexpr int OB = 4, JB = 4;
  constexpr int H = TAPS / 2;
  const int OS = round4(O);
  const int ogroups = OS / OB;
  // the first group starts at the last j0 <= lo with (j0 - H + 1) % 4 == 0
  const int jstart = lo - ((lo - H + 1) & 3);
  const int groups = (hi - jstart + JB - 1) / JB;
  for (int idx = threadIdx.x; idx < ogroups * groups; idx += blockDim.x) {
    const int g = idx / ogroups;
    const int og = idx - g * ogroups;
    const int j0 = jstart + g * JB;
    // the thread's channels: og, og + ogroups, og + 2 ogroups, og + 3 ogroups
    float acc[OB][JB];
#pragma unroll
    for (int a = 0; a < OB; ++a)
#pragma unroll
      for (int r = 0; r < JB; ++r)
        acc[a][r] = (first || a * ogroups + og >= O || j0 + r < lo ||
                     j0 + r >= hi)
                        ? 0.f : out[(a * ogroups + og) * WS + j0 + r];
    const float* row = in + j0 - H;
    const float* wp = ws + og * OB;
#pragma unroll 2
    for (int il = 0; il < n; ++il) {
      float v[JB + TAPS - 1];
      const float4 v4 = *reinterpret_cast<const float4*>(row);
      v[0] = v4.x;
      v[1] = v4.y;
      v[2] = v4.z;
      v[3] = v4.w;
      if constexpr (TAPS == 3) {
        const float2 v2 = *reinterpret_cast<const float2*>(row + 4);
        v[4] = v2.x;
        v[5] = v2.y;
      }
#pragma unroll
      for (int k = 0; k < TAPS; ++k) {
        const float4 w4 = *reinterpret_cast<const float4*>(wp + k * OS);
        const float wv[OB] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int a = 0; a < OB; ++a)
#pragma unroll
          for (int r = 0; r < JB; ++r)
            acc[a][r] = fmaf(wv[a], v[r + k], acc[a][r]);
      }
      row += WS;
      wp += TAPS * OS;
    }
#pragma unroll
    for (int a = 0; a < OB; ++a)
#pragma unroll
      for (int r = 0; r < JB; ++r)
        if (a * ogroups + og < O && j0 + r >= lo && j0 + r < hi)
          out[(a * ogroups + og) * WS + j0 + r] = acc[a][r];
  }
}

// The same for a layer of few outputs, spread over the block an (output,
// step) or (4 outputs, step) a thread: scalar loads of the window.
template <int TAPS, int OB>
__device__ __forceinline__ void fma_slab1(const float* ws, int O, int n,
                                          const float* in, float* out, int WS,
                                          int lo, int hi, bool first) {
  static_assert(TAPS == 1 && (OB == 1 || OB == 4), "a dense layer");
  const int OS = round4(O);
  const int ogroups = OB == 4 ? OS / 4 : O;
  for (int idx = threadIdx.x; idx < ogroups * (hi - lo); idx += blockDim.x) {
    const int g = idx / ogroups;
    const int og = idx - g * ogroups;
    const int j = lo + g;
    // OB = 4: the channels og + a * ogroups; OB = 1: the channel og
    float acc[OB];
#pragma unroll
    for (int a = 0; a < OB; ++a)
      acc[a] = (first || a * ogroups + og >= O)
                   ? 0.f : out[(a * ogroups + og) * WS + j];
    const float* row = in + j;
    const float* wp = ws + (OB == 4 ? og * 4 : position_of(og, OS));
#pragma unroll 4
    for (int il = 0; il < n; ++il) {
      const float v = *row;
      if constexpr (OB == 4) {
        const float4 w4 = *reinterpret_cast<const float4*>(wp);
        acc[0] = fmaf(w4.x, v, acc[0]);
        acc[1] = fmaf(w4.y, v, acc[1]);
        acc[2] = fmaf(w4.z, v, acc[2]);
        acc[3] = fmaf(w4.w, v, acc[3]);
      } else {
        acc[0] = fmaf(*wp, v, acc[0]);
      }
      row += WS;
      wp += OS;
    }
#pragma unroll
    for (int a = 0; a < OB; ++a)
      if (a * ogroups + og < O) out[(a * ogroups + og) * WS + j] = acc[a];
  }
}

// JB = 4: the register-tiled slab, 4 output channels x 4 steps a thread;
// JB = 1: a small layer.
template <int TAPS, int OB, int JB>
__device__ __forceinline__ void fma_slab(const float* ws, int O, int n,
                                         const float* in, float* out, int WS,
                                         int lo, int hi, bool first) {
  if constexpr (JB == 1) {
    fma_slab1<TAPS, OB>(ws, O, n, in, out, WS, lo, hi, first);
  } else {
    static_assert(JB == 4 && OB == 4, "4 channels x 4 steps a thread");
    fma_slab4<TAPS>(ws, O, n, in, out, WS, lo, hi, first);
  }
}

// The epilogue of a layer on buf[o][j], j in [lo, hi), window index j
// being time p0 + j: v = buf + bias[o] (bias may be null), through a ReLU
// if RELU; zero where `mask` and the step lies outside [0, T) or at or
// past `limit`; zero where `gate` (rows of T floats in device memory, the
// activation whose ReLU the gradient passes) is given and is not positive
// there.  The result goes back to buf and, for the steps [t0, t0 + n) of
// the block's own tile, to dst (rows of T floats) where dst is given.
// Ends with a __syncthreads.
template <bool RELU>
__device__ __forceinline__ void finish(float* buf, int O, int WS, int lo,
                                       int hi, const float* __restrict__ bias,
                                       bool mask, int p0, int T, int limit,
                                       const float* __restrict__ gate,
                                       float* __restrict__ dst, int t0,
                                       int n) {
  const int w = hi - lo;
  for (int idx = threadIdx.x; idx < O * w; idx += blockDim.x) {
    const int o = idx / w, j = lo + idx - o * w;
    const int p = p0 + j;
    float v = buf[o * WS + j];
    if (bias != nullptr) v += __ldg(bias + o);
    if (RELU) v = fmaxf(v, 0.f);
    const bool inside = p >= 0 && p < T;
    if (mask && (!inside || p >= limit)) v = 0.f;
    if (gate != nullptr && inside && !(gate[(size_t)o * T + p] > 0.f)) v = 0.f;
    buf[o * WS + j] = v;
    if (dst != nullptr && p >= t0 && p < t0 + n) dst[(size_t)o * T + p] = v;
  }
  __syncthreads();
}

// Floats before the first row of a block's window buffers and after the
// last: rows start one float past a 16-byte boundary (fma_slab4), and the
// over-reads of the last row stay inside the allocation.
constexpr int ROW_PAD = 8;
__device__ __forceinline__ float* first_row(float* smem_after_weights) {
  return smem_after_weights + 1;
}

// Floats of one of the two weight buffers a layer streams its slabs
// through (24 KB): a whole layer of the published widths but the two
// 64 x 64 x 3 decoder convolutions, which take two slabs.
constexpr int WBUF = 6144;

// Input channels a slab holds for a layer with O outputs.
__host__ __device__ inline int slab_channels(int O, int taps) {
  const int per = WBUF / (taps * round4(O));
  return per < 1 ? 1 : per;
}

// The layer whose first slab a running layer stages into the idle weight
// buffer while it consumes its own last slab (wp == nullptr: none), so a
// layer's first weights are in flight before the layer starts.
struct Next {
  const float* wp;       // the packed layer
  int O, I, taps;
};
__device__ __forceinline__ Next no_next() { return Next{nullptr, 0, 0, 0}; }

// The two weight buffers (2 * WBUF floats, 16-byte aligned), the one the
// next slab goes to, and whether a layer's first slab is already staged.
struct Pipe {
  float* wbuf;
  int cur;
  bool staged;
};

__device__ __forceinline__ void stage_first(const Next& nx, float* buf) {
  const int per = slab_channels(nx.O, nx.taps);
  stage_packed(nx.wp, (per < nx.I ? per : nx.I) * nx.taps * round4(nx.O), buf);
  cp_async_commit();
}

// The whole layer: out[o][j] = sum_{i,k} w.. in.. for j in [lo, hi), the
// raw sums (no bias, no activation), from the packed weights wp.  Ends
// with a __syncthreads: `out` is visible to the block.  A layer needs
// round4(O) * TAPS <= WBUF (the callers' launchers check).  Every thread
// of the block calls it.
template <int TAPS, int OB, int JB>
__device__ __forceinline__ void layer(const float* __restrict__ wp, int O,
                                      int I, const float* in, float* out,
                                      int WS, int lo, int hi, Pipe& pipe,
                                      const Next& nx) {
  const int per = slab_channels(O, TAPS);
  const int nslab = (I + per - 1) / per;
  const int chan = TAPS * round4(O);          // floats an input channel
  if (!pipe.staged) stage_first(Next{wp, O, I, TAPS},
                                pipe.wbuf + pipe.cur * WBUF);
  for (int s = 0; s < nslab; ++s) {
    const int i0 = s * per;
    const int n = I - i0 < per ? I - i0 : per;
    float* mine = pipe.wbuf + ((pipe.cur + s) & 1) * WBUF;
    float* other = pipe.wbuf + ((pipe.cur + s + 1) & 1) * WBUF;
    if (s + 1 < nslab) {
      const int i1 = i0 + per;
      stage_packed(wp + (size_t)i1 * chan,
                   (I - i1 < per ? I - i1 : per) * chan, other);
      cp_async_commit();
      cp_async_wait<1>();
    } else if (nx.wp != nullptr) {
      stage_first(nx, other);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    fma_slab<TAPS, OB, JB>(mine, O, n, in + (size_t)i0 * WS, out, WS, lo, hi,
                           s == 0);
    __syncthreads();
  }
  pipe.cur = (pipe.cur + nslab) & 1;
  pipe.staged = nx.wp != nullptr;
}

}  // namespace tilefma
