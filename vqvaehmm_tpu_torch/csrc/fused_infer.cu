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
// a warp share their input window.  A first small kernel of the call
// packs the torch weights into that order (32 768 floats at the published
// widths), so that a block stages a slab as one contiguous run.
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

#include <cuda_runtime.h>
#include <climits>
#include <cstddef>

#include "tile_fma.cuh"

namespace {

constexpr int HALO = 4;                // one step per k=3 convolution
constexpr int JB = 4;                  // time steps per thread in a conv
constexpr int MAX_THREADS = 512;
constexpr float NEG = -1e30f;

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

inline int max3(int a, int b, int c) { return a > b ? (a > c ? a : c) : (b > c ? b : c); }

// Rows of a ping-pong buffer: the widest activation a stage leaves there,
// the 2C rows of (mu, logvar) among them.
inline int buffer_rows(int C, int H1, int H2, int D) {
  const int h = max3(H1, H2, D);
  return h > 2 * C ? h : 2 * C;
}

}  // namespace

// Floats of the packed weights the wrapper allocates.
extern "C" long long vqhmm_fused_infer_packed_floats(int C, int H1, int H2,
                                                     int K, int D) {
  return packed(C, H1, H2, K, D).total;
}

// Dynamic shared memory of a block at tile width `tile`.
extern "C" int vqhmm_fused_infer_smem_bytes(int C, int H1, int H2, int K,
                                            int D, int tile) {
  return (int)(sizeof(float) * (2 * tilefma::WBUF + tilefma::ROW_PAD +
                                (size_t)row_stride(tile) *
                                    (C + 2 * buffer_rows(C, H1, H2, D) + K)));
}

extern "C" int vqhmm_fused_infer(
    const float* x, const int* valid_to,
    const float* ew1, const float* eb1, const float* ew2, const float* eb2,
    const float* ew3, const float* eb3, const float* emb,
    const float* dw1, const float* db1, const float* dw2, const float* db2,
    const float* dw3, const float* db3,
    float* packed_weights, float* mu, float* logvar, float* q,
    int B, int C, int T, int H1, int H2, int K, int D, int tile,
    void* stream) {
  const int maxH = max3(H1, H2, D);
  const int smem = vqhmm_fused_infer_smem_bytes(C, H1, H2, K, D, tile);
  if (tile != 16 && tile != 32 && tile != 64) return (int)cudaErrorInvalidValue;
  const int tiles = (T + tile - 1) / tile;
  const long long blocks = (long long)tiles * B;
  // a slab holds at least one input channel of every output
  if (B <= 0 || T <= 0 || blocks > INT_MAX ||
      3 * tilefma::round4(maxH) > tilefma::WBUF ||
      tilefma::round4(K) > tilefma::WBUF ||
      tilefma::round4(2 * C) > tilefma::WBUF)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_infer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const Packed at = packed(C, H1, H2, K, D);
  const PackJobs jobs{{{ew1, H1, C, 3, 0, at.ew1},
                       {ew2, H2, H1, 3, 0, at.ew2},
                       {ew3, K, H2, 1, 0, at.ew3},
                       {emb, D, K, 1, 1, at.emb},
                       {dw1, D, D, 3, 0, at.dw1},
                       {dw2, D, D, 3, 0, at.dw2},
                       {dw3, 2 * C, D, 1, 0, at.dw3}}};
  cudaStream_t s = (cudaStream_t)stream;
  infer_pack_kernel<<<(unsigned)((at.total + 255) / 256), 256, 0, s>>>(
      jobs, packed_weights);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_infer_kernel<<<(unsigned)blocks, block_threads(tile, maxH), smem, s>>>(
      x, valid_to, packed_weights, eb1, eb2, eb3, db1, db2, db3, mu, logvar, q,
      C, T, H1, H2, K, D, tile, tiles, buffer_rows(C, H1, H2, D));
  return (int)cudaGetLastError();
}

extern "C" const char* vqhmm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
