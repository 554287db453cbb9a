// Vector quantization for Hopper (sm_90a): the nearest code, and the whole
// straight-through quantizer, forward and backward.
//
//   idx[n]  = argmax_m ( z_n . e_m - 0.5 * |e_m|^2 )   (first index on a tie)
//   zq[n]   = e_{idx[n]}
// which is argmin_m |z_n - e_m|^2 with the |z_n|^2 term, constant in m,
// dropped.  The quantizer (ops/vq.py::quantize_st) adds
//   z_q_st        = z + (z_q - z)                      (straight-through)
//   commitment    = beta * sum_n m_n |z_n - z_q,n|^2 / denom
//   codebook_loss =        sum_n m_n |z_n - z_q,n|^2 / denom
//   denom         = max(sum_n m_n * D, 1)   (N * D without a mask)
// and its backward, for the cotangents (g, g_commit, g_cb) of the three:
//   dz_e[n]       = g[n] + ((z_n - z_q,n) * m_n) * (g_commit * 2 beta / denom)
//   dcodebook[k]  = (sum_{n: idx[n] = k} (z_n - e_k) * m_n)
//                   * (g_cb * -2 / denom)
//
// Replaces the TPU kernel vqvaehmm_tpu/ops/vq.py::_vq_kernel (entry
// vq_pallas) and the elementwise graph that JAX's quantize_st builds around
// it.  The wrappers and their plain PyTorch versions are in
// vqvaehmm_tpu_torch/ops/vq.py.
//
// Layout.  z, z_q_st and dz_e are addressed as (B, D, T) through three
// strides, so the model's channels-first latents (B, D, T) go in as they
// are and a flat (N, D) array goes in as B=1, T=N with strides (0, 1, D);
// the cotangent g has strides of its own.  idx is (B * T,) int32 in token
// order n = b * T + t; the mask, where there is one, is read at
// b * mb + t * mt as bytes (bool) or float32.  The codebook is (M, D)
// row-major.
//
// Design and bound.  Every entry reads each input once and writes each
// output once; at N = 12800, M = 8, D = 16 that is 0.5-0.8 us of the
// card's memory rate, against 2-3 us for any launch.  So the design is
// about launches: the quantizer is one launch forward and one backward,
// where the plain version is some forty elementwise launches and a
// one-hot product.  All three entries share one nearest-code body
// (`nearest`): the codebook, padded to DP = D rounded up to a power of two
// (8..64), and its half norms in shared memory, a token a thread with its
// D latents in registers, one FMA chain over d for each code and a strict
// `>`, so the first maximum wins as in argmax; so all three give the same
// idx bit for bit.  Consecutive threads take consecutive t, so with the
// channels-first layout every load and store of a warp is one coalesced
// row segment.  Nothing is carried over from the TPU kernel's 1024-row
// VMEM block or its one-hot matmul: that re-expansion exists there because
// the TPU has no cheap gather.
//
// Sums across blocks use no float atomics, so two calls are bit-equal.
// Each block writes its partial sums to a scratch buffer, then
// __threadfence() and an integer arrival counter; the last block to arrive
// adds the partials in a fixed order, writes the result and sets the
// counter back to 0 for the next launch on the stream.  The grids are
// capped at a fixed number of blocks (grid-stride beyond), independent of
// the card, so the order of every sum is a function of the shapes alone.
// The forward's partials are each block's masked sum of squares and sum of
// the mask; the backward's each block's per-code sums of (z - e_k) * m, an
// M x D array in shared memory, to which a thread of each (k, d) adds the
// tokens of code k of each chunk of the block in token order.  Its time
// is the launch and each block's chain of chunks, not its bytes, and a
// quicker sum would save microseconds of a step the host holds back, so it
// is kept this plain.
// dz_e and z_q_st round each operation once, in the order written above
// (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn: no contraction into an
// FMA), so they are bit-equal to the plain versions, which run the same
// operations as separate PyTorch launches.
//
// The latents sit in a register array of DP, zero past D, and the codebook
// rows in shared memory are padded to DP the same way: fma(0, 0, acc) leaves
// acc as it was, so the padding changes no score.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_D = 64;
constexpr int SMEM_DEFAULT = 48 * 1024;   // a block's default shared memory
constexpr int SMEM_OPTIN = 227 * 1024;    // with the opt-in attribute
constexpr int FWD_BLOCKS = 1024;          // grid caps, card-independent
constexpr int BWD_BLOCKS = 256;
constexpr int TILE_FLOATS = 4096;         // a backward chunk's (z - e) * m

int padded_d(int D) {
  int dp = 8;
  while (dp < D) dp *= 2;
  return dp;
}

// tokens of a backward chunk: a power of two with TOK * D <= TILE_FLOATS
int chunk_tokens(int D) {
  int tok = THREADS;
  while (tok > 1 && tok * D > TILE_FLOATS) tok /= 2;
  return tok;
}

// Stage the codebook, padded to DP, and its half norms; ends in a barrier.
template <int DP>
__device__ void stage_codebook(const float* __restrict__ cb, float* e,
                               float* half, int M, int D) {
  for (int i = threadIdx.x; i < M * DP; i += blockDim.x) {
    const int m = i / DP, d = i % DP;
    e[i] = d < D ? cb[m * D + d] : 0.f;
  }
  __syncthreads();
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(e[m * DP + d], e[m * DP + d], s);
    half[m] = 0.5f * s;
  }
  __syncthreads();
}

// The nearest-code body all three entries share.
template <int DP>
__device__ __forceinline__ int nearest(const float (&zr)[DP],
                                       const float* e, const float* half,
                                       int M) {
  int best = 0;
  float best_score = 0.f;
  for (int m = 0; m < M; ++m) {
    const float* row = e + m * DP;
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < DP; ++d) acc = fmaf(zr[d], row[d], acc);
    const float score = acc - half[m];
    if (m == 0 || score > best_score) {
      best_score = score;
      best = m;
    }
  }
  return best;
}

// mask mode: 0 none, 1 bytes (bool), 2 float32
__device__ __forceinline__ float mask_at(const void* mask, int mode,
                                         long long off) {
  if (mode == 0) return 1.f;
  if (mode == 1)
    return static_cast<const unsigned char*>(mask)[off] ? 1.f : 0.f;
  return static_cast<const float*>(mask)[off];
}

// After every thread of the block has written its partials: whether this
// block is the last of the grid to arrive.  Ends in a barrier.  The
// barrier orders the block's writes before thread 0's fence, which
// publishes them before its arrival (the pattern of a cooperative grid
// barrier); the last block fences again before it reads the others'.
__device__ bool arrive_last(unsigned int* counter, bool* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const bool last = atomicAdd(counter, 1u) == gridDim.x - 1;
    if (last) __threadfence();
    *flag = last;
  }
  __syncthreads();
  return *flag;
}

template <int DP>
__global__ void __launch_bounds__(THREADS) vq_nearest_kernel(
    const float* __restrict__ z, long long zb, long long zd, long long zt,
    const float* __restrict__ cb, float* __restrict__ zq,
    int* __restrict__ idx, int B, int T, int M, int D) {
  extern __shared__ float smem[];
  float* e = smem;                 // (M, DP), zero past D
  float* half = smem + M * DP;     // (M,)
  stage_codebook<DP>(cb, e, half, M, D);

  const long long total = (long long)B * T;
  for (long long n = blockIdx.x * (long long)THREADS + threadIdx.x;
       n < total; n += (long long)gridDim.x * THREADS) {
    const long long b = n / T, t = n % T;
    const long long base = b * zb + t * zt;
    float zr[DP];
#pragma unroll
    for (int d = 0; d < DP; ++d) zr[d] = d < D ? z[base + d * zd] : 0.f;
    const int best = nearest<DP>(zr, e, half, M);
    idx[n] = best;
    const float* row = e + best * DP;
#pragma unroll
    for (int d = 0; d < DP; ++d)
      if (d < D) zq[base + d * zd] = row[d];
  }
}

// partials: (blocks, 2) masked sums of squares and of the mask, then
// denom at [2 * gridDim.x]; commit and cb_loss: the two scalar losses.
template <int DP>
__global__ void __launch_bounds__(THREADS) vq_quantize_forward_kernel(
    const float* __restrict__ z, long long zb, long long zd, long long zt,
    const void* __restrict__ mask, int mask_mode, long long mb,
    long long mt, const float* __restrict__ cb, float beta,
    float* __restrict__ zst, int* __restrict__ idx,
    float* __restrict__ partials, float* __restrict__ commit,
    float* __restrict__ cb_loss, unsigned int* __restrict__ counter, int B,
    int T, int M, int D) {
  extern __shared__ float smem[];
  float* e = smem;                       // (M, DP)
  float* half = e + M * DP;              // (M,)
  float* red_sq = half + M;              // (THREADS,)
  float* red_m = red_sq + THREADS;       // (THREADS,)
  __shared__ bool last;
  const long long total = (long long)B * T;
  const long long stride = (long long)gridDim.x * THREADS;
  long long n = blockIdx.x * (long long)THREADS + threadIdx.x;
  long long b = 0, t = 0, base = 0;
  float zr[DP];
  // a token's latents; the first token's loads start before the codebook
  // is staged, so the two wait on the memory together
  auto fetch = [&]() {
    b = n / T;
    t = n - b * T;
    base = b * zb + t * zt;
#pragma unroll
    for (int d = 0; d < DP; ++d) zr[d] = d < D ? z[base + d * zd] : 0.f;
  };
  if (n < total) fetch();
  stage_codebook<DP>(cb, e, half, M, D);

  float acc_sq = 0.f, acc_m = 0.f;
  while (n < total) {
    const int best = nearest<DP>(zr, e, half, M);
    idx[n] = best;
    const float* row = e + best * DP;
    float sq = 0.f;
#pragma unroll
    for (int d = 0; d < DP; ++d) {
      if (d < D) {
        zst[base + d * zd] = __fadd_rn(zr[d], __fsub_rn(row[d], zr[d]));
        const float diff = __fsub_rn(zr[d], row[d]);
        sq = fmaf(diff, diff, sq);
      }
    }
    const float m = mask_at(mask, mask_mode, b * mb + t * mt);
    acc_sq = fmaf(sq, m, acc_sq);
    acc_m += m;
    n += stride;
    if (n < total) fetch();
  }

  // the block's partials, by a tree of fixed shape
  red_sq[threadIdx.x] = acc_sq;
  red_m[threadIdx.x] = acc_m;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s /= 2) {
    if (threadIdx.x < s) {
      red_sq[threadIdx.x] += red_sq[threadIdx.x + s];
      red_m[threadIdx.x] += red_m[threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = red_sq[0];
    partials[2 * blockIdx.x + 1] = red_m[0];
  }
  if (!arrive_last(counter, &last)) return;

  // the last block: the blocks' partials in a fixed order
  float s_sq = 0.f, s_m = 0.f;
  for (int g = threadIdx.x; g < (int)gridDim.x; g += THREADS) {
    s_sq += __ldcg(partials + 2 * g);
    s_m += __ldcg(partials + 2 * g + 1);
  }
  red_sq[threadIdx.x] = s_sq;
  red_m[threadIdx.x] = s_m;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s /= 2) {
    if (threadIdx.x < s) {
      red_sq[threadIdx.x] += red_sq[threadIdx.x + s];
      red_m[threadIdx.x] += red_m[threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float denom =
        mask_mode == 0 ? (float)(total * D)
                       : fmaxf(__fmul_rn(red_m[0], (float)D), 1.f);
    *commit = __fdiv_rn(__fmul_rn(beta, red_sq[0]), denom);
    *cb_loss = __fdiv_rn(red_sq[0], denom);
    partials[2 * gridDim.x] = denom;
    *counter = 0u;
  }
}

// partials: (blocks, M, D) per-code sums; denom: the forward's.
__global__ void __launch_bounds__(THREADS) vq_quantize_backward_kernel(
    const float* __restrict__ g, long long gb, long long gd, long long gt,
    const float* __restrict__ g_commit, const float* __restrict__ g_cb,
    const float* __restrict__ z, long long zb, long long zd, long long zt,
    const void* __restrict__ mask, int mask_mode, long long mb,
    long long mt, const float* __restrict__ cb,
    const int* __restrict__ idx, const float* __restrict__ denom_p,
    float two_beta, float* __restrict__ dz, float* __restrict__ dcb,
    float* __restrict__ partials, unsigned int* __restrict__ counter,
    int B, int T, int M, int D, int tok) {
  extern __shared__ float smem[];
  const int P = M * D;
  float* acc = smem;                         // (P,) the block's sums
  float* tile = acc + P;                     // (D, tok + 1): (z - e) * m
  int* tile_k = reinterpret_cast<int*>(tile + D * (tok + 1));   // (tok,)
  __shared__ bool last;

  const float denom = *denom_p;
  const float c_commit = __fdiv_rn(__fmul_rn(*g_commit, two_beta), denom);
  for (int p = threadIdx.x; p < P; p += THREADS) acc[p] = 0.f;
  const long long total = (long long)B * T;
  for (long long base = (long long)blockIdx.x * tok; base < total;
       base += (long long)gridDim.x * tok) {
    // the chunk's codes, -1 past the last token
    for (int j = threadIdx.x; j < tok; j += THREADS)
      tile_k[j] = base + j < total ? idx[base + j] : -1;
    __syncthreads();
    // dz_e and the chunk's (z - e) * m, lanes over the tokens
    for (int i = threadIdx.x; i < tok * D; i += THREADS) {
      const int d = i / tok, j = i - d * tok, k = tile_k[j];
      if (k < 0) continue;
      const long long n = base + j, b = n / T, t = n - b * T;
      const long long zi = b * zb + t * zt + d * zd;
      const float v = __fmul_rn(__fsub_rn(z[zi], cb[k * D + d]),
                                mask_at(mask, mask_mode, b * mb + t * mt));
      dz[zi] = __fadd_rn(g[b * gb + t * gt + d * gd], __fmul_rn(v, c_commit));
      tile[d * (tok + 1) + j] = v;
    }
    __syncthreads();
    // the per-code sums, over the chunk's tokens in token order
    for (int p = threadIdx.x; p < P; p += THREADS) {
      const int k = p / D;
      const float* col = tile + (p - k * D) * (tok + 1);
      float s = acc[p];
      for (int j = 0; j < tok; ++j)
        if (tile_k[j] == k) s = __fadd_rn(s, col[j]);
      acc[p] = s;
    }
    __syncthreads();
  }
  for (int p = threadIdx.x; p < P; p += THREADS)
    partials[(long long)blockIdx.x * P + p] = acc[p];
  if (!arrive_last(counter, &last)) return;

  // the last block: the blocks' sums in block order
  const float c_cb = __fdiv_rn(__fmul_rn(*g_cb, -2.f), denom);
  for (int p = threadIdx.x; p < P; p += THREADS) {
    float s = 0.f;
    for (int blk = 0; blk < (int)gridDim.x; ++blk)
      s = __fadd_rn(s, __ldcg(partials + (long long)blk * P + p));
    dcb[p] = __fmul_rn(s, c_cb);
  }
  if (threadIdx.x == 0) *counter = 0u;
}

// Shared memory a block of each entry needs, or -1 where D is past the
// register loop.
int nearest_smem(int M, int D) {
  if (M <= 0 || D <= 0 || D > MAX_D) return -1;
  return (int)sizeof(float) * (M * padded_d(D) + M);
}

int forward_smem(int M, int D) {
  const int s = nearest_smem(M, D);
  return s < 0 ? -1 : s + (int)sizeof(float) * 2 * THREADS;
}

// the backward reads the codebook through the L1 and stages none of it
int backward_smem(int M, int D) {
  if (M <= 0 || D <= 0 || D > MAX_D) return -1;
  const int tok = chunk_tokens(D);
  return (int)sizeof(float) * (M * D + D * (tok + 1) + tok);
}

long long grid_for(long long total, int per_block, int cap) {
  long long blocks = (total + per_block - 1) / per_block;
  return blocks > cap ? cap : blocks;
}

// Launch `kernel` with `smem` bytes, raising the block's limit first where
// it is past the default.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, long long blocks, int smem, cudaStream_t s,
           Args... args) {
  if (smem > SMEM_DEFAULT) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)blocks, THREADS, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vqhmm_vq_nearest(const float* z, long long zb, long long zd,
                                long long zt, const float* cb, float* zq,
                                int* idx, int B, int T, int M, int D,
                                void* stream) {
  if (B <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  const int smem = nearest_smem(M, D);
  if (smem < 0 || smem > SMEM_DEFAULT) return (int)cudaErrorInvalidValue;
  const long long blocks = grid_for((long long)B * T, THREADS, 65535 * 16);
  cudaStream_t s = (cudaStream_t)stream;
  switch (padded_d(D)) {
    case 8:
      return launch(vq_nearest_kernel<8>, blocks, smem, s, z, zb, zd, zt,
                    cb, zq, idx, B, T, M, D);
    case 16:
      return launch(vq_nearest_kernel<16>, blocks, smem, s, z, zb, zd, zt,
                    cb, zq, idx, B, T, M, D);
    case 32:
      return launch(vq_nearest_kernel<32>, blocks, smem, s, z, zb, zd, zt,
                    cb, zq, idx, B, T, M, D);
    default:
      return launch(vq_nearest_kernel<64>, blocks, smem, s, z, zb, zd, zt,
                    cb, zq, idx, B, T, M, D);
  }
}

// Blocks of the forward (its partials hold 2 * blocks + 1 floats) and of
// the backward (blocks * M * D floats), and each one's shared memory;
// what = 0, 1, 2, 3 respectively.  -1 where the shape is refused.
extern "C" long long vqhmm_vq_quantize_sizes(int B, int T, int M, int D,
                                             int what) {
  const int fs = forward_smem(M, D), bs = backward_smem(M, D);
  if (B <= 0 || T <= 0 || fs < 0 || bs < 0 || fs > SMEM_OPTIN
      || bs > SMEM_OPTIN)
    return -1;
  const long long total = (long long)B * T;
  switch (what) {
    case 0: return grid_for(total, THREADS, FWD_BLOCKS);
    case 1: return grid_for(total, chunk_tokens(D), BWD_BLOCKS);
    case 2: return fs;
    case 3: return bs;
    default: return -1;
  }
}

extern "C" int vqhmm_vq_quantize_forward(
    const float* z, long long zb, long long zd, long long zt,
    const void* mask, int mask_mode, long long mb, long long mt,
    const float* cb, float beta, float* zst, int* idx, float* partials,
    float* commit, float* cb_loss, unsigned int* counter, int B, int T,
    int M, int D, void* stream) {
  const long long blocks = vqhmm_vq_quantize_sizes(B, T, M, D, 0);
  if (blocks <= 0) return (int)cudaErrorInvalidValue;
  const int smem = forward_smem(M, D);
  cudaStream_t s = (cudaStream_t)stream;
#define VQ_FORWARD(DP)                                                     \
  launch(vq_quantize_forward_kernel<DP>, blocks, smem, s, z, zb, zd, zt,   \
         mask, mask_mode, mb, mt, cb, beta, zst, idx, partials, commit,    \
         cb_loss, counter, B, T, M, D)
  switch (padded_d(D)) {
    case 8: return VQ_FORWARD(8);
    case 16: return VQ_FORWARD(16);
    case 32: return VQ_FORWARD(32);
    default: return VQ_FORWARD(64);
  }
#undef VQ_FORWARD
}

extern "C" int vqhmm_vq_quantize_backward(
    const float* g, long long gb, long long gd, long long gt,
    const float* g_commit, const float* g_cb, const float* z, long long zb,
    long long zd, long long zt, const void* mask, int mask_mode,
    long long mb, long long mt, const float* cb, const int* idx,
    const float* denom, float two_beta, float* dz, float* dcb,
    float* partials, unsigned int* counter, int B, int T, int M, int D,
    void* stream) {
  const long long blocks = vqhmm_vq_quantize_sizes(B, T, M, D, 1);
  if (blocks <= 0) return (int)cudaErrorInvalidValue;
  return launch(vq_quantize_backward_kernel, blocks, backward_smem(M, D),
                (cudaStream_t)stream, g, gb, gd, gt, g_commit, g_cb, z, zb,
                zd, zt, mask, mask_mode, mb, mt, cb, idx, denom, two_beta,
                dz, dcb, partials, counter, B, T, M, D, chunk_tokens(D));
}
