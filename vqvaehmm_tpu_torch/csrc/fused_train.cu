// Fused training step of the VAE-HMM for Hopper (sm_90a): the masked
// negative ELBO and the gradients of all 18 parameter arrays in one pass.
//
// Replaces the TPU kernel vqvaehmm_tpu/ops/pallas_train.py::_kernel and
// the loss assembly and log_prior chain of its wrapper
// (fused_loss_and_grads, :551-600).  The Python wrapper, the
// torch.autograd.Function around it and its plain PyTorch version
// (compute_loss plus autograd) are in vqvaehmm_tpu_torch/ops/fused_train.py.
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
// Design.  Kernel 1 runs one block of 512 threads per sequence.  The
// block walks the model stage by stage over the whole sequence, each
// stage a loop of the block's threads over (channel, time) separated by
// __syncthreads.  The activations of one sequence (709 rows of T floats
// at the published widths, 567 KB at T=200) do not fit in shared
// memory, so they live in a device scratch the wrapper allocates (36 MB
// at B=64, T=200, which fits in the 50 MB L2); a block reads back only
// what it wrote itself, mostly from its SM's L1.  The weight gradients
// of a sequence are sums over its T steps: each thread owns whole
// entries and sums them in time order, and the block writes them to its
// own row of a (B, P) partials array, and its three loss sums (in
// double, a fixed tree over the threads) to a (B, 3) array.  Kernel 2
// sums the partials over the sequences in index order, applies the
// log_prior chain and assembles the loss.  No float atomics: the same inputs give the same
// bits on every call.
//
// Bound.  About 2.5 GFLOP a step at B=64, T=200 (the forward is about
// 65 kFLOP a token, the backward twice that), all fp32 FMA on the CUDA
// cores.  With one block a sequence, B=64 fills 64 of the 132 SMs, and
// the FMAs of the convolutions and of the weight gradients each need one
// to two loads from L1 or L2: the kernel is bound by those loads and by
// the idle SMs, not by the fp32 rate or by device memory.  The design
// does two things about it: a convolution thread computes JB neighbouring
// steps, so a weight and its input window serve 3*JB FMAs, and a
// conv-weight-gradient thread owns the three taps of an (o, i) pair and
// slides its input window, so a step costs two loads for three FMAs.
// More blocks a sequence (time tiles with halos) and tensor cores are
// left for later work.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;
constexpr int JB = 4;       // time steps per thread in a convolution
constexpr int KMAX = 16;    // regimes a thread keeps in registers
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

// Rows of T floats of one sequence's scratch.
__host__ __device__ inline long long scratch_rows(const Dims& d) {
  const int G = maxi(maxi(d.D, d.H1), maxi(d.H2, d.HP));
  return (long long)d.H1 + d.H2 + 3 * d.K + d.HP + 2 * d.K * d.K + 3 * d.D +
         2 * d.C + 2 * G;
}

// out[o][t] = relu(b[o] + sum_{i,k} w[o][i][k] in[i][t-1+k]), in read as
// zero outside [0, in_to); out zeroed at t >= out_to.
__device__ void conv3_fwd(const float* __restrict__ w,
                          const float* __restrict__ bias, const float* in,
                          int I, int in_to, float* out, int O, int T,
                          int out_to) {
  const int groups = (T + JB - 1) / JB;
  for (int idx = threadIdx.x; idx < O * groups; idx += blockDim.x) {
    const int o = idx / groups;
    const int t0 = (idx - o * groups) * JB;
    const float* wo = w + (long long)o * I * 3;
    float acc[JB];
#pragma unroll
    for (int r = 0; r < JB; ++r) acc[r] = 0.f;
    for (int i = 0; i < I; ++i) {
      const float w0 = __ldg(wo + 3 * i);
      const float w1 = __ldg(wo + 3 * i + 1);
      const float w2 = __ldg(wo + 3 * i + 2);
      const float* row = in + (long long)i * T;
      float v[JB + 2];
#pragma unroll
      for (int r = 0; r < JB + 2; ++r) {
        const int p = t0 - 1 + r;
        v[r] = (p >= 0 && p < in_to) ? row[p] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < JB; ++r)
        acc[r] = fmaf(w2, v[r + 2], fmaf(w1, v[r + 1], fmaf(w0, v[r], acc[r])));
    }
    const float bo = __ldg(bias + o);
#pragma unroll
    for (int r = 0; r < JB; ++r) {
      const int t = t0 + r;
      if (t < T) out[(long long)o * T + t] = t < out_to ? fmaxf(acc[r] + bo, 0.f) : 0.f;
    }
  }
}

// din[i][s] = sum_{o,k} w[o][i][k] dy[o][s+1-k] (dy zero outside [0, T)),
// kept where gate[i][s] > 0 (the ReLU of the layer below) and s < to.
__device__ void conv3_bwd_input(const float* __restrict__ w, const float* dy,
                                int O, float* din, int I, int T,
                                const float* gate, int to) {
  const int groups = (T + JB - 1) / JB;
  for (int idx = threadIdx.x; idx < I * groups; idx += blockDim.x) {
    const int i = idx / groups;
    const int s0 = (idx - i * groups) * JB;
    float acc[JB];
#pragma unroll
    for (int r = 0; r < JB; ++r) acc[r] = 0.f;
    for (int o = 0; o < O; ++o) {
      const float* wo = w + ((long long)o * I + i) * 3;
      const float w0 = __ldg(wo), w1 = __ldg(wo + 1), w2 = __ldg(wo + 2);
      const float* row = dy + (long long)o * T;
      float v[JB + 2];   // v[r] = dy[o][s0 - 1 + r]
#pragma unroll
      for (int r = 0; r < JB + 2; ++r) {
        const int p = s0 - 1 + r;
        v[r] = (p >= 0 && p < T) ? row[p] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < JB; ++r)
        acc[r] = fmaf(w2, v[r], fmaf(w1, v[r + 1], fmaf(w0, v[r + 2], acc[r])));
    }
#pragma unroll
    for (int r = 0; r < JB; ++r) {
      const int s = s0 + r;
      if (s < T) {
        const long long at = (long long)i * T + s;
        din[at] = (s < to && (gate == nullptr || gate[at] > 0.f)) ? acc[r] : 0.f;
      }
    }
  }
}

// gw[o][i][k] = sum_t dy[o][t] in[i][t-1+k] (in zero outside [0, in_to))
// and gb[o] = sum_t dy[o][t], in time order.
__device__ void conv3_bwd_weight(const float* dy, int O, const float* in,
                                 int I, int in_to, int T, float* gw,
                                 float* gb) {
  for (int idx = threadIdx.x; idx < O * I + O; idx += blockDim.x) {
    if (idx < O * I) {
      const int o = idx / I, i = idx - o * I;
      const float* d = dy + (long long)o * T;
      const float* a = in + (long long)i * T;
      float g0 = 0.f, g1 = 0.f, g2 = 0.f;
      float am = 0.f;                                  // in[t-1]
      float a0 = in_to > 0 ? a[0] : 0.f;               // in[t]
      for (int t = 0; t < T; ++t) {
        const float ap = (t + 1 < in_to) ? a[t + 1] : 0.f;   // in[t+1]
        const float dv = d[t];
        g0 = fmaf(dv, am, g0);
        g1 = fmaf(dv, a0, g1);
        g2 = fmaf(dv, ap, g2);
        am = a0;
        a0 = ap;
      }
      gw[(long long)idx * 3] = g0;
      gw[(long long)idx * 3 + 1] = g1;
      gw[(long long)idx * 3 + 2] = g2;
    } else {
      const int o = idx - O * I;
      const float* d = dy + (long long)o * T;
      float g = 0.f;
      for (int t = 0; t < T; ++t) g += d[t];
      gb[o] = g;
    }
  }
}

// gw[o][i] = sum_t dy[o][t] in(i, t) and gb[o] = sum_t dy[o][t], in time
// order; in(i, t) = in[i * s_i + t * s_t].
__device__ void dense_bwd_weight(const float* dy, int O, const float* in,
                                 long long s_i, long long s_t, int I, int T,
                                 float* gw, float* gb) {
  for (int idx = threadIdx.x; idx < O * I + O; idx += blockDim.x) {
    if (idx < O * I) {
      const int o = idx / I, i = idx - o * I;
      const float* d = dy + (long long)o * T;
      const float* a = in + i * s_i;
      float g = 0.f;
      for (int t = 0; t < T; ++t) g = fmaf(d[t], a[t * s_t], g);
      gw[idx] = g;
    } else if (gb != nullptr) {
      const int o = idx - O * I;
      const float* d = dy + (long long)o * T;
      float g = 0.f;
      for (int t = 0; t < T; ++t) g += d[t];
      gb[o] = g;
    }
  }
}

// din[i][t] = (sum_o w[o][i] dy[o][t]) kept where gate[i][t] > 0.
__device__ void dense_bwd_input(const float* __restrict__ w, const float* dy,
                                int O, float* din, int I, int T,
                                const float* gate) {
  for (int idx = threadIdx.x; idx < I * T; idx += blockDim.x) {
    const int i = idx / T, t = idx - i * T;
    float acc = 0.f;
    for (int o = 0; o < O; ++o)
      acc = fmaf(__ldg(w + (long long)o * I + i), dy[(long long)o * T + t], acc);
    din[idx] = gate[idx] > 0.f ? acc : 0.f;
  }
}

__global__ void __launch_bounds__(THREADS) fused_train_kernel(
    const float* __restrict__ x, const float* __restrict__ u,
    const int* __restrict__ lengths, Weights W, Dims d, float beta,
    float* __restrict__ scratch, float* __restrict__ partials,
    double* __restrict__ loss_partials) {
  __shared__ double red[3][THREADS];
  __shared__ float logpi_s[KMAX];
  __shared__ float scal[3];
  __shared__ int vt_s;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = d.T, C = d.C, K = d.K, KK = d.K * d.K;
  const Offsets off = offsets(d);
  float* part = partials + (long long)b * off.P;

  // scratch rows of this sequence
  const int G = maxi(maxi(d.D, d.H1), maxi(d.H2, d.HP));
  float* h1 = scratch + (long long)b * scratch_rows(d) * T;
  float* h2 = h1 + (long long)d.H1 * T;
  float* q = h2 + (long long)d.H2 * T;
  float* lq = q + (long long)K * T;
  float* dl = lq + (long long)K * T;        // d logits
  float* hp = dl + (long long)K * T;
  float* la = hp + (long long)d.HP * T;     // log_A rows (i*K+j)
  float* dap = la + (long long)KK * T;      // d pre-softmax transition logits
  float* e = dap + (long long)KK * T;
  float* hd1 = e + (long long)d.D * T;
  float* hd2 = hd1 + (long long)d.D * T;
  float* dout = hd2 + (long long)d.D * T;   // d (mu, logvar)
  float* gA = dout + (long long)2 * C * T;
  float* gB = gA + (long long)G * T;

  const float* xb = x + (long long)b * C * T;
  const float* ub = u + (long long)b * d.u_sb;
  const int L = lengths[b];

  if (tid == 0) {
    int vt = 0;
    float msum = 0.f;
    for (int i = 0; i < d.B; ++i) {
      const int li = lengths[i];
      vt = li > vt ? li : vt;
      msum += (float)(li < 0 ? 0 : (li > T ? T : li));
    }
    vt_s = vt;
    scal[0] = 1.0f / fmaxf(msum * (float)C, 1.0f);   // s_r
    scal[1] = -beta / (float)d.B;                     // s_p
    scal[2] = beta / (float)d.B;                      // s_h
    float m = -INFINITY;
    for (int k = 0; k < K; ++k) m = fmaxf(m, W.logprior[k]);
    float z = 0.f;
    for (int k = 0; k < K; ++k) z += expf(W.logprior[k] - m);
    const float lse = logf(z) + m;
    for (int k = 0; k < K; ++k) logpi_s[k] = W.logprior[k] - lse;
  }
  __syncthreads();
  const int vt = vt_s < T ? vt_s : T;
  const float s_r = scal[0], s_p = scal[1], s_h = scal[2];
  double p_nll = 0.0, p_prior = 0.0, p_qlogq = 0.0;

  // ---------------- forward ----------------
  // h1 = relu(conv1(x masked at valid_to)), masked
  conv3_fwd(W.ew1, W.eb1, xb, C, vt, h1, d.H1, T, vt);
  // hp = relu(fc1(u)), in the same phase (independent of h1)
  for (int idx = tid; idx < d.HP * T; idx += blockDim.x) {
    const int j = idx / T, t = idx - j * T;
    float acc = 0.f;
    for (int c = 0; c < d.U; ++c)
      acc = fmaf(__ldg(W.pw1 + (long long)j * d.U + c), ub[c * d.u_sc + t * d.u_st], acc);
    hp[idx] = fmaxf(acc + __ldg(W.pb1 + j), 0.f);
  }
  __syncthreads();
  // h2 = relu(conv2(h1)), not masked; transition logits fc2(hp)
  conv3_fwd(W.ew2, W.eb2, h1, d.H1, T, h2, d.H2, T, T);
  for (int idx = tid; idx < KK * T; idx += blockDim.x) {
    const int r = idx / T, t = idx - r * T;
    float acc = 0.f;
    for (int j = 0; j < d.HP; ++j)
      acc = fmaf(__ldg(W.pw2 + (long long)r * d.HP + j), hp[(long long)j * T + t], acc);
    la[idx] = acc + __ldg(W.pb2 + r);
  }
  __syncthreads();
  // logits -> log q, q per step; log_softmax of each transition row
  for (int t = tid; t < T; t += blockDim.x) {
    float lg[KMAX];
    float m = -INFINITY;
    for (int k = 0; k < K; ++k) {
      const float* wk = W.ew3 + (long long)k * d.H2;
      float acc = 0.f;
      for (int i = 0; i < d.H2; ++i) acc = fmaf(__ldg(wk + i), h2[(long long)i * T + t], acc);
      lg[k] = acc + __ldg(W.eb3 + k);
      m = fmaxf(m, lg[k]);
    }
    float z = 0.f;
    for (int k = 0; k < K; ++k) z += expf(lg[k] - m);
    const float lse = logf(z) + m;
    for (int k = 0; k < K; ++k) {
      const float l = lg[k] - lse;
      lq[(long long)k * T + t] = l;
      q[(long long)k * T + t] = expf(l);
    }
  }
  for (int idx = tid; idx < K * T; idx += blockDim.x) {
    const int i = idx / T, t = idx - i * T;
    float m = -INFINITY;
    for (int j = 0; j < K; ++j) m = fmaxf(m, la[(long long)(i * K + j) * T + t]);
    float z = 0.f;
    for (int j = 0; j < K; ++j) z += expf(la[(long long)(i * K + j) * T + t] - m);
    const float lse = logf(z) + m;
    for (int j = 0; j < K; ++j) la[(long long)(i * K + j) * T + t] -= lse;
  }
  __syncthreads();
  // e = E^T q, masked at valid_to
  for (int idx = tid; idx < d.D * T; idx += blockDim.x) {
    const int dd = idx / T, t = idx - dd * T;
    float acc = 0.f;
    for (int k = 0; k < K; ++k)
      acc = fmaf(q[(long long)k * T + t], __ldg(W.emb + (long long)k * d.D + dd), acc);
    e[idx] = t < vt ? acc : 0.f;
  }
  __syncthreads();
  // hd1 = relu(dconv1(e)), masked; hd2 = relu(dconv2(hd1)), not masked
  conv3_fwd(W.dw1, W.db1, e, d.D, T, hd1, d.D, T, vt);
  __syncthreads();
  conv3_fwd(W.dw2, W.db2, hd1, d.D, T, hd2, d.D, T, T);
  __syncthreads();
  // (mu, logvar), the Gaussian NLL and its gradient
  for (int idx = tid; idx < C * T; idx += blockDim.x) {
    const int c = idx / T, t = idx - c * T;
    const float* wm = W.dw3 + (long long)c * d.D;
    const float* wv = W.dw3 + (long long)(C + c) * d.D;
    float am = 0.f, av = 0.f;
    for (int i = 0; i < d.D; ++i) {
      const float h = hd2[(long long)i * T + t];
      am = fmaf(__ldg(wm + i), h, am);
      av = fmaf(__ldg(wv + i), h, av);
    }
    const float mu = am + __ldg(W.db3 + c);
    const float lv = av + __ldg(W.db3 + C + c);
    const float ev = expf(lv);
    const float var = fmaxf(ev, 1e-8f);
    const float diff = mu - xb[idx];
    const float r = diff * diff / var;
    const float mf = t < L ? 1.f : 0.f;
    p_nll += 0.5f * (LOG2PI + logf(var) + r) * mf;
    dout[idx] = s_r * mf * diff / var;
    dout[(long long)C * T + idx] = ev > 1e-8f ? s_r * mf * 0.5f * (1.f - r) : 0.f;
  }
  __syncthreads();

  // ---------------- backward ----------------
  // to_params: weight and bias gradients; dhd2 gated by its ReLU -> gA
  dense_bwd_weight(dout, 2 * C, hd2, T, 1, d.D, T, part + off.dw3, part + off.db3);
  dense_bwd_input(W.dw3, dout, 2 * C, gA, d.D, T, hd2);
  __syncthreads();
  // dconv2: weight gradients; dhd1 gated by hd1 (zero past valid_to) -> gB
  conv3_bwd_weight(gA, d.D, hd1, d.D, T, T, part + off.dw2, part + off.db2);
  conv3_bwd_input(W.dw2, gA, d.D, gB, d.D, T, hd1, T);
  __syncthreads();
  // dconv1: weight gradients; de masked at valid_to -> gA
  conv3_bwd_weight(gB, d.D, e, d.D, T, T, part + off.dw1, part + off.db1);
  conv3_bwd_input(W.dw1, gB, d.D, gA, d.D, T, nullptr, vt);
  __syncthreads();
  // embeddings; the prior, entropy and decoder terms of dq -> d logits;
  // d transition logits; the loss sums of the prior and the entropy
  for (int idx = tid; idx < K * d.D; idx += blockDim.x) {
    const int k = idx / d.D, dd = idx - k * d.D;
    const float* de = gA + (long long)dd * T;
    const float* qk = q + (long long)k * T;
    float g = 0.f;
    for (int t = 0; t < T; ++t) g = fmaf(de[t], qk[t], g);
    part[off.emb + idx] = g;
  }
  if (tid < K) part[off.logprior + tid] = s_p * q[(long long)tid * T];
  for (int t = tid; t < T; t += blockDim.x) {
    const float mf = t < L ? 1.f : 0.f;
    const float pm = (t >= 1 && t < L) ? 1.f : 0.f;
    const float pmn = (t + 1 < T && t + 1 < L) ? 1.f : 0.f;   // pm[t+1]
    float qt[KMAX], qp[KMAX], g[KMAX];
    for (int k = 0; k < K; ++k) {
      qt[k] = q[(long long)k * T + t];
      qp[k] = t > 0 ? q[(long long)k * T + t - 1] : 0.f;
    }
    float trans = 0.f, qlogq = 0.f, init = 0.f;
    for (int i = 0; i < K; ++i)
      for (int j = 0; j < K; ++j)
        trans += qp[i] * qt[j] * la[(long long)(i * K + j) * T + t];
    for (int k = 0; k < K; ++k) {
      const float l = lq[(long long)k * T + t];
      qlogq += qt[k] * l;
      // decoder: E de
      float gd = 0.f;
      for (int dd = 0; dd < d.D; ++dd)
        gd = fmaf(__ldg(W.emb + (long long)k * d.D + dd), gA[(long long)dd * T + t], gd);
      // transitions into t (through q[t]) and out of t (through q[t] as
      // the previous step of t+1)
      float in_t = 0.f, out_t = 0.f;
      for (int i = 0; i < K; ++i) in_t += qp[i] * la[(long long)(i * K + k) * T + t];
      if (t + 1 < T)
        for (int j = 0; j < K; ++j)
          out_t += q[(long long)j * T + t + 1] * la[(long long)(k * K + j) * T + t + 1];
      float gq = gd + s_p * pm * in_t + s_p * pmn * out_t + s_h * mf * l;
      if (t == 0) gq += s_p * logpi_s[k];
      g[k] = s_h * mf * qt[k] + gq * qt[k];
    }
    if (t == 0)
      for (int k = 0; k < K; ++k) init += qt[k] * logpi_s[k];
    p_prior += init + trans * pm;
    p_qlogq += qlogq * mf;
    float colsum = 0.f;
    for (int k = 0; k < K; ++k) colsum += g[k];
    for (int k = 0; k < K; ++k) dl[(long long)k * T + t] = g[k] - qt[k] * colsum;
    for (int i = 0; i < K; ++i) {
      float rowsum = 0.f;
      for (int j = 0; j < K; ++j) rowsum += s_p * pm * qp[i] * qt[j];
      for (int j = 0; j < K; ++j) {
        const long long at = (long long)(i * K + j) * T + t;
        dap[at] = s_p * pm * qp[i] * qt[j] - expf(la[at]) * rowsum;
      }
    }
  }
  __syncthreads();
  // to_logits and fc2: weight gradients; dh2 -> gA, dhp -> gB
  dense_bwd_weight(dl, K, h2, T, 1, d.H2, T, part + off.ew3, part + off.eb3);
  dense_bwd_weight(dap, KK, hp, T, 1, d.HP, T, part + off.pw2, part + off.pb2);
  dense_bwd_input(W.ew3, dl, K, gA, d.H2, T, h2);
  dense_bwd_input(W.pw2, dap, KK, gB, d.HP, T, hp);
  __syncthreads();
  // conv2 and fc1: weight gradients
  conv3_bwd_weight(gA, d.H2, h1, d.H1, T, T, part + off.ew2, part + off.eb2);
  dense_bwd_weight(gB, d.HP, ub, d.u_sc, d.u_st, d.U, T, part + off.pw1, part + off.pb1);
  __syncthreads();
  // dh1 gated by h1 (zero past valid_to) -> gB
  conv3_bwd_input(W.ew2, gA, d.H2, gB, d.H1, T, h1, T);
  __syncthreads();
  // conv1: weight gradients against x masked at valid_to
  conv3_bwd_weight(gB, d.H1, xb, C, vt, T, part + off.ew1, part + off.eb1);

  // the block's three loss sums, a fixed tree over the threads
  red[0][tid] = p_nll;
  red[1][tid] = p_prior;
  red[2][tid] = p_qlogq;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (tid < s)
      for (int r = 0; r < 3; ++r) red[r][tid] += red[r][tid + s];
    __syncthreads();
  }
  if (tid < 3) loss_partials[3 * b + tid] = red[tid][0];
}

// grads[p] = sum_b partials[b][p] in index order; the log_prior chain;
// loss from the three sums.
__global__ void __launch_bounds__(256) fused_train_reduce_kernel(
    const float* __restrict__ partials,
    const double* __restrict__ loss_partials,
    const int* __restrict__ lengths, const float* __restrict__ logprior,
    Dims d, float beta, float* __restrict__ grads,
    float* __restrict__ loss) {
  const Offsets off = offsets(d);
  const long long stride = off.P;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p > off.P) return;
  if (p == off.P) {
    double s[3] = {0.0, 0.0, 0.0};
    float msum = 0.f;
    for (int b = 0; b < d.B; ++b) {
      for (int r = 0; r < 3; ++r) s[r] += loss_partials[3 * b + r];
      const int li = lengths[b];
      msum += (float)(li < 0 ? 0 : (li > d.T ? d.T : li));
    }
    const double denom = fmax((double)msum * d.C, 1.0);
    // the prior and entropy sums nearly cancel (each is about T log K a
    // sequence), so they are combined in double before the one rounding
    *loss = (float)(s[0] / denom + (double)beta * (s[2] - s[1]) / d.B);
    return;
  }
  if (p >= off.logprior && p < off.logprior + d.K) {
    // d log_prior = g - softmax(log_prior) * sum(g)
    float g[KMAX];
    float gsum = 0.f;
    for (int k = 0; k < d.K; ++k) {
      float a = 0.f;
      for (int b = 0; b < d.B; ++b) a += partials[b * stride + off.logprior + k];
      g[k] = a;
      gsum += a;
    }
    float m = -INFINITY;
    for (int k = 0; k < d.K; ++k) m = fmaxf(m, logprior[k]);
    float z = 0.f;
    for (int k = 0; k < d.K; ++k) z += expf(logprior[k] - m);
    const int k = (int)(p - off.logprior);
    grads[p] = g[k] - expf(logprior[k] - m) / z * gsum;
    return;
  }
  float a = 0.f;
  for (int b = 0; b < d.B; ++b) a += partials[b * stride + p];
  grads[p] = a;
}

}  // namespace

// what = 0: floats of the flat gradient vector; 1: scratch rows of T.
extern "C" long long vqhmm_fused_train_sizes(int B, int C, int T, int U,
                                             int H1, int H2, int K, int HP,
                                             int D, int what) {
  Dims d{B, C, T, U, H1, H2, K, HP, D, 0, 0, 0};
  return what == 0 ? offsets(d).P : scratch_rows(d);
}

extern "C" int vqhmm_fused_train(
    const float* x, const float* u, long long u_sb, long long u_sc,
    long long u_st, const int* lengths, const float* ew1, const float* eb1,
    const float* ew2, const float* eb2, const float* ew3, const float* eb3,
    const float* logprior, const float* pw1, const float* pb1,
    const float* pw2, const float* pb2, const float* emb, const float* dw1,
    const float* db1, const float* dw2, const float* db2, const float* dw3,
    const float* db3, float* scratch, float* partials,
    double* loss_partials, float* grads, float* loss, int B, int C, int T, int U, int H1, int H2, int K, int HP,
    int D, float beta, void* stream) {
  if (B <= 0 || T <= 0 || K <= 0 || K > KMAX) return (int)cudaErrorInvalidValue;
  Weights W{ew1, eb1, ew2, eb2, ew3, eb3, logprior, pw1, pb1, pw2, pb2,
            emb, dw1, db1, dw2, db2, dw3, db3};
  Dims d{B, C, T, U, H1, H2, K, HP, D, u_sb, u_sc, u_st};
  cudaStream_t s = (cudaStream_t)stream;
  fused_train_kernel<<<B, THREADS, 0, s>>>(x, u, lengths, W, d, beta,
                                           scratch, partials, loss_partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = offsets(d).P + 1;
  fused_train_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      partials, loss_partials, lengths, logprior, d, beta, grads, loss);
  return (int)cudaGetLastError();
}
