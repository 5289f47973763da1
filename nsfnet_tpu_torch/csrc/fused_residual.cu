// Fused NS residual-loss kernel pair for Hopper (sm_90a), fp32 on the CUDA cores.
//
// Replaces the TPU kernels of nsfnet_tpu/ops/pallas_residual.py:
//   loss_fwd_kernel  <- _loss_fwd_kernel (:100, launched by _fused_fwd, pallas_call at :205)
//   loss_bwd_kernel  <- _loss_bwd_kernel (:128, launched by _fused_bwd, pallas_call at :249)
// together with the parts of nsfnet_tpu/ops/pallas_mlp.py they inline
// (_forward_streams, _recompute_forward, _packed_reverse_sweep).
//
// What they compute, for a tanh MLP 2 -> H (x n_hidden) -> 3 and a batch of
// collocation points x[N,2]:
//   forward : the packed value + 4 Taylor streams through every layer, the
//             (u, v, p) derivative streams at the head, the NS / EVM residual
//             algebra eq1..eq4, and S_i = sum_n eq_w[n] * eq_i[n]^2 (3 or 4 sums).
//   backward: recompute the forward, turn the loss cotangents ct[i] into
//             per-point residual cotangents, write g_e = -g_eq4 (the EVM
//             net's cotangent stream), chain them to the five head-stream
//             cotangents and run the packed reverse sweep -> dW / db of every
//             layer, in the flat parameter layout of models/mlp.py.
//
// What bounds them on this card: operations. Per point the forward does
// ~0.32 MFLOP of matrix products (5 streams x 2*H*H per hidden layer) and
// the backward ~0.97 MFLOP, against ~20 B of per-point input, so both sit
// three orders of magnitude above the fp32 ridge point. This first version
// runs those products as fp32 FMAs on the CUDA cores (67 TFLOP/s peak);
// tensor-core passes (wgmma, TF32 / bf16x3) are later work.
//
// Design:
//   * A tile of T points (T <= 16, chosen by the wrapper so that shared
//     memory fits) keeps two packed carries [5][T][H] and the current
//     weight matrix (row stride H+1, so both its row and its column reads
//     are free of bank conflicts) in shared memory. A thread owns one
//     (point, unit) pair and computes all five streams of it, so the tanh
//     algebra is fused into the product's epilogue.
//   * The TPU kernels accumulate into revisited output blocks over an
//     ordered grid. Here a FIXED number of blocks (n_blocks, a constant of
//     the wrapper, not the SM count) loops over tiles b, b+n_blocks, ...;
//     each block writes one partial (4 loss sums, or a full gradient
//     vector), and a second pass sums the partials in block order in
//     double precision. No atomics: equal inputs give bitwise-equal outputs.
//   * The backward needs every layer's packed carry and pre-activation
//     tangents (about 16 KB per point at 6x80), more than shared memory
//     holds for a useful tile. They go to a block-private global scratch
//     that the wrapper allocates, written once by the recompute and read
//     once by the reverse sweep.
//   * The first layer is the analytic broadcast (z_x, z_y are the rows of
//     W0, z_xx = z_yy = 0), never a K=2 product; its dW0 gets the direct
//     tangent terms of pallas_mlp.py:296-310.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90

struct Shapes {
  int n_hidden;  // tanh layers: the analytic first layer + n_hidden-1 products
  int h;         // hidden width
  int k;         // head outputs (3: u, v, p)
  int tile;      // points per tile
};

// Flat parameter layout (models/mlp.py flatten_params):
//   W0[2,h] b0[h] | W1[h,h] b1[h] | ... | W_{L-1}[h,h] b_{L-1}[h] | Wh[h,k] bh[k]
__host__ __device__ inline long hidden_off(int l, int h) {  // W_l, l >= 1
  return 3L * h + (long)(l - 1) * ((long)h * h + h);
}
__host__ __device__ inline long head_off(int n_hidden, int h) { return hidden_off(n_hidden, h); }
__host__ __device__ inline long n_params(int n_hidden, int h, int k) {
  return head_off(n_hidden, h) + (long)h * k + k;
}

inline size_t smem_floats(int tile, int h, int k) {
  // two packed carries, the staged weight, loss terms, head streams
  return 10ul * tile * h + (size_t)h * (h + 1) + 4ul * tile + 5ul * tile * k;
}

__host__ __device__ inline long scratch_floats(int tile, int h, int n_hidden) {
  // one block's backward store: the packed carry [5T,h] of each of the L
  // tanh layers, then the pre-activation tangents [4T,h] of the L-1 product
  // layers (the analytic first layer has none)
  return (long)(9 * n_hidden - 4) * tile * h;
}

__device__ void stage_weight(float* ws, const float* __restrict__ w, int h) {
  for (int i = threadIdx.x; i < h * h; i += blockDim.x) {
    int r = i / h;
    ws[r * (h + 1) + (i - r * h)] = w[i];
  }
}

// Analytic first layer -> packed carry [t; s wx; s wy; c wx^2; c wy^2].
__device__ void first_layer(const float* __restrict__ x, long n0,
                            const float* __restrict__ w0, const float* __restrict__ b0,
                            float* out, float* store, int tile, int h) {
  const int S = tile * h;
  for (int idx = threadIdx.x; idx < S; idx += blockDim.x) {
    int p = idx / h, j = idx - p * h;
    float px = x[2 * (n0 + p)], py = x[2 * (n0 + p) + 1];
    float wx = w0[j], wy = w0[h + j];
    float z = px * wx + py * wy + b0[j];
    float t = tanhf(z);
    float s = 1.0f - t * t;
    float c = -2.0f * t * s;
    float v[5] = {t, s * wx, s * wy, c * (wx * wx), c * (wy * wy)};
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      out[q * S + idx] = v[q];
      if (store) store[q * S + idx] = v[q];
    }
  }
}

// One hidden transition on packed carries: Z = P W (+ b on the value rows),
// then the tanh Taylor algebra. Optionally keeps the new carry and the
// pre-activation tangents [4][T][h] for the reverse sweep.
__device__ void hidden_layer(const float* in, float* out, const float* ws,
                             const float* __restrict__ b, float* pack_store,
                             float* ztan_store, int tile, int h) {
  const int S = tile * h;
  const int hp = h + 1;
  for (int idx = threadIdx.x; idx < S; idx += blockDim.x) {
    int p = idx / h, j = idx - p * h;
    const float* r = in + p * h;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f, a4 = 0.f;
    for (int kk = 0; kk < h; ++kk) {
      float w = ws[kk * hp + j];
      a0 += r[kk] * w;
      a1 += r[S + kk] * w;
      a2 += r[2 * S + kk] * w;
      a3 += r[3 * S + kk] * w;
      a4 += r[4 * S + kk] * w;
    }
    float t = tanhf(a0 + b[j]);
    float s = 1.0f - t * t;
    float c = -2.0f * t * s;
    float v[5] = {t, s * a1, s * a2, c * a1 * a1 + s * a3, c * a2 * a2 + s * a4};
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      out[q * S + idx] = v[q];
      if (pack_store) pack_store[q * S + idx] = v[q];
    }
    if (ztan_store) {
      ztan_store[idx] = a1;
      ztan_store[S + idx] = a2;
      ztan_store[2 * S + idx] = a3;
      ztan_store[3 * S + idx] = a4;
    }
  }
}

// Head product on the last packed carry -> five [T][k] streams in hb.
__device__ void head_layer(const float* in, const float* __restrict__ wh,
                           const float* __restrict__ bh, float* hb, int tile, int h, int k) {
  const int S = tile * h;
  const int TK = tile * k;
  for (int idx = threadIdx.x; idx < TK; idx += blockDim.x) {
    int p = idx / k, kk = idx - p * k;
    const float* r = in + p * h;
    float a[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    for (int m = 0; m < h; ++m) {
      float w = wh[m * k + kk];
#pragma unroll
      for (int q = 0; q < 5; ++q) a[q] += r[q * S + m] * w;
    }
    a[0] += bh[kk];
#pragma unroll
    for (int q = 0; q < 5; ++q) hb[q * TK + idx] = a[q];
  }
}

struct Res {
  float u, v, ux, uy, vx, vy, nu, eq1, eq2, eq3, eq4;
};

// NS / EVM residual algebra of ops/residuals.py at one point p.
__device__ Res residual_at(const float* hb, int p, int tile, int k, float e, float vt,
                           float re, float scale, bool evm) {
  const int TK = tile * k;
  const float* o = hb + p * k;
  const float* ox = o + TK;
  const float* oy = o + 2 * TK;
  const float* oxx = o + 3 * TK;
  const float* oyy = o + 4 * TK;
  const float ss = scale * scale;
  Res r;
  r.u = o[0];
  r.v = o[1];
  r.ux = ox[0] * scale;
  r.vx = ox[1] * scale;
  float p_x = ox[2] * scale;
  r.uy = oy[0] * scale;
  r.vy = oy[1] * scale;
  float p_y = oy[2] * scale;
  float u_xx = oxx[0] * ss, v_xx = oxx[1] * ss;
  float u_yy = oyy[0] * ss, v_yy = oyy[1] * ss;
  r.nu = evm ? (1.0f / re + vt) : (1.0f / re);
  r.eq1 = (r.u * r.ux + r.v * r.uy) + p_x - r.nu * (u_xx + u_yy);
  r.eq2 = (r.u * r.vx + r.v * r.vy) + p_y - r.nu * (v_xx + v_yy);
  r.eq3 = r.ux + r.vy;
  r.eq4 = evm ? (r.eq1 * (r.u - 0.5f) + r.eq2 * (r.v - 0.5f)) - e : 0.f;
  return r;
}

// Packed forward through the hidden layers; leaves the last carry in the
// returned buffer. With store != nullptr, keeps every carry and tangent.
__device__ float* forward_tile(const float* __restrict__ x, const float* __restrict__ flat,
                               long n0, const Shapes& sh, float* buf_a, float* buf_b,
                               float* ws, float* store) {
  const int h = sh.h, S = sh.tile * h, L = sh.n_hidden;
  float* packs = store;
  float* ztans = store ? store + 5L * L * S : nullptr;
  first_layer(x, n0, flat, flat + 2 * h, buf_a, packs, sh.tile, h);
  float* cur = buf_a;
  float* nxt = buf_b;
  for (int l = 1; l < L; ++l) {
    const float* w = flat + hidden_off(l, h);
    stage_weight(ws, w, h);
    __syncthreads();
    hidden_layer(cur, nxt, ws, w + (long)h * h,
                 store ? packs + 5L * l * S : nullptr,
                 store ? ztans + 4L * (l - 1) * S : nullptr, sh.tile, h);
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  return cur;
}

__global__ void __launch_bounds__(kThreads)
loss_fwd_kernel(const float* __restrict__ x, const float* __restrict__ flat,
                const float* __restrict__ e, const float* __restrict__ vis_t,
                const float* __restrict__ eq_w, int n, Shapes sh, float re,
                float scale, int evm, float* partial) {
  extern __shared__ float smem[];
  const int T = sh.tile, h = sh.h, k = sh.k, S = T * h;
  float* buf_a = smem;
  float* buf_b = buf_a + 5 * S;
  float* ws = buf_b + 5 * S;
  float* red = ws + h * (h + 1);
  float* hb = red + 4 * T;
  const int n_out = evm ? 4 : 3;
  const long wh = head_off(sh.n_hidden, h);
  float acc = 0.f;

  const int n_tiles = n / T;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long n0 = (long)tile * T;
    __syncthreads();  // the previous tile's readers of buf_a / red are done
    float* cur = forward_tile(x, flat, n0, sh, buf_a, buf_b, ws, nullptr);
    __syncthreads();
    head_layer(cur, flat + wh, flat + wh + (long)h * k, hb, T, h, k);
    __syncthreads();
    for (int p = threadIdx.x; p < T; p += blockDim.x) {
      const long i = n0 + p;
      Res r = residual_at(hb, p, T, k, evm ? e[i] : 0.f, evm ? vis_t[i] : 0.f,
                          re, scale, evm != 0);
      const float w = eq_w[i];
      red[p] = w * r.eq1 * r.eq1;
      red[T + p] = w * r.eq2 * r.eq2;
      red[2 * T + p] = w * r.eq3 * r.eq3;
      red[3 * T + p] = w * r.eq4 * r.eq4;
    }
    __syncthreads();
    if (threadIdx.x < n_out) {
      float s = 0.f;
      for (int p = 0; p < T; ++p) s += red[threadIdx.x * T + p];
      acc += s;
    }
  }
  if (threadIdx.x < 4) partial[blockIdx.x * 4 + threadIdx.x] = threadIdx.x < n_out ? acc : 0.f;
}

__global__ void __launch_bounds__(kThreads)
loss_bwd_kernel(const float* __restrict__ x, const float* __restrict__ flat,
                const float* __restrict__ e, const float* __restrict__ vis_t,
                const float* __restrict__ eq_w, int n, Shapes sh, float re,
                float scale, int evm, const float* __restrict__ ct,
                float* scratch, float* dpart, float* g_e) {
  extern __shared__ float smem[];
  const int T = sh.tile, h = sh.h, k = sh.k, L = sh.n_hidden, S = T * h, TK = T * k;
  float* buf_a = smem;
  float* buf_b = buf_a + 5 * S;
  float* ws = buf_b + 5 * S;
  float* hb = ws + h * (h + 1) + 4 * T;
  const long P = n_params(L, h, k);
  float* dp = dpart + blockIdx.x * P;
  float* store = scratch + blockIdx.x * scratch_floats(T, h, L);
  const long wh = head_off(L, h);
  const float* whp = flat + wh;
  const float ss = scale * scale;
  const float c0 = ct[0], c1 = ct[1], c2 = ct[2], c3 = evm ? ct[3] : 0.f;

  for (long i = threadIdx.x; i < P; i += blockDim.x) dp[i] = 0.f;

  const int n_tiles = n / T;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long n0 = (long)tile * T;
    __syncthreads();
    float* cur = forward_tile(x, flat, n0, sh, buf_a, buf_b, ws, store);
    float* other = cur == buf_a ? buf_b : buf_a;
    __syncthreads();
    head_layer(cur, whp, whp + (long)h * k, hb, T, h, k);
    __syncthreads();

    // per-point loss cotangents -> head-stream cotangents, in place in hb
    for (int p = threadIdx.x; p < T; p += blockDim.x) {
      const long i = n0 + p;
      Res r = residual_at(hb, p, T, k, evm ? e[i] : 0.f, evm ? vis_t[i] : 0.f,
                          re, scale, evm != 0);
      const float w = eq_w[i];
      float g1, g2, g3, gu, gv;
      if (evm) {
        float g4 = 2.0f * (w * r.eq4) * c3;
        g1 = 2.0f * (w * r.eq1) * c0 + g4 * (r.u - 0.5f);
        g2 = 2.0f * (w * r.eq2) * c1 + g4 * (r.v - 0.5f);
        g3 = 2.0f * (w * r.eq3) * c2;
        g_e[i] = -g4;
        gu = g1 * r.ux + g2 * r.vx + g4 * r.eq1;
        gv = g1 * r.uy + g2 * r.vy + g4 * r.eq2;
      } else {
        g1 = 2.0f * (w * r.eq1) * c0;
        g2 = 2.0f * (w * r.eq2) * c1;
        g3 = 2.0f * (w * r.eq3) * c2;
        gu = g1 * r.ux + g2 * r.vx;
        gv = g1 * r.uy + g2 * r.vy;
      }
      float* o = hb + p * k;
      o[0] = gu;
      o[1] = gv;
      o[2] = 0.f;
      o[TK + 0] = (g1 * r.u + g3) * scale;
      o[TK + 1] = (g2 * r.u) * scale;
      o[TK + 2] = g1 * scale;
      o[2 * TK + 0] = (g1 * r.v) * scale;
      o[2 * TK + 1] = (g2 * r.v + g3) * scale;
      o[2 * TK + 2] = g2 * scale;
      o[3 * TK + 0] = (-g1 * r.nu) * ss;
      o[3 * TK + 1] = (-g2 * r.nu) * ss;
      o[3 * TK + 2] = 0.f;
      o[4 * TK + 0] = (-g1 * r.nu) * ss;
      o[4 * TK + 1] = (-g2 * r.nu) * ss;
      o[4 * TK + 2] = 0.f;
    }
    __syncthreads();

    // head backward: dWh = P^T G, dbh = sum of the value rows, G_in = G Wh^T
    for (int idx = threadIdx.x; idx < h * k; idx += blockDim.x) {
      int m = idx / k, kk = idx - m * k;
      float a = 0.f;
      for (int q = 0; q < 5; ++q)
        for (int p = 0; p < T; ++p) a += cur[q * S + p * h + m] * hb[q * TK + p * k + kk];
      dp[wh + idx] += a;
    }
    for (int kk = threadIdx.x; kk < k; kk += blockDim.x) {
      float a = 0.f;
      for (int p = 0; p < T; ++p) a += hb[p * k + kk];
      dp[wh + (long)h * k + kk] += a;
    }
    for (int idx = threadIdx.x; idx < S; idx += blockDim.x) {
      int p = idx / h, m = idx - p * h;
#pragma unroll
      for (int q = 0; q < 5; ++q) {
        float a = 0.f;
        for (int kk = 0; kk < k; ++kk) a += hb[q * TK + p * k + kk] * whp[m * k + kk];
        other[q * S + idx] = a;
      }
    }
    __syncthreads();

    float* g = other;  // packed carry cotangents [5][T][h]
    float* z = cur;    // packed pre-activation cotangents
    const float* packs = store;
    const float* ztans = store + 5L * L * S;
    for (int l = L - 1; l >= 1; --l) {
      const float* w = flat + hidden_off(l, h);
      stage_weight(ws, w, h);
      const float* pk = packs + 5L * l * S;
      const float* zt = ztans + 4L * (l - 1) * S;
      for (int idx = threadIdx.x; idx < S; idx += blockDim.x) {
        float t = pk[idx];
        float s = 1.0f - t * t;
        float c = -2.0f * t * s;
        float u6 = (6.0f * t * t - 2.0f) * s;
        float zx = zt[idx], zy = zt[S + idx], zxx = zt[2 * S + idx], zyy = zt[3 * S + idx];
        float gh = g[idx], ghx = g[S + idx], ghy = g[2 * S + idx];
        float ghxx = g[3 * S + idx], ghyy = g[4 * S + idx];
        z[idx] = gh * s + (ghx * zx + ghy * zy) * c + ghxx * (u6 * zx * zx + c * zxx) +
                 ghyy * (u6 * zy * zy + c * zyy);
        z[S + idx] = ghx * s + 2.0f * ghxx * c * zx;
        z[2 * S + idx] = ghy * s + 2.0f * ghyy * c * zy;
        z[3 * S + idx] = ghxx * s;
        z[4 * S + idx] = ghyy * s;
      }
      __syncthreads();
      const float* pin = packs + 5L * (l - 1) * S;
      for (int idx = threadIdx.x; idx < h * h; idx += blockDim.x) {
        int m = idx / h, j = idx - m * h;
        float a = 0.f;
        for (int q = 0; q < 5; ++q)
          for (int p = 0; p < T; ++p) a += pin[q * S + p * h + m] * z[q * S + p * h + j];
        dp[hidden_off(l, h) + idx] += a;
      }
      for (int j = threadIdx.x; j < h; j += blockDim.x) {
        float a = 0.f;
        for (int p = 0; p < T; ++p) a += z[p * h + j];
        dp[hidden_off(l, h) + (long)h * h + j] += a;
      }
      const int hp = h + 1;
      for (int idx = threadIdx.x; idx < S; idx += blockDim.x) {
        int p = idx / h, m = idx - p * h;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f, a4 = 0.f;
        const float* zr = z + p * h;
        for (int j = 0; j < h; ++j) {
          float wv = ws[m * hp + j];
          a0 += zr[j] * wv;
          a1 += zr[S + j] * wv;
          a2 += zr[2 * S + j] * wv;
          a3 += zr[3 * S + j] * wv;
          a4 += zr[4 * S + j] * wv;
        }
        g[idx] = a0;
        g[S + idx] = a1;
        g[2 * S + idx] = a2;
        g[3 * S + idx] = a3;
        g[4 * S + idx] = a4;
      }
      __syncthreads();
    }

    // first layer (analytic tangents), with the direct dW0 terms
    for (int j = threadIdx.x; j < h; j += blockDim.x) {
      const float wx = flat[j], wy = flat[h + j];
      float ax = 0.f, ay = 0.f, ab = 0.f;
      for (int p = 0; p < T; ++p) {
        const int idx = p * h + j;
        float t0 = packs[idx];
        float s0 = 1.0f - t0 * t0;
        float c0l = -2.0f * t0 * s0;
        float u0 = (6.0f * t0 * t0 - 2.0f) * s0;
        float gh = g[idx], ghx = g[S + idx], ghy = g[2 * S + idx];
        float ghxx = g[3 * S + idx], ghyy = g[4 * S + idx];
        float gz0 = gh * s0 + (ghx * wx + ghy * wy) * c0l + (ghxx * (wx * wx) + ghyy * (wy * wy)) * u0;
        const float px = x[2 * (n0 + p)], py = x[2 * (n0 + p) + 1];
        ax += px * gz0 + ghx * s0 + 2.0f * ghxx * c0l * wx;
        ay += py * gz0 + ghy * s0 + 2.0f * ghyy * c0l * wy;
        ab += gz0;
      }
      dp[j] += ax;
      dp[h + j] += ay;
      dp[2 * h + j] += ab;
    }
  }
}

// out[i] = sum over blocks b (in order) of partial[b * width + i], in double.
__global__ void sum_partials(const float* __restrict__ partial, int n_blocks, long width,
                             long n_cols, float* out) {
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_cols) return;
  double s = 0.0;
  for (int b = 0; b < n_blocks; ++b) s += (double)partial[b * width + i];
  out[i] = (float)s;
}

int check_launch_args(int n, int h, int k, int tile, int n_hidden, int n_blocks, size_t smem) {
  if (tile <= 0 || n % tile != 0 || h <= 0 || k != 3 || n_hidden < 1 || n_blocks <= 0 ||
      smem > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" {

// Shared memory one block of either kernel uses, in bytes.
int nsf_fused_loss_smem_bytes(int tile, int h, int k) {
  return (int)(smem_floats(tile, h, k) * sizeof(float));
}

// Floats of backward scratch one block uses; the wrapper allocates n_blocks of them.
long nsf_fused_loss_scratch_floats(int tile, int h, int n_hidden) {
  return scratch_floats(tile, h, n_hidden);
}

// Forward: out[0..n_out) = per-equation weighted sums of squares.
// partial: [n_blocks, 4] scratch. Returns a cudaError_t code (0 = launched).
int nsf_fused_loss_fwd(const float* x, const float* flat, const float* e, const float* vis_t,
                       const float* eq_w, int n, int n_hidden, int h, int k, int tile,
                       int n_blocks, float re, float scale, int evm, float* partial,
                       float* out, void* stream) {
  const size_t smem = smem_floats(tile, h, k) * sizeof(float);
  int bad = check_launch_args(n, h, k, tile, n_hidden, n_blocks, smem);
  if (bad) return bad;
  cudaError_t err = cudaFuncSetAttribute(loss_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Shapes sh{n_hidden, h, k, tile};
  loss_fwd_kernel<<<n_blocks, kThreads, smem, s>>>(x, flat, e, vis_t, eq_w, n, sh, re, scale,
                                                   evm, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials<<<1, 32, 0, s>>>(partial, n_blocks, 4, evm ? 4 : 3, out);
  return (int)cudaGetLastError();
}

// Backward: dflat = d(sum_i ct[i] * S_i)/dparams in the flat layout, and
// g_e[N] = its cotangent wrt e (EVM only). scratch: [n_blocks, nsf_fused_loss_scratch_floats],
// dpart: [n_blocks, n_params]. Returns a cudaError_t code (0 = launched).
int nsf_fused_loss_bwd(const float* x, const float* flat, const float* e, const float* vis_t,
                       const float* eq_w, int n, int n_hidden, int h, int k, int tile,
                       int n_blocks, float re, float scale, int evm, const float* ct,
                       float* scratch, float* dpart, float* dflat, float* g_e, void* stream) {
  const size_t smem = smem_floats(tile, h, k) * sizeof(float);
  int bad = check_launch_args(n, h, k, tile, n_hidden, n_blocks, smem);
  if (bad) return bad;
  cudaError_t err = cudaFuncSetAttribute(loss_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Shapes sh{n_hidden, h, k, tile};
  loss_bwd_kernel<<<n_blocks, kThreads, smem, s>>>(x, flat, e, vis_t, eq_w, n, sh, re, scale,
                                                   evm, ct, scratch, dpart, g_e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long P = n_params(n_hidden, h, k);
  sum_partials<<<(unsigned)((P + 255) / 256), 256, 0, s>>>(dpart, n_blocks, P, P, dflat);
  return (int)cudaGetLastError();
}

}  // extern "C"
