// Device code of the port's CUDA-core packed-MLP kernels (fp32): the
// five-stream derivative engine (mlp_streams.cu) and, through packed_psi.cuh,
// the order-3 engine (psi_streams.cu). It ports the parts of
// nsfnet_tpu/ops/pallas_mlp.py that the TPU kernel pairs inline:
// _first_layer_packed, _layer_packed, _forward_streams, _recompute_forward
// and _packed_reverse_sweep. The fused residual-loss pair (fused_residual.cu)
// takes only its flat parameter layout and sum_partials from here; its sweep
// runs on the tensor cores (tc_mlp.cuh).
//
// For a tanh MLP 2 -> H (x n_hidden) -> K and a tile of T points, the five
// Taylor streams (h, h_x, h_y, h_xx, h_yy) travel as one packed carry
// [5][T][H], so every layer is one product against the shared weight matrix
// with the tanh algebra fused into its epilogue (s = 1 - t^2, c = -2 t s):
//   forward : t = tanh(z), h_x = s z_x, h_xx = c z_x^2 + s z_xx   (same for y)
//   backward: g_z   = G_h s + (G_x z_x + G_y z_y) c
//                     + G_xx ((6t^2-2) s z_x^2 + c z_xx) + G_yy (... y ...)
//             g_zx  = G_x s + 2 G_xx c z_x        g_zxx = G_xx s   (same for y)
//
// Shared by every kernel built on it:
//   * A tile of T points (T <= 16, chosen by the wrapper so that shared
//     memory fits) keeps two packed carries and the current weight matrix
//     (row stride H+1, so both its row and its column reads are free of bank
//     conflicts) in shared memory. A thread owns one (point, unit) pair and
//     computes all five streams of it.
//   * The TPU kernels accumulate into revisited output blocks over an
//     ordered grid. Here a FIXED number of blocks (a constant of the wrapper,
//     not the SM count) loops over tiles b, b+n_blocks, ...; a block that
//     reduces writes one partial (loss sums, or a full gradient vector in the
//     flat parameter layout), and sum_partials adds the partials in block
//     order in double precision. No atomics: equal inputs give
//     bitwise-equal outputs.
//   * A backward needs every layer's packed carry and pre-activation
//     tangents, more than shared memory holds for a useful tile. They go to
//     a block-private global scratch that the wrapper allocates, written
//     once by the recompute and read once by the reverse sweep.
//   * The first layer is the analytic broadcast (z_x, z_y are the rows of
//     W0, z_xx = z_yy = 0), never a K=2 product; its dW0 gets the direct
//     tangent terms of pallas_mlp.py:296-310.
//
// Each .cu that includes this header is its own shared library, so
// everything here has internal linkage.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90

struct Shapes {
  int n_hidden;  // tanh layers: the analytic first layer + n_hidden-1 products
  int h;         // hidden width
  int k;         // head outputs
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

// Shared-memory layout of every kernel, in floats: buf_a | buf_b | ws | red | hb.
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

__device__ inline void stage_weight(float* ws, const float* __restrict__ w, int h) {
  for (int i = threadIdx.x; i < h * h; i += blockDim.x) {
    int r = i / h;
    ws[r * (h + 1) + (i - r * h)] = w[i];
  }
}

// Analytic first layer -> packed carry [t; s wx; s wy; c wx^2; c wy^2].
__device__ inline void first_layer(const float* __restrict__ x, long n0,
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
__device__ inline void hidden_layer(const float* in, float* out, const float* ws,
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

// Head product on the last packed carry -> five [T][k] streams in hb
// (value, d/dx, d/dy, d2/dx2, d2/dy2; the value stream with the head bias).
__device__ inline void head_layer(const float* in, const float* __restrict__ wh,
                                  const float* __restrict__ bh, float* hb, int tile, int h,
                                  int k) {
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

// Packed forward through the hidden layers; leaves the last carry in the
// returned buffer. With store != nullptr, keeps every carry and tangent.
__device__ inline float* forward_tile(const float* __restrict__ x,
                                      const float* __restrict__ flat, long n0,
                                      const Shapes& sh, float* buf_a, float* buf_b, float* ws,
                                      float* store) {
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

// Packed reverse sweep of one tile, from the head cotangents down to the
// first layer's direct dW0 terms (_packed_reverse_sweep, pallas_mlp.py:247).
//   hb    : [5][T][k] cotangents of the five head streams, in shared memory
//           (the head bias receives the value stream's rows);
//   cur   : the last packed carry, as forward_tile(store) returned it;
//   other : the second carry buffer; both are overwritten;
//   store : the block's scratch that forward_tile filled for this tile;
//   dp    : the block's gradient partial in the flat layout, += per tile.
// A thread adds to the same entries of dp for every tile, so the block
// needs no atomics. The caller synchronises before the call (hb complete)
// and before it touches the buffers again.
__device__ inline void reverse_sweep(const float* __restrict__ x,
                                     const float* __restrict__ flat, long n0, const Shapes& sh,
                                     float* cur, float* other, float* ws, const float* hb,
                                     const float* store, float* dp) {
  const int T = sh.tile, h = sh.h, k = sh.k, L = sh.n_hidden, S = T * h, TK = T * k;
  const long wh = head_off(L, h);
  const float* whp = flat + wh;

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

// out[i] = sum over blocks b (in order) of partial[b * width + i], in double.
__global__ void sum_partials(const float* __restrict__ partial, int n_blocks, long width,
                             long n_cols, float* out) {
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_cols) return;
  double s = 0.0;
  for (int b = 0; b < n_blocks; ++b) s += (double)partial[b * width + i];
  out[i] = (float)s;
}

// Launches sum_partials over a [n_blocks, P] gradient partial on stream s.
inline cudaError_t sum_gradient_partials(const float* dpart, int n_blocks, long P, float* dflat,
                                         cudaStream_t s) {
  sum_partials<<<(unsigned)((P + 255) / 256), 256, 0, s>>>(dpart, n_blocks, P, P, dflat);
  return cudaGetLastError();
}

// What every launch needs: a batch of whole tiles, a block that fits.
inline int check_launch_args(int n, int h, int k, int tile, int n_hidden, int n_blocks,
                             size_t smem) {
  if (tile <= 0 || n % tile != 0 || h <= 0 || k <= 0 || n_hidden < 1 || n_blocks <= 0 ||
      smem > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace
