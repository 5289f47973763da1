// Device code of the port's CUDA-core packed-MLP forward kernels (fp32):
// the five-stream engine's forward (mlp_streams.cu streams_fwd_kernel) and,
// through packed_psi.cuh, the order-3 engine's forward (psi_streams.cu
// psi_fwd_kernel). It ports the parts of nsfnet_tpu/ops/pallas_mlp.py that
// the TPU forward kernels inline: _first_layer_packed, _layer_packed and
// _forward_streams. Every backward kernel and the fused residual-loss pair
// run their sweeps on the tensor cores (tc_mlp.cuh, tc_psi.cuh) and take
// only the flat parameter layout, kMaxSmem and sum_partials from here.
//
// For a tanh MLP 2 -> H (x n_hidden) -> K and a tile of T points, the five
// Taylor streams (h, h_x, h_y, h_xx, h_yy) travel as one packed carry
// [5][T][H], so every layer is one product against the shared weight matrix
// with the tanh algebra fused into its epilogue (s = 1 - t^2, c = -2 t s):
//   t = tanh(z), h_x = s z_x, h_xx = c z_x^2 + s z_xx   (same for y)
//
// Shared by every kernel built on it:
//   * A tile of T points (T <= 16, chosen by the wrapper so that shared
//     memory fits) keeps two packed carries and the current weight matrix
//     (row stride H+1, so both its row and its column reads are free of bank
//     conflicts) in shared memory. A thread owns one (point, unit) pair and
//     computes all five streams of it.
//   * A FIXED number of blocks (a constant of the wrapper, not the SM count)
//     loops over tiles b, b+n_blocks, ...; a kernel that reduces writes one
//     partial per block (a full gradient vector in the flat parameter
//     layout), and sum_partials adds the partials in block order in double
//     precision. No atomics: equal inputs give bitwise-equal outputs.
//   * The first layer is the analytic broadcast (z_x, z_y are the rows of
//     W0, z_xx = z_yy = 0), never a K=2 product.
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

__device__ inline void stage_weight(float* ws, const float* __restrict__ w, int h) {
  for (int i = threadIdx.x; i < h * h; i += blockDim.x) {
    int r = i / h;
    ws[r * (h + 1) + (i - r * h)] = w[i];
  }
}

// Analytic first layer -> packed carry [t; s wx; s wy; c wx^2; c wy^2].
__device__ inline void first_layer(const float* __restrict__ x, long n0,
                                   const float* __restrict__ w0, const float* __restrict__ b0,
                                   float* out, int tile, int h) {
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
    for (int q = 0; q < 5; ++q) out[q * S + idx] = v[q];
  }
}

// One hidden transition on packed carries: Z = P W (+ b on the value rows),
// then the tanh Taylor algebra.
__device__ inline void hidden_layer(const float* in, float* out, const float* ws,
                                    const float* __restrict__ b, int tile, int h) {
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
    for (int q = 0; q < 5; ++q) out[q * S + idx] = v[q];
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
// returned buffer.
__device__ inline float* forward_tile(const float* __restrict__ x,
                                      const float* __restrict__ flat, long n0,
                                      const Shapes& sh, float* buf_a, float* buf_b, float* ws) {
  const int h = sh.h, L = sh.n_hidden;
  first_layer(x, n0, flat, flat + 2 * h, buf_a, sh.tile, h);
  float* cur = buf_a;
  float* nxt = buf_b;
  for (int l = 1; l < L; ++l) {
    const float* w = flat + hidden_off(l, h);
    stage_weight(ws, w, h);
    __syncthreads();
    hidden_layer(cur, nxt, ws, w + (long)h * h, sh.tile, h);
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  return cur;
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
