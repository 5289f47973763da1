// Device code of the order-3 streamfunction engine's forward
// (psi_streams.cu psi_fwd_kernel): the 13-stream counterparts of
// packed_mlp.cuh's five-stream functions. It ports the parts of
// nsfnet_tpu/ops/pallas_psi.py that the TPU forward kernel inlines:
// _first_layer_packed (:138) and _layer_packed (:152). The backward runs on
// the tensor cores (tc_psi.cuh) and takes kPsi and tanh_chain from here.
//
// For a tanh MLP 2 -> H (x n_hidden) -> K and a tile of T points, the value
// and the order-1/2/3 directional derivatives along e_x, e_y, (1,1), (1,-1)
// travel as one packed carry [13][T][H]:
//
//     [ h | a_x a_y a_p a_m | b_x b_y b_p b_m | c_x c_y c_p c_m ]
//
// so every layer is one product against the shared weight matrix with the
// Faa di Bruno algebra fused into its epilogue. With t = tanh(z) and
// d1..d4 the derivatives of tanh in t (tanh_chain), z1..z3 the packed
// tangent rows of the same product, per direction:
//   a' = d1 z1
//   b' = d2 z1^2 + d1 z2
//   c' = d3 z1^3 + 3 d2 z1 z2 + d1 z3
// The first layer is analytic: its tangents are the constant rows
// r_x = W0[0], r_y = W0[1], r_p = r_x + r_y, r_m = r_x - r_y with
// z2 = z3 = 0.
//
// The tile, the fixed grid and the staged weight (row stride H+1) are those
// of packed_mlp.cuh; the carries are 13/5 as large, so the tile that fits
// is smaller at wide H and one block runs more threads (kPsiThreads).

#pragma once

#include "packed_mlp.cuh"

namespace {

constexpr int kPsi = 13;          // value + 4 directions x 3 orders
constexpr int kPsiThreads = 512;  // one block per SM at the usual tile: more warps per block

// Shared-memory layout, in floats: buf_a | buf_b | ws | hb.
inline size_t psi_smem_floats(int tile, int h, int k) {
  // two packed carries, the staged weight, the head streams / cotangents
  return 2ul * kPsi * tile * h + (size_t)h * (h + 1) + (size_t)kPsi * tile * k;
}

struct TanhChain {
  float d1, d2, d3, d4;
};

// tanh', tanh'', tanh''', tanh'''' in t = tanh(z).
__device__ inline TanhChain tanh_chain(float t) {
  const float d1 = 1.0f - t * t;
  const float d2 = -2.0f * t * d1;
  const float u = 1.0f - 3.0f * t * t;
  const float d3 = -2.0f * d1 * u;
  const float d4 = -2.0f * (d2 * u - 6.0f * t * d1 * d1);
  return {d1, d2, d3, d4};
}

// Analytic first layer -> packed carry [t; d1 r_k; d2 r_k^2; d3 r_k^3].
__device__ inline void psi_first_layer(const float* __restrict__ x, long n0,
                                       const float* __restrict__ w0,
                                       const float* __restrict__ b0, float* out, int tile,
                                       int h) {
  const int S = tile * h;
  for (int idx = threadIdx.x; idx < S; idx += blockDim.x) {
    int p = idx / h, j = idx - p * h;
    float px = x[2 * (n0 + p)], py = x[2 * (n0 + p) + 1];
    float wx = w0[j], wy = w0[h + j];
    float r[4] = {wx, wy, wx + wy, wx - wy};
    float t = tanhf(px * wx + py * wy + b0[j]);
    TanhChain c = tanh_chain(t);
    float v[kPsi];
    v[0] = t;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      float rr = r[d] * r[d];
      v[1 + d] = c.d1 * r[d];
      v[5 + d] = c.d2 * rr;
      v[9 + d] = c.d3 * (rr * r[d]);
    }
#pragma unroll
    for (int q = 0; q < kPsi; ++q) out[q * S + idx] = v[q];
  }
}

// One hidden transition on packed carries: Z = P W (+ b on the value rows),
// then the order-3 tanh algebra.
__device__ inline void psi_hidden_layer(const float* in, float* out, const float* ws,
                                        const float* __restrict__ b, int tile, int h) {
  const int S = tile * h;
  const int hp = h + 1;
  for (int idx = threadIdx.x; idx < S; idx += blockDim.x) {
    int p = idx / h, j = idx - p * h;
    const float* r = in + p * h;
    float a[kPsi];
#pragma unroll
    for (int q = 0; q < kPsi; ++q) a[q] = 0.f;
    for (int kk = 0; kk < h; ++kk) {
      float w = ws[kk * hp + j];
#pragma unroll
      for (int q = 0; q < kPsi; ++q) a[q] += r[q * S + kk] * w;
    }
    float t = tanhf(a[0] + b[j]);
    TanhChain c = tanh_chain(t);
    float v[kPsi];
    v[0] = t;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      float z1 = a[1 + d], z2 = a[5 + d], z3 = a[9 + d];
      v[1 + d] = c.d1 * z1;
      v[5 + d] = c.d2 * z1 * z1 + c.d1 * z2;
      v[9 + d] = c.d3 * z1 * z1 * z1 + 3.0f * c.d2 * z1 * z2 + c.d1 * z3;
    }
#pragma unroll
    for (int q = 0; q < kPsi; ++q) out[q * S + idx] = v[q];
  }
}

// Head product on the last packed carry -> thirteen [T][k] streams in hb
// (the value stream with the head bias).
__device__ inline void psi_head_layer(const float* in, const float* __restrict__ wh,
                                      const float* __restrict__ bh, float* hb, int tile, int h,
                                      int k) {
  const int S = tile * h;
  const int TK = tile * k;
  for (int idx = threadIdx.x; idx < TK; idx += blockDim.x) {
    int p = idx / k, kk = idx - p * k;
    const float* r = in + p * h;
    float a[kPsi];
#pragma unroll
    for (int q = 0; q < kPsi; ++q) a[q] = 0.f;
    for (int m = 0; m < h; ++m) {
      float w = wh[m * k + kk];
#pragma unroll
      for (int q = 0; q < kPsi; ++q) a[q] += r[q * S + m] * w;
    }
    a[0] += bh[kk];
#pragma unroll
    for (int q = 0; q < kPsi; ++q) hb[q * TK + idx] = a[q];
  }
}

// Packed forward through the hidden layers; leaves the last carry in the
// returned buffer.
__device__ inline float* psi_forward_tile(const float* __restrict__ x,
                                          const float* __restrict__ flat, long n0,
                                          const Shapes& sh, float* buf_a, float* buf_b,
                                          float* ws) {
  const int h = sh.h, L = sh.n_hidden;
  psi_first_layer(x, n0, flat, flat + 2 * h, buf_a, sh.tile, h);
  float* cur = buf_a;
  float* nxt = buf_b;
  for (int l = 1; l < L; ++l) {
    const float* w = flat + hidden_off(l, h);
    stage_weight(ws, w, h);
    __syncthreads();
    psi_hidden_layer(cur, nxt, ws, w + (long)h * h, sh.tile, h);
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  return cur;
}

}  // namespace
