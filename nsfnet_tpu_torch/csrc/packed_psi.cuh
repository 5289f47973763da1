// Device code of the order-3 streamfunction engine (psi_streams.cu): the
// 13-stream counterparts of packed_mlp.cuh's five-stream functions. It ports
// the parts of nsfnet_tpu/ops/pallas_psi.py that both TPU kernels inline:
// _first_layer_packed (:138), _layer_packed (:152), the forward recompute
// and the hand-derived order-3 adjoint of _bwd_kernel (:259-307).
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
//   forward : a' = d1 z1
//             b' = d2 z1^2 + d1 z2
//             c' = d3 z1^3 + 3 d2 z1 z2 + d1 z3
//   backward: g_z  = gh d1 + sum_dir [ gA d2 z1 + gB (d3 z1^2 + d2 z2)
//                                      + gC (d4 z1^3 + 3 d3 z1 z2 + d2 z3) ]
//             g_z1 = gA d1 + 2 gB d2 z1 + 3 gC (d3 z1^2 + d2 z2)
//             g_z2 = gB d1 + 3 gC d2 z1
//             g_z3 = gC d1
// The first layer is analytic: its tangents are the constant rows
// r_x = W0[0], r_y = W0[1], r_p = r_x + r_y, r_m = r_x - r_y with
// z2 = z3 = 0; they reach dW0 through g_z0 and directly (r_p adds into both
// rows, r_m into row x and, negated, into row y).
//
// The tile, the fixed grid, the ordered partial sums, the staged weight
// (row stride H+1) and the block-private backward scratch are those of
// packed_mlp.cuh; the carries are 13/5 as large, so the tile that fits is
// smaller at wide H and one block runs more threads (kPsiThreads).

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

__host__ __device__ inline long psi_scratch_floats(int tile, int h, int n_hidden) {
  // one block's backward store: the packed carry [13T,h] of each of the L
  // tanh layers, then the pre-activation tangents [12T,h] of the L-1
  // product layers (the analytic first layer has none)
  return (long)(25 * n_hidden - 12) * tile * h;
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
                                       const float* __restrict__ b0, float* out, float* store,
                                       int tile, int h) {
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
    for (int q = 0; q < kPsi; ++q) {
      out[q * S + idx] = v[q];
      if (store) store[q * S + idx] = v[q];
    }
  }
}

// One hidden transition on packed carries: Z = P W (+ b on the value rows),
// then the order-3 tanh algebra. Optionally keeps the new carry and the
// pre-activation tangents [12][T][h] for the reverse sweep.
__device__ inline void psi_hidden_layer(const float* in, float* out, const float* ws,
                                        const float* __restrict__ b, float* pack_store,
                                        float* ztan_store, int tile, int h) {
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
    for (int q = 0; q < kPsi; ++q) {
      out[q * S + idx] = v[q];
      if (pack_store) pack_store[q * S + idx] = v[q];
    }
    if (ztan_store) {
#pragma unroll
      for (int q = 1; q < kPsi; ++q) ztan_store[(q - 1) * S + idx] = a[q];
    }
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
// returned buffer. With store != nullptr, keeps every carry and tangent.
__device__ inline float* psi_forward_tile(const float* __restrict__ x,
                                          const float* __restrict__ flat, long n0,
                                          const Shapes& sh, float* buf_a, float* buf_b,
                                          float* ws, float* store) {
  const int h = sh.h, S = sh.tile * h, L = sh.n_hidden;
  float* packs = store;
  float* ztans = store ? store + (long)kPsi * L * S : nullptr;
  psi_first_layer(x, n0, flat, flat + 2 * h, buf_a, packs, sh.tile, h);
  float* cur = buf_a;
  float* nxt = buf_b;
  for (int l = 1; l < L; ++l) {
    const float* w = flat + hidden_off(l, h);
    stage_weight(ws, w, h);
    __syncthreads();
    psi_hidden_layer(cur, nxt, ws, w + (long)h * h,
                     store ? packs + (long)kPsi * l * S : nullptr,
                     store ? ztans + 12L * (l - 1) * S : nullptr, sh.tile, h);
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  return cur;
}

// Packed reverse sweep of one tile, from the head cotangents down to the
// first layer's direct dW0 terms (_bwd_kernel, pallas_psi.py:251-307).
//   hb    : [13][T][k] cotangents of the head streams, in shared memory
//           (the head bias receives the value stream's rows);
//   cur   : the last packed carry, as psi_forward_tile(store) returned it;
//   other : the second carry buffer; both are overwritten;
//   store : the block's scratch that psi_forward_tile filled for this tile;
//   dp    : the block's gradient partial in the flat layout, += per tile.
// A thread adds to the same entries of dp for every tile, so the block
// needs no atomics. The caller synchronises before the call (hb complete)
// and before it touches the buffers again.
__device__ inline void psi_reverse_sweep(const float* __restrict__ x,
                                         const float* __restrict__ flat, long n0,
                                         const Shapes& sh, float* cur, float* other, float* ws,
                                         const float* hb, const float* store, float* dp) {
  const int T = sh.tile, h = sh.h, k = sh.k, L = sh.n_hidden, S = T * h, TK = T * k;
  const long wh = head_off(L, h);
  const float* whp = flat + wh;

  // head backward: dWh = P^T G, dbh = sum of the value rows, G_in = G Wh^T
  for (int idx = threadIdx.x; idx < h * k; idx += blockDim.x) {
    int m = idx / k, kk = idx - m * k;
    float a = 0.f;
    for (int q = 0; q < kPsi; ++q)
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
    for (int q = 0; q < kPsi; ++q) {
      float a = 0.f;
      for (int kk = 0; kk < k; ++kk) a += hb[q * TK + p * k + kk] * whp[m * k + kk];
      other[q * S + idx] = a;
    }
  }
  __syncthreads();

  float* g = other;  // packed carry cotangents [13][T][h]
  float* z = cur;    // packed pre-activation cotangents
  const float* packs = store;
  const float* ztans = store + (long)kPsi * L * S;
  for (int l = L - 1; l >= 1; --l) {
    const float* w = flat + hidden_off(l, h);
    stage_weight(ws, w, h);
    const float* pk = packs + (long)kPsi * l * S;
    const float* zt = ztans + 12L * (l - 1) * S;
    for (int idx = threadIdx.x; idx < S; idx += blockDim.x) {
      TanhChain c = tanh_chain(pk[idx]);
      float gz = g[idx] * c.d1;
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        float z1 = zt[d * S + idx], z2 = zt[(4 + d) * S + idx], z3 = zt[(8 + d) * S + idx];
        float gA = g[(1 + d) * S + idx], gB = g[(5 + d) * S + idx], gC = g[(9 + d) * S + idx];
        gz += gA * c.d2 * z1 + gB * (c.d3 * z1 * z1 + c.d2 * z2) +
              gC * (c.d4 * z1 * z1 * z1 + 3.0f * c.d3 * z1 * z2 + c.d2 * z3);
        z[(1 + d) * S + idx] =
            gA * c.d1 + 2.0f * gB * c.d2 * z1 + gC * (3.0f * c.d3 * z1 * z1 + 3.0f * c.d2 * z2);
        z[(5 + d) * S + idx] = gB * c.d1 + 3.0f * gC * c.d2 * z1;
        z[(9 + d) * S + idx] = gC * c.d1;
      }
      z[idx] = gz;
    }
    __syncthreads();
    const float* pin = packs + (long)kPsi * (l - 1) * S;
    for (int idx = threadIdx.x; idx < h * h; idx += blockDim.x) {
      int m = idx / h, j = idx - m * h;
      float a = 0.f;
      for (int q = 0; q < kPsi; ++q)
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
      float a[kPsi];
#pragma unroll
      for (int q = 0; q < kPsi; ++q) a[q] = 0.f;
      const float* zr = z + p * h;
      for (int j = 0; j < h; ++j) {
        float wv = ws[m * hp + j];
#pragma unroll
        for (int q = 0; q < kPsi; ++q) a[q] += zr[q * S + j] * wv;
      }
#pragma unroll
      for (int q = 0; q < kPsi; ++q) g[q * S + idx] = a[q];
    }
    __syncthreads();
  }

  // first layer (analytic tangents, z2 = z3 = 0), with the direct dW0 terms
  for (int j = threadIdx.x; j < h; j += blockDim.x) {
    const float wx = flat[j], wy = flat[h + j];
    const float r[4] = {wx, wy, wx + wy, wx - wy};
    float ax = 0.f, ay = 0.f, ab = 0.f;
    for (int p = 0; p < T; ++p) {
      const int idx = p * h + j;
      TanhChain c = tanh_chain(packs[idx]);
      float gz0 = g[idx] * c.d1;
      float grow[4];
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        float rr = r[d] * r[d];
        float gA = g[(1 + d) * S + idx], gB = g[(5 + d) * S + idx], gC = g[(9 + d) * S + idx];
        gz0 += gA * c.d2 * r[d] + gB * c.d3 * rr + gC * c.d4 * (rr * r[d]);
        grow[d] = gA * c.d1 + 2.0f * gB * c.d2 * r[d] + 3.0f * gC * c.d3 * rr;
      }
      const float px = x[2 * (n0 + p)], py = x[2 * (n0 + p) + 1];
      ax += px * gz0 + grow[0] + grow[2] + grow[3];
      ay += py * gz0 + grow[1] + grow[2] - grow[3];
      ab += gz0;
    }
    dp[j] += ax;
    dp[h + j] += ay;
    dp[2 * h + j] += ab;
  }
}

}  // namespace
