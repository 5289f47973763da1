// Fused NS residual-loss kernel pair for Hopper (sm_90a), fp32 on the CUDA cores.
//
// Replaces the TPU kernels of nsfnet_tpu/ops/pallas_residual.py:
//   loss_fwd_kernel  <- _loss_fwd_kernel (:100, launched by _fused_fwd, pallas_call at :205)
//   loss_bwd_kernel  <- _loss_bwd_kernel (:128, launched by _fused_bwd, pallas_call at :249)
// The packed forward and the packed reverse sweep they share with the
// five-stream engine (mlp_streams.cu) are in packed_mlp.cuh, which also says
// how tiles, the fixed grid, the ordered partial sums and the backward
// scratch work.
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

#include "packed_mlp.cuh"

namespace {

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

    reverse_sweep(x, flat, n0, sh, cur, other, ws, hb, store, dp);
  }
}

// The residual algebra reads (u, v, p): the head is 3 wide.
int check_loss_args(int n, int h, int k, int tile, int n_hidden, int n_blocks, size_t smem) {
  if (k != 3) return (int)cudaErrorInvalidValue;
  return check_launch_args(n, h, k, tile, n_hidden, n_blocks, smem);
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
  int bad = check_loss_args(n, h, k, tile, n_hidden, n_blocks, smem);
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
  int bad = check_loss_args(n, h, k, tile, n_hidden, n_blocks, smem);
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
  return (int)sum_gradient_partials(dpart, n_blocks, n_params(n_hidden, h, k), dflat, s);
}

}  // extern "C"