// Fused NS residual-loss kernel pair for Hopper (sm_90a), the hidden-layer
// products on the tensor cores.
//
// Replaces the TPU kernels of nsfnet_tpu/ops/pallas_residual.py:
//   loss_fwd_kernel  <- _loss_fwd_kernel (:100, launched by _fused_fwd, pallas_call at :205)
//   loss_bwd_kernel  <- _loss_bwd_kernel (:128, launched by _fused_bwd, pallas_call at :249)
// The packed sweep they run (tensor-core products, bf16 parts, the backward
// tape, the fixed grid) is in tc_mlp.cuh, which says how each part works.
//
// What they compute, for a tanh MLP 2 -> H (x n_hidden) -> 3 and a batch of
// collocation points x[N,2], at a precision name (NP bf16 parts per operand,
// the passes i + j < NP: "default" 1, "high" 3, "highest" 6):
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
// the backward ~0.97 MFLOP, each times the pass count, against ~20 B of
// per-point input: far above the bf16 ridge point. The products run as
// mma.sync on bf16 parts (tc_mlp.cuh). What the design does about the rest:
// the hidden weights are split once per launch, so staging a panel is a copy,
// and cp.async makes it into the ring of weight slots while the warps run
// the product on the slot before (tc_mlp.cuh);
// the backward's tape holds t and the tangents only (1.0 GB written, 1.8 GB
// read at 6x80 / N = 120,000, against 1.9 GB each way when every carry was
// stored); its 132 persistent blocks with 32-point tiles halve the updates
// of the gradient partial (ops/fused_residual.py bwd_traffic), and each
// update is a reduction from the element's one owning thread, which no warp
// waits for (tc_mlp.cuh red_add: no load of the partial, the same sums in the
// same order, bitwise); the elementwise loops keep several global loads in
// flight per thread.
// Both kernels take tc_mlp.cuh's two plans, one instance each (STREAM): the
// resident plan where a block with both carries fits, else the streamed
// plan, so every width runs (ops/fused_residual.loss_plan).

#include "tc_mlp.cuh"

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

// STREAM: the streamed plan (tc_mlp.cuh), a template flag so that the
// resident plan's instances carry no code of it.
template <int NP, bool STREAM>
__global__ void __launch_bounds__(kTcThreads, 1)
loss_fwd_kernel(const float* __restrict__ x, const float* __restrict__ flat,
                const float* __restrict__ e, const float* __restrict__ vis_t,
                const float* __restrict__ eq_w, const bf16* __restrict__ wsplit, int n,
                TcShapes sh, float re, float scale, int evm, float* partial, float* carries) {
  extern __shared__ __align__(16) unsigned char smem[];
  const TcRegions R = tc_regions<STREAM>(smem, carries, sh, NP);
  const int T = sh.tile, h = sh.h, k = sh.k;
  const int n_out = evm ? 4 : 3;
  const long wh = head_off(sh.n_hidden, h);
  const int n_tiles = (n + T - 1) / T;
  TcRing rg = ring_begin<NP, STREAM>(R.wb, wsplit, sh, false, n_tiles);
  stage_head<NP>(R.whs, flat + wh, h, sh.hp, k);
  float acc = 0.f;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long n0 = (long)tile * T;
    rg.last_tile = tile + (int)gridDim.x >= n_tiles;
    __syncthreads();  // the previous tile's readers of the buffers / red are done
    const bf16* cur = tc_forward<NP, STREAM>(x, flat, wsplit, n0, n, sh, R.buf_a, R.buf_b, R.sa,
                                             R.wb, nullptr, rg);
    tc_head<NP, 3>(cur, R.whs, flat + wh + (long)h * k, R.hb, sh);
    __syncthreads();
    for (int p = threadIdx.x; p < T; p += blockDim.x) {
      const long i = n0 + p;
      const bool live = i < n;
      Res r = residual_at(R.hb, p, T, k, evm && live ? e[i] : 0.f,
                          evm && live ? vis_t[i] : 0.f, re, scale, evm != 0);
      const float w = live ? eq_w[i] : 0.f;
      R.red[p] = w * r.eq1 * r.eq1;
      R.red[T + p] = w * r.eq2 * r.eq2;
      R.red[2 * T + p] = w * r.eq3 * r.eq3;
      R.red[3 * T + p] = w * r.eq4 * r.eq4;
    }
    __syncthreads();
    if (threadIdx.x < n_out) {
      float s = 0.f;
      for (int p = 0; p < T; ++p) s += R.red[threadIdx.x * T + p];
      acc += s;
    }
  }
  if (threadIdx.x < 4) partial[blockIdx.x * 4 + threadIdx.x] = threadIdx.x < n_out ? acc : 0.f;
}

template <int NP, bool STREAM>
__global__ void __launch_bounds__(kTcThreads, 1)
loss_bwd_kernel(const float* __restrict__ x, const float* __restrict__ flat,
                const float* __restrict__ e, const float* __restrict__ vis_t,
                const float* __restrict__ eq_w, const bf16* __restrict__ wsplit, int n,
                TcShapes sh, float re, float scale, int evm, const float* __restrict__ ct,
                float* scratch, float* dpart, float* g_e, float* carries) {
  extern __shared__ __align__(16) unsigned char smem[];
  const TcRegions R = tc_regions<STREAM>(smem, carries, sh, NP);
  const int T = sh.tile, h = sh.h, k = sh.k, L = sh.n_hidden, TK = T * k, rows = 5 * T;
  const long P = n_params(L, h, k);
  float* dp = dpart + blockIdx.x * P;
  float* tape = scratch + blockIdx.x * tc_scratch_floats(T, sh.hp, L);
  const long wh = head_off(L, h);
  const float ss = scale * scale;
  const float c0 = ct[0], c1 = ct[1], c2 = ct[2], c3 = evm ? ct[3] : 0.f;
  float* hb = R.hb;

  const int n_tiles = (n + T - 1) / T;
  TcRing rg = ring_begin<NP, STREAM>(R.wb, wsplit, sh, true, n_tiles);
  for (long i = threadIdx.x; i < P; i += blockDim.x) dp[i] = 0.f;
  stage_head<NP>(R.whs, flat + wh, h, sh.hp, k);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long n0 = (long)tile * T;
    rg.last_tile = tile + (int)gridDim.x >= n_tiles;
    __syncthreads();
    bf16* cur = tc_forward<NP, STREAM>(x, flat, wsplit, n0, n, sh, R.buf_a, R.buf_b, R.sa, R.wb,
                                       tape, rg);
    bf16* other = cur == R.buf_a ? R.buf_b : R.buf_a;
    tc_head<NP, 3>(cur, R.whs, flat + wh + (long)h * k, hb, sh);
    __syncthreads();

    // per-point loss cotangents -> head-stream cotangents, in place in hb
    for (int p = threadIdx.x; p < T; p += blockDim.x) {
      const long i = n0 + p;
      const bool live = i < n;
      Res r = residual_at(hb, p, T, k, evm && live ? e[i] : 0.f,
                          evm && live ? vis_t[i] : 0.f, re, scale, evm != 0);
      const float w = live ? eq_w[i] : 0.f;
      float g1, g2, g3, gu, gv;
      if (evm) {
        float g4 = 2.0f * (w * r.eq4) * c3;
        g1 = 2.0f * (w * r.eq1) * c0 + g4 * (r.u - 0.5f);
        g2 = 2.0f * (w * r.eq2) * c1 + g4 * (r.v - 0.5f);
        g3 = 2.0f * (w * r.eq3) * c2;
        if (live) g_e[i] = -g4;
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
    for (int idx = threadIdx.x; idx < rows * k; idx += blockDim.x) {  // head cotangent parts
      bf16 part[NP];
      split_one<NP>(hb[idx], part);
#pragma unroll
      for (int i = 0; i < NP; ++i) R.ghp[(long)i * rows * k + idx] = __bfloat162float(part[i]);
    }
    __syncthreads();
    tc_head_backward<NP, 3>(x, flat, n0, n, cur, R.whs, R.ghp, hb, tape, other, R.dbs, dp, sh);
    __syncthreads();
    flush_sums(R.dbs, T / 8, L - 1, dp, h, sh.hp);
    tc_reverse<NP, STREAM>(x, flat, wsplit, n0, n, other, cur, R.sa, R.wb, R.dbs, tape, dp, sh,
                           rg);
  }
}

// What the pair takes: the residual algebra reads (u, v, p), so the head is
// 3 wide; a batch padded to 16 rows; a tile of 16 or 32; a plan the sweep
// takes (tc_plan_ok); 1-3 parts; a block that fits; the streamed plan's
// global regions.
int check_loss_args(int n, int h, int k, int tile, int panel, int kpanel, int n_hidden,
                    int n_blocks, int parts, size_t smem, const float* carries) {
  if (k != 3 || n <= 0 || n % 16 != 0 || h <= 0 || n_hidden < 1 || n_blocks <= 0 ||
      (tile != 16 && tile != 32) || !tc_plan_ok(pad16(h), tile, panel, kpanel) || parts < 1 ||
      parts > 3 || smem > (size_t)kMaxSmem || (kpanel && !carries))
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <int NP>
int launch_fwd(const float* x, const float* flat, const float* e, const float* vis_t,
               const float* eq_w, bf16* wsplit, int n, TcShapes sh, int n_blocks, float re,
               float scale, int evm, float* partial, float* carries, size_t smem,
               cudaStream_t s) {
  const auto kernel = sh.kpanel ? loss_fwd_kernel<NP, true> : loss_fwd_kernel<NP, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int bad = launch_split<NP>(flat, sh, wsplit, s);
  if (bad) return bad;
  kernel<<<n_blocks, kTcThreads, smem, s>>>(x, flat, e, vis_t, eq_w, wsplit, n, sh, re, scale,
                                            evm, partial, carries);
  return (int)cudaGetLastError();
}

template <int NP>
int launch_bwd(const float* x, const float* flat, const float* e, const float* vis_t,
               const float* eq_w, bf16* wsplit, int n, TcShapes sh, int n_blocks, float re,
               float scale, int evm, const float* ct, float* scratch, float* dpart, float* g_e,
               float* carries, size_t smem, cudaStream_t s) {
  const auto kernel = sh.kpanel ? loss_bwd_kernel<NP, true> : loss_bwd_kernel<NP, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int bad = launch_split<NP>(flat, sh, wsplit, s);
  if (bad) return bad;
  kernel<<<n_blocks, kTcThreads, smem, s>>>(x, flat, e, vis_t, eq_w, wsplit, n, sh, re, scale,
                                            evm, ct, scratch, dpart, g_e, carries);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block of either kernel uses, in bytes (kpanel 0: the
// resident plan).
int nsf_fused_loss_smem_bytes(int tile, int panel, int h, int k, int parts, int kpanel) {
  return (int)tc_smem(tile, panel, pad16(h), k, parts, kpanel).total();
}

// Floats of backward tape one block uses; the wrapper allocates n_blocks of them.
long nsf_fused_loss_scratch_floats(int tile, int h, int n_hidden) {
  return tc_scratch_floats(tile, pad16(h), n_hidden);
}

// Floats of the streamed plan's global regions one block uses (either
// kernel; the wrapper allocates n_blocks of them on that plan only).
long nsf_fused_loss_carry_floats(int tile, int h, int k, int parts) {
  return tc_carry_floats(tile, pad16(h), k, parts);
}

// Bytes of the launch's split copy of the hidden weights (either kernel).
long nsf_fused_loss_weight_bytes(int n_hidden, int h, int parts) {
  return tc_wsplit_elems(n_hidden, pad16(h), parts) * (long)sizeof(bf16);
}

// The weight ring of the resident plan (tile, panel) (either kernel, and
// kernels 3+4): its depth, 1 or 2 slots, returned, and each slot's K-extent
// into *kx.
int nsf_fused_loss_ring(int tile, int panel, int h, int k, int parts, int* kx) {
  const TcSmem s = tc_smem(tile, panel, pad16(h), k, parts);
  *kx = s.kx;
  return s.depth;
}

// Forward: out[0..n_out) = per-equation weighted sums of squares.
// partial: [n_blocks, 4] scratch; wsplit: nsf_fused_loss_weight_bytes of
// scratch. The plan: (tile, panel, kpanel), kpanel 0 the resident plan;
// the streamed plan's carries: [n_blocks, nsf_fused_loss_carry_floats]
// (null on the resident plan). Returns a cudaError_t code (0 = launched).
int nsf_fused_loss_fwd(const float* x, const float* flat, const float* e, const float* vis_t,
                       const float* eq_w, int n, int n_hidden, int h, int k, int tile,
                       int panel, int n_blocks, int parts, float re, float scale, int evm,
                       void* wsplit, float* partial, float* out, void* stream, int kpanel,
                       float* carries) {
  const size_t smem = tc_smem(tile, panel, pad16(h), k, parts, kpanel).total();
  int bad = check_loss_args(n, h, k, tile, panel, kpanel, n_hidden, n_blocks, parts, smem,
                            carries);
  if (bad) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  TcShapes sh{n_hidden, h, pad16(h), k, tile, panel, kpanel};
  bf16* ws = static_cast<bf16*>(wsplit);
  int err = parts == 1   ? launch_fwd<1>(x, flat, e, vis_t, eq_w, ws, n, sh, n_blocks, re,
                                         scale, evm, partial, carries, smem, s)
            : parts == 2 ? launch_fwd<2>(x, flat, e, vis_t, eq_w, ws, n, sh, n_blocks, re,
                                         scale, evm, partial, carries, smem, s)
                         : launch_fwd<3>(x, flat, e, vis_t, eq_w, ws, n, sh, n_blocks, re,
                                         scale, evm, partial, carries, smem, s);
  if (err) return err;
  sum_partials<<<1, 32, 0, s>>>(partial, n_blocks, 4, evm ? 4 : 3, out);
  return (int)cudaGetLastError();
}

// Backward: dflat = d(sum_i ct[i] * S_i)/dparams in the flat layout, and
// g_e[N] = its cotangent wrt e (EVM only). wsplit, the plan and carries as
// for the forward; scratch: [n_blocks, nsf_fused_loss_scratch_floats],
// dpart: [n_blocks, n_params]. Returns a cudaError_t code (0 = launched).
int nsf_fused_loss_bwd(const float* x, const float* flat, const float* e, const float* vis_t,
                       const float* eq_w, int n, int n_hidden, int h, int k, int tile,
                       int panel, int n_blocks, int parts, float re, float scale, int evm,
                       void* wsplit, const float* ct, float* scratch, float* dpart, float* dflat,
                       float* g_e, void* stream, int kpanel, float* carries) {
  const size_t smem = tc_smem(tile, panel, pad16(h), k, parts, kpanel).total();
  int bad = check_loss_args(n, h, k, tile, panel, kpanel, n_hidden, n_blocks, parts, smem,
                            carries);
  if (bad) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  TcShapes sh{n_hidden, h, pad16(h), k, tile, panel, kpanel};
  bf16* ws = static_cast<bf16*>(wsplit);
  int err = parts == 1   ? launch_bwd<1>(x, flat, e, vis_t, eq_w, ws, n, sh, n_blocks, re,
                                         scale, evm, ct, scratch, dpart, g_e, carries, smem, s)
            : parts == 2 ? launch_bwd<2>(x, flat, e, vis_t, eq_w, ws, n, sh, n_blocks, re,
                                         scale, evm, ct, scratch, dpart, g_e, carries, smem, s)
                         : launch_bwd<3>(x, flat, e, vis_t, eq_w, ws, n, sh, n_blocks, re,
                                         scale, evm, ct, scratch, dpart, g_e, carries, smem, s);
  if (err) return err;
  return (int)sum_gradient_partials(dpart, n_blocks, n_params(n_hidden, h, k), dflat, s);
}

}  // extern "C"
