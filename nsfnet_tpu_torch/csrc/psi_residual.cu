// The streamfunction formulation's residual loss from kernel 5's streams,
// and its backward into kernel 6's cotangents, for Hopper (sm_90a).
//
// The JAX package leaves this step to XLA, which fuses the elementwise
// algebra into a few loops (nsfnet_tpu/ops/pallas_psi.py:373-380, then
// ops/residuals.py and ops/losses.py). In plain PyTorch the same algebra is
// ~100 launches forward and twice that backward, each a pass over N points
// and each a host dispatch; here it is one pass each way:
//
//   forward : the thirteen [N,2] raw streams of the (psi, p) head (only ten
//             are read: the value and the order-1 diagonal streams are not)
//             -> the (u, v, p) bundle (u = s psi_y, v = -s psi_x, mixed
//             partials from the diagonal sweeps) -> the momentum residuals
//             eq1, eq2 and, with the EVM net, the entropy residual eq4 ->
//             per block the weighted sums of squares sum(w * r^2), then one
//             block adds the blocks' sums in a fixed order: out[4] (EVM) or
//             out[3] = (S1, S2, S3, [S4]), S3 = 0 since continuity is exact.
//   backward: the same pass again, then the cotangents of the thirteen
//             streams (zeros where a stream or a column is not read) and of
//             e, from ct = d loss / d out, read on the device.
//
// The arithmetic is that of ops/derivatives.assemble_psi_bundle,
// ops/residuals.ev_ns_residuals / ns_residuals and ops/losses.masked_sum_sq
// in fp32, in the same order of operations; the backward is their chain
// rule written out (ops/psi_residual.plain_psi_residual_bwd is the same in
// PyTorch). What bounds both: bytes, 92 B read a point forward, ~200 B
// read and written backward; either is microseconds at N = 120,000, so the
// launches are the cost, and there are three.
//
// Fixed grids and a fixed order of sums make every launch bitwise
// repeatable.

#include <cuda_runtime.h>

namespace {

constexpr int kStreams = 13;
constexpr int kThreads = 256;
constexpr int kBlocks = 264;  // two per SM of the H100 SXM

struct Streams {
  const float2* s[kStreams];
};
struct Cotangents {
  float2* s[kStreams];
};

struct Scalars {
  float s;       // uv_scale: u = s psi_y, v = -s psi_x
  float c, c2;   // coord_scale per derivative order, and its square
  float inv_re;  // 1 / Re
  int evm;       // 1: eq4 and vis_t, e; 0: molecular viscosity only
};

// One point's bundle and residuals, as the plain path computes them.
struct Point {
  float u, v, u_x, u_y, v_x, v_y, nu, eq1, eq2, eq4;
};

__device__ __forceinline__ Point residual(const Streams& st, const float* e, const float* vis_t,
                                          long i, const Scalars& k) {
  const float2 g_x = st.s[1][i], g_y = st.s[2][i];
  const float psi_xx = st.s[5][i].x, psi_yy = st.s[6][i].x;
  const float m2 = st.s[7][i].x, n2 = st.s[8][i].x;
  const float psi_xxx = st.s[9][i].x, psi_yyy = st.s[10][i].x;
  const float m3 = st.s[11][i].x, n3 = st.s[12][i].x;
  const float psi_xy = (m2 - n2) * 0.25f;
  const float psi_xyy = ((m3 + n3) - 2.0f * psi_xxx) / 6.0f;
  const float psi_xxy = ((m3 - n3) - 2.0f * psi_yyy) / 6.0f;
  const float s = k.s, ns = -k.s;
  Point p;
  p.u = s * g_y.x;
  p.v = ns * g_x.x;
  p.u_x = (s * psi_xy) * k.c;
  p.v_x = (ns * psi_xx) * k.c;
  p.u_y = (s * psi_yy) * k.c;
  p.v_y = (ns * psi_xy) * k.c;
  const float p_x = g_x.y * k.c, p_y = g_y.y * k.c;
  const float u_xx = (s * psi_xxy) * k.c2, u_yy = (s * psi_yyy) * k.c2;
  const float v_xx = (ns * psi_xxx) * k.c2, v_yy = (ns * psi_xyy) * k.c2;
  p.nu = k.evm ? k.inv_re + vis_t[i] : k.inv_re;
  p.eq1 = ((p.u * p.u_x + p.v * p.u_y) + p_x) - p.nu * (u_xx + u_yy);
  p.eq2 = ((p.u * p.v_x + p.v * p.v_y) + p_y) - p.nu * (v_xx + v_yy);
  p.eq4 = k.evm ? (p.eq1 * (p.u - 0.5f) + p.eq2 * (p.v - 0.5f)) - e[i] : 0.0f;
  return p;
}

// Sum of v over the block, in a fixed order; the total lands in thread 0.
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red is reused by consecutive calls
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = 0.0f;
  if (warp == 0) {
    v = lane < kThreads / 32 ? red[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
psi_residual_fwd_kernel(Streams st, const float* e, const float* vis_t, const float* w, long n,
                        Scalars k, float* partial) {
  __shared__ float red[kThreads / 32];
  float a1 = 0.0f, a2 = 0.0f, a4 = 0.0f;
  for (long i = blockIdx.x * (long)kThreads + threadIdx.x; i < n; i += (long)gridDim.x * kThreads) {
    const Point p = residual(st, e, vis_t, i, k);
    const float wi = w[i];
    a1 += (wi * p.eq1) * p.eq1;
    a2 += (wi * p.eq2) * p.eq2;
    a4 += (wi * p.eq4) * p.eq4;
  }
  a1 = block_sum(a1, red);
  a2 = block_sum(a2, red);
  a4 = block_sum(a4, red);
  if (threadIdx.x == 0) {
    partial[3 * blockIdx.x + 0] = a1;
    partial[3 * blockIdx.x + 1] = a2;
    partial[3 * blockIdx.x + 2] = a4;
  }
}

// One block: out = (S1, S2, 0[, S4]) from the blocks' partial sums.
__global__ void __launch_bounds__(kThreads)
psi_residual_sum_kernel(const float* partial, int blocks, int evm, float* out) {
  __shared__ float red[kThreads / 32];
  float a[3] = {0.0f, 0.0f, 0.0f};
  for (int b = threadIdx.x; b < blocks; b += kThreads)
    for (int q = 0; q < 3; ++q) a[q] += partial[3 * b + q];
  for (int q = 0; q < 3; ++q) a[q] = block_sum(a[q], red);
  if (threadIdx.x == 0) {
    out[0] = a[0];
    out[1] = a[1];
    out[2] = 0.0f;
    if (evm) out[3] = a[2];
  }
}

__global__ void __launch_bounds__(kThreads)
psi_residual_bwd_kernel(Streams st, const float* e, const float* vis_t, const float* w, long n,
                        Scalars k, const float* ct, Cotangents out, float* g_e) {
  const float ct1 = ct[0], ct2 = ct[1], ct4 = k.evm ? ct[3] : 0.0f;
  const float sc = k.s * k.c, sc2 = k.s * k.c2;
  const float2 zero = make_float2(0.0f, 0.0f);
  for (long i = blockIdx.x * (long)kThreads + threadIdx.x; i < n; i += (long)gridDim.x * kThreads) {
    const Point p = residual(st, e, vis_t, i, k);
    const float wi = w[i];
    // cotangents of eq1, eq2, eq4: d(w r^2)/dr = 2 w r
    const float r1 = 2.0f * wi * p.eq1 * ct1, r2 = 2.0f * wi * p.eq2 * ct2;
    const float r4 = 2.0f * wi * p.eq4 * ct4;
    // eq4 = eq1 (u - 1/2) + eq2 (v - 1/2) - e
    const float t1 = r1 + r4 * (p.u - 0.5f), t2 = r2 + r4 * (p.v - 0.5f);
    const float du = t1 * p.u_x + t2 * p.v_x + r4 * p.eq1;
    const float dv = t1 * p.u_y + t2 * p.v_y + r4 * p.eq2;
    // u_xx, u_yy share -t1 nu; v_xx, v_yy share -t2 nu
    const float dlap_u = -t1 * p.nu, dlap_v = -t2 * p.nu;
    const float dpsi_xy = sc * (t1 * p.u - t2 * p.v);  // u_x = sc psi_xy, v_y = -sc psi_xy
    const float dpsi_xxy = sc2 * dlap_u;
    const float dpsi_xyy = -sc2 * dlap_v;
    const float dpsi_yyy = sc2 * dlap_u - dpsi_xxy / 3.0f;
    const float dpsi_xxx = -sc2 * dlap_v - dpsi_xyy / 3.0f;
    out.s[0][i] = zero;
    out.s[1][i] = make_float2(-k.s * dv, k.c * t1);  // v = -s psi_x; p_x
    out.s[2][i] = make_float2(k.s * du, k.c * t2);   // u = s psi_y; p_y
    out.s[3][i] = zero;
    out.s[4][i] = zero;
    out.s[5][i] = make_float2(-sc * (t2 * p.u), 0.0f);  // v_x = -sc psi_xx
    out.s[6][i] = make_float2(sc * (t1 * p.v), 0.0f);   // u_y = sc psi_yy
    out.s[7][i] = make_float2(0.25f * dpsi_xy, 0.0f);
    out.s[8][i] = make_float2(-0.25f * dpsi_xy, 0.0f);
    out.s[9][i] = make_float2(dpsi_xxx, 0.0f);
    out.s[10][i] = make_float2(dpsi_yyy, 0.0f);
    out.s[11][i] = make_float2((dpsi_xyy + dpsi_xxy) / 6.0f, 0.0f);
    out.s[12][i] = make_float2((dpsi_xyy - dpsi_xxy) / 6.0f, 0.0f);
    if (g_e) g_e[i] = -r4;
  }
}

// The solver builds the bundle at uv_scale = coord_scale (training/solver.py).
Scalars scalars(float coord_scale, float inv_re, int evm) {
  return Scalars{coord_scale, coord_scale, coord_scale * coord_scale, inv_re, evm};
}

}  // namespace

extern "C" {

// Floats of the forward's per-block partial sums; the wrapper allocates them.
int nsf_psi_residual_partial_floats() { return 3 * kBlocks; }

// Forward: out[3 | 4] <- (S1, S2, 0[, S4]), S_q = sum_i w_i eq_q(i)^2 over
// n points, the bundle and the residuals at coord_scale. streams: a host
// array of the thirteen [n, 2] stream pointers (kernel 5's outputs); e,
// vis_t: [n] (null when evm is 0); w: [n] weights,
// 0 on pad rows; partial: nsf_psi_residual_partial_floats() of scratch.
// Returns a cudaError_t code (0 = launched).
int nsf_psi_residual_fwd(const float* const* streams, const float* e, const float* vis_t,
                         const float* w, long n, float coord_scale, float inv_re, int evm,
                         float* partial, float* out, void* stream) {
  if (n < 1 || (evm && (!e || !vis_t))) return (int)cudaErrorInvalidValue;
  Streams st;
  for (int q = 0; q < kStreams; ++q) st.s[q] = reinterpret_cast<const float2*>(streams[q]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  psi_residual_fwd_kernel<<<kBlocks, kThreads, 0, s>>>(
      st, e, vis_t, w, n, scalars(coord_scale, inv_re, evm), partial);
  psi_residual_sum_kernel<<<1, kThreads, 0, s>>>(partial, kBlocks, evm, out);
  return (int)cudaGetLastError();
}

// Backward: cts[0..12] <- the [n, 2] cotangents of the thirteen streams (a
// host array of device pointers, every element written), g_e[n] <- that of
// e (null: not wanted; evm only), given ct[3 | 4] = d loss / d out on the
// device. The other arguments as for the forward.
int nsf_psi_residual_bwd(const float* const* streams, const float* e, const float* vis_t,
                         const float* w, long n, float coord_scale, float inv_re, int evm,
                         const float* ct, float* const* cts, float* g_e, void* stream) {
  if (n < 1 || (evm && (!e || !vis_t)) || (!evm && g_e)) return (int)cudaErrorInvalidValue;
  Streams st;
  Cotangents out;
  for (int q = 0; q < kStreams; ++q) {
    st.s[q] = reinterpret_cast<const float2*>(streams[q]);
    out.s[q] = reinterpret_cast<float2*>(cts[q]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  psi_residual_bwd_kernel<<<kBlocks, kThreads, 0, s>>>(
      st, e, vis_t, w, n, scalars(coord_scale, inv_re, evm), ct, out, g_e);
  return (int)cudaGetLastError();
}

}  // extern "C"
