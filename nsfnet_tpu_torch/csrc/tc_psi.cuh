// Tensor-core order-3 sweep for Hopper (sm_90a): the device code of the
// order-3 engine's pair (psi_streams.cu psi_fwd_kernel, psi_bwd_kernel),
// the 13-stream counterpart of tc_mlp.cuh's five-stream sweep. It ports the
// parts of nsfnet_tpu/ops/pallas_psi.py that _fwd_kernel and _bwd_kernel
// inline: _first_layer_packed (:138), _layer_packed (:152), the head (:186)
// and the hand-derived order-3 adjoint (:251-307), with every hidden-layer
// product on the tensor cores at the precision name's bf16 passes. From
// tc_mlp.cuh it takes the bf16 parts
// (split_pair / split_one, store_pair / store_one), ldmatrix and mma_passes,
// split_weights, stage_panel, stage_head, dw_product, sum_over_rows and
// flush_sums; read that header first.
//
// Pack: the value and the order-1/2/3 directional derivatives along e_x,
// e_y, (1,1), (1,-1), [ h | a_x a_y a_p a_m | b_x b_y b_p b_m | c_x c_y c_p
// c_m ] (packed_psi.cuh), stream-major: row q T + p holds stream q of point
// p. With t = tanh(z), d1..d4 the derivatives of tanh in t and z1..z3 the
// tangent rows of the same product, per direction:
//   forward : a' = d1 z1,  b' = d2 z1^2 + d1 z2,  c' = d3 z1^3 + 3 d2 z1 z2 + d1 z3
//   backward: g_z  = gh d1 + sum_dir [ gA d2 z1 + gB (d3 z1^2 + d2 z2)
//                                      + gC (d4 z1^3 + 3 d3 z1 z2 + d2 z3) ]
//             g_z1 = gA d1 + 2 gB d2 z1 + 3 gC (d3 z1^2 + d2 z2)
//             g_z2 = gB d1 + 3 gC d2 z1,  g_z3 = gC d1
//
// Two tile layouts, one code (T a template constant). A thread must hold
// every stream of its points, so that the epilogues run on the accumulator
// fragments; an m16n8k16 fragment gives a thread rows g and g+8 of its
// 16-row tile:
//   T = 16: a 16-row tile is one stream of the tile's 16 points (13 tiles);
//           a thread holds the 13 streams of points g and g+8.
//   T = 8:  a 16-row tile holds streams 2s and 2s+1 of the same 8 points;
//           the 13 streams are padded to 14 with a zero stream (7 tiles,
//           its rows zeroed once per launch and never written); a thread
//           holds the 13 streams of point g.
// The 8-point tile halves the carries, so that wide nets and "highest" fit
// in shared memory (ops/psi_streams.pick_bwd_tile chooses). A warp's unit
// of a row product is the tile's rows x 8 columns, acc[13 or 7][4]: 52 or
// 28 accumulators, and H / 8 units per product (10 at H = 80, one per warp).
//
// Tape (the backward's recompute only; a template flag of the forward, so
// that the forward kernel carries no branch for it). Per product layer, t
// and the 12 pre-activation tangents (fp32, [13][T][Hp]); t alone for the
// analytic first layer. The reverse sweep rebuilds the carry P_{l-1} from
// them with the forward's own rounded arithmetic (psi_carry), bit for bit,
// instead of storing the 13-row carry.
//
// The first layer stays the analytic broadcast of the direction rows, never
// a K = 2 product; its dW0 gets the direct terms (r_p adds into both rows,
// r_m into row x and, negated, into row y). The head (K outputs) runs on the
// CUDA cores with the same passes: a bf16 x bf16 product is exact in fp32.

#pragma once

#include "packed_psi.cuh"
#include "tc_mlp.cuh"

namespace {

template <int T>
struct PsiTile {
  static_assert(T == 16 || T == 8, "tiles of 16 or 8 points");
  static constexpr int S = T == 16 ? kPsi : kPsi + 1;  // streams of the carry layout
  static constexpr int MT = S * T / 16;                // m16 tiles of the carry: 13 or 7
  static constexpr int HALVES = T == 16 ? 2 : 1;       // points a thread holds in a unit
};

// Stream q of the thread's point half hf, column j (0, 1) in a unit's
// accumulators (the fragment layout above).
template <int T>
__device__ __forceinline__ float at(float (&acc)[PsiTile<T>::MT][4], int q, int hf, int j) {
  return T == 16 ? acc[q][2 * hf + j] : acc[q >> 1][2 * (q & 1) + j];
}

// Shared memory of one block, in bytes, region by region (16-byte aligned):
// two carry buffers [NP][S T][Hp+8] bf16 (resident plan only), the streamed
// plan's A panel [NP][S T][kpanel+8], the weight panel, the head weight parts
// [NP][Hp][K] bf16 (resident only), the head cotangents [13][T][K], their
// parts [NP][13T][K], the column sums [T/8][3][Hp] (resident only). The two
// plans are tc_mlp.cuh's (kpanel 0: resident).
struct PsiSmem {
  size_t carry, sa, wbuf, whs, hb, ghp, dbs;
  __host__ __device__ size_t total() const {
    return 2 * carry + sa + wbuf + whs + hb + ghp + dbs;
  }
};

__host__ __device__ inline int psi_streams_of(int tile) { return tile == 16 ? kPsi : kPsi + 1; }

__host__ __device__ inline PsiSmem psi_smem(int tile, int panel, int hp, int k, int np,
                                            int kpanel = 0) {
  PsiSmem s;
  const size_t rows = (size_t)psi_streams_of(tile) * tile;
  if (kpanel == 0) {
    s.carry = round16((size_t)np * rows * (hp + 8) * 2);
    s.sa = 0;
    size_t fwd = (size_t)hp * (panel + 8), bwd = (size_t)panel * (hp + 8);
    s.wbuf = round16((size_t)np * (fwd > bwd ? fwd : bwd) * 2);
    s.whs = round16((size_t)np * hp * k * 2);
    s.dbs = round16((size_t)(tile / 8) * 3 * hp * 4);
  } else {
    // the weight tile, forward [kpanel][panel+8] or backward [panel][kpanel+8],
    // or the dW product's cotangent panel [S T][kpanel+8]
    s.carry = s.whs = s.dbs = 0;
    const size_t a = rows * (kpanel + 8);
    size_t fwd = (size_t)kpanel * (panel + 8), bwd = (size_t)panel * (kpanel + 8);
    size_t w = fwd > bwd ? fwd : bwd;
    s.sa = round16((size_t)np * a * 2);
    s.wbuf = round16((size_t)np * (w > a ? w : a) * 2);
  }
  s.hb = round16((size_t)kPsi * tile * k * 4);
  s.ghp = round16((size_t)np * kPsi * tile * k * 4);
  return s;
}

// The streamed plan's global regions of one block, in floats: the two
// carries [NP][S T][Hp+8] bf16, the head weight parts [NP][Hp][K] bf16, the
// column sums [T/8][3][Hp].
__host__ __device__ inline size_t psi_carry_bytes(int tile, int hp, int np) {
  return round16((size_t)np * psi_streams_of(tile) * tile * (hp + 8) * 2);
}
__host__ __device__ inline long psi_carry_floats(int tile, int hp, int k, int np) {
  return (long)((2 * psi_carry_bytes(tile, hp, np) + round16((size_t)np * hp * k * 2) +
                 round16((size_t)(tile / 8) * 3 * hp * 4)) / 4);
}

// Whether (tile, panel, kpanel) is a plan the order-3 sweep takes for padded
// width hp: resident, a panel that tiles hp; streamed, 16-point tiles, an
// N-panel of at most one 8-column unit per warp and a K-panel, both
// multiples of 16.
__host__ __device__ inline bool psi_plan_ok(int hp, int tile, int panel, int kpanel) {
  if (panel <= 0 || panel % 16 != 0 || kpanel < 0 || kpanel % 16 != 0) return false;
  return kpanel == 0 ? hp % panel == 0 : tile == 16 && panel / 8 <= kTcWarps;
}

struct PsiRegions {
  bf16 *buf_a, *buf_b, *sa, *wb, *whs;
  float *hb, *ghp, *dbs;
};

__device__ inline PsiRegions psi_carve(unsigned char* smem, const PsiSmem& L) {
  PsiRegions r;
  r.buf_a = reinterpret_cast<bf16*>(smem);
  r.buf_b = reinterpret_cast<bf16*>(smem + L.carry);
  r.sa = reinterpret_cast<bf16*>(smem + 2 * L.carry);
  r.wb = reinterpret_cast<bf16*>(smem + 2 * L.carry + L.sa);
  unsigned char* f = smem + 2 * L.carry + L.sa + L.wbuf;
  r.whs = reinterpret_cast<bf16*>(f);
  r.hb = reinterpret_cast<float*>(f + L.whs);
  r.ghp = reinterpret_cast<float*>(f + L.whs + L.hb);
  r.dbs = reinterpret_cast<float*>(f + L.whs + L.hb + L.ghp);
  return r;
}

// The block's regions under either plan: on the streamed plan the carries,
// the head weight parts and the column sums are this block's part of
// `carries` (psi_carry_floats per block).
template <bool STREAM>
__device__ inline PsiRegions psi_regions(unsigned char* smem, float* carries, const TcShapes& sh,
                                         int np) {
  PsiRegions r =
      psi_carve(smem, psi_smem(sh.tile, sh.panel, sh.hp, sh.k, np, STREAM ? sh.kpanel : 0));
  if constexpr (STREAM) {
    unsigned char* g = reinterpret_cast<unsigned char*>(
        carries + blockIdx.x * psi_carry_floats(sh.tile, sh.hp, sh.k, np));
    const size_t c = psi_carry_bytes(sh.tile, sh.hp, np);
    r.buf_a = reinterpret_cast<bf16*>(g);
    r.buf_b = reinterpret_cast<bf16*>(g + c);
    r.whs = reinterpret_cast<bf16*>(g + 2 * c);
    r.dbs = reinterpret_cast<float*>(g + 2 * c + round16((size_t)np * sh.hp * sh.k * 2));
  }
  return r;
}

// Tape floats of one block: t0 [T][Hp], then [13][T][Hp] (t and the 12
// pre-activation tangents) for each product layer 1 .. L-1.
__host__ __device__ inline long psi_tape_floats(int tile, int hp, int n_hidden) {
  return (long)tile * hp * (1 + 13L * (n_hidden - 1));
}
__device__ inline long psi_tape_off(int l, int tile, int hp) {
  return l == 0 ? 0 : (long)tile * hp * (1 + 13L * (l - 1));
}

// ------------------------------------------------------------ tensor cores

__device__ __forceinline__ void ldsm_x2(uint32_t r[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t r[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// The passes a_i b_j, i + j < NP, on one n8 tile.
template <int NP>
__device__ __forceinline__ void mma_passes_n8(float acc[4], const uint32_t a[NP][4],
                                              const uint32_t b[NP][2]) {
#pragma unroll
  for (int i = 0; i < NP; ++i)
#pragma unroll
    for (int j = 0; j + i < NP; ++j) mma_bf16(acc, a[i], b[j][0], b[j][1]);
}

// One warp's unit of a row product over kn of the k dimension: the tile's
// S T rows x the 8 columns nb*8.. of the panel: acc[mt][4] += in[mt] x W for
// the MT m16 tiles. in: carry parts, part stride apart, row stride lda; wb:
// the weight parts, part stride bpart, row stride ldb, W[k][n] (forward: BT
// = true) or W[n][k] (backward).
template <int NP, int T, bool BT>
__device__ __forceinline__ void psi_row_mma(const bf16* in, int lda, long apart, const bf16* wb,
                                            int ldb, long bpart, int kn, int nb,
                                            float (&acc)[PsiTile<T>::MT][4]) {
  constexpr int MT = PsiTile<T>::MT;
  const int lane = threadIdx.x & 31;
  for (int k0 = 0; k0 < kn; k0 += 16) {
    uint32_t b[NP][2];  // lanes 0-7 address k rows 0-7, lanes 8-15 rows 8-15
    const int kh = ((lane >> 3) & 1) << 3;
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      if (BT)
        ldsm_x2_t(b[j], wb + j * bpart + (long)(k0 + (lane & 7) + kh) * ldb + nb * 8);
      else
        ldsm_x2(b[j], wb + j * bpart + (long)(nb * 8 + (lane & 7)) * ldb + k0 + kh);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t a[NP][4];
      const int r = mt * 16 + (lane & 15), kc = k0 + ((lane >> 4) << 3);
#pragma unroll
      for (int i = 0; i < NP; ++i) ldsm_x4(a[i], in + i * apart + (long)r * lda + kc);
      mma_passes_n8<NP>(acc[mt], a, b);
    }
  }
}

template <int T>
__device__ __forceinline__ void psi_zero_acc(float (&acc)[PsiTile<T>::MT][4]) {
#pragma unroll
  for (int mt = 0; mt < PsiTile<T>::MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[mt][e] = 0.0f;
}

// The resident plan's unit: the whole k dimension. in: carry parts
// [NP][S T][hp+8]; wb: the panel, [NP][hp][panel+8] (forward, W[k][n]: BT =
// true) or [NP][panel][hp+8] (backward, W[n][k]).
template <int NP, int T, bool BT>
__device__ __forceinline__ void psi_row_product(const bf16* in, const bf16* wb, int hp, int panel,
                                                int nb, float (&acc)[PsiTile<T>::MT][4]) {
  constexpr int rows = PsiTile<T>::S * T;
  psi_zero_acc<T>(acc);
  psi_row_mma<NP, T, BT>(in, hp + 8, (long)rows * (hp + 8), wb, BT ? panel + 8 : hp + 8,
                         BT ? (long)hp * (panel + 8) : (long)panel * (hp + 8), hp, nb, acc);
}

// The streamed plan's N-panel at c0 (width min(panel, hp - c0)): stages the
// K-panels of `in` into sa and of the weight parts wl [NP][hp][hp] into wb,
// accumulates the warp's 8-column unit over them and returns whether the
// warp owns one (unit = the warp).
template <int NP, int T, bool BT>
__device__ __forceinline__ bool psi_streamed_unit(const bf16* in, const bf16* __restrict__ wl,
                                                  bf16* sa, bf16* wb, int c0, const TcShapes& sh,
                                                  float (&acc)[PsiTile<T>::MT][4]) {
  constexpr int rows = PsiTile<T>::S * T;
  const int hp = sh.hp, nc = sh.panel, kp = sh.kpanel;
  const int warp = threadIdx.x >> 5, ncur = min(nc, hp - c0);
  const bool has = warp < ncur / 8;
  psi_zero_acc<T>(acc);
  for (int k0 = 0; k0 < hp; k0 += kp) {
    const int kc = min(kp, hp - k0);
    __syncthreads();  // the previous K-panel's readers are done
    stage_tile<NP, false>(sa, kp + 8, in, hp + 8, (long)rows * (hp + 8), 0, rows, k0, kc);
    if (BT)
      stage_tile<NP, true>(wb, nc + 8, wl, hp, (long)hp * hp, k0, kc, c0, ncur);
    else
      stage_tile<NP, true>(wb, kp + 8, wl, hp, (long)hp * hp, c0, ncur, k0, kc);
    __syncthreads();
    if (has)
      psi_row_mma<NP, T, BT>(sa, kp + 8, (long)rows * (kp + 8), wb, BT ? nc + 8 : kp + 8,
                             BT ? (long)kc * (nc + 8) : (long)ncur * (kp + 8), kc, warp, acc);
  }
  return has;
}

// ------------------------------------------------------------ the algebra
// The carries with rounded intrinsics (no contraction), so that the reverse
// sweep rebuilds the forward's carries bit for bit.

struct Chain3 {
  float d1, d2, d3;
};

__device__ __forceinline__ Chain3 chain3_rn(float t) {
  const float tt = __fmul_rn(t, t);
  const float d1 = __fsub_rn(1.0f, tt);
  const float d2 = __fmul_rn(__fmul_rn(-2.0f, t), d1);
  const float d3 = __fmul_rn(__fmul_rn(-2.0f, d1), __fsub_rn(1.0f, __fmul_rn(3.0f, tt)));
  return {d1, d2, d3};
}

// Hidden carry from t = tanh(z) and the tangents z[0..11] = (z1, z2, z3)
// of the four directions, direction-minor.
__device__ __forceinline__ void psi_carry(float t, const float z[12], float v[kPsi]) {
  const Chain3 c = chain3_rn(t);
  v[0] = t;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const float z1 = z[d], z2 = z[4 + d], z3 = z[8 + d];
    const float z11 = __fmul_rn(z1, z1);
    v[1 + d] = __fmul_rn(c.d1, z1);
    v[5 + d] = __fadd_rn(__fmul_rn(c.d2, z11), __fmul_rn(c.d1, z2));
    v[9 + d] = __fadd_rn(__fadd_rn(__fmul_rn(c.d3, __fmul_rn(z11, z1)),
                                   __fmul_rn(__fmul_rn(3.0f, c.d2), __fmul_rn(z1, z2))),
                         __fmul_rn(c.d1, z3));
  }
}

// The first layer's constant direction rows r_x, r_y, r_x + r_y, r_x - r_y.
__device__ __forceinline__ void dir_rows(float wx, float wy, float r[4]) {
  r[0] = wx;
  r[1] = wy;
  r[2] = __fadd_rn(wx, wy);
  r[3] = __fsub_rn(wx, wy);
}

// Analytic first-layer carry [t; d1 r; d2 r^2; d3 r^3].
__device__ __forceinline__ void psi_first_carry(float t, const float r[4], float v[kPsi]) {
  const Chain3 c = chain3_rn(t);
  v[0] = t;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const float rr = __fmul_rn(r[d], r[d]);
    v[1 + d] = __fmul_rn(c.d1, r[d]);
    v[5 + d] = __fmul_rn(c.d2, rr);
    v[9 + d] = __fmul_rn(c.d3, __fmul_rn(rr, r[d]));
  }
}

// Packed carry cotangent G -> pre-activation cotangent o at a tanh layer.
__device__ __forceinline__ void psi_gz(float t, const float z[12], const float G[kPsi],
                                       float o[kPsi]) {
  const TanhChain c = tanh_chain(t);
  float gz = G[0] * c.d1;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const float z1 = z[d], z2 = z[4 + d], z3 = z[8 + d];
    const float gA = G[1 + d], gB = G[5 + d], gC = G[9 + d];
    gz += gA * c.d2 * z1 + gB * (c.d3 * z1 * z1 + c.d2 * z2) +
          gC * (c.d4 * z1 * z1 * z1 + 3.0f * c.d3 * z1 * z2 + c.d2 * z3);
    o[1 + d] = gA * c.d1 + 2.0f * gB * c.d2 * z1 + gC * (3.0f * c.d3 * z1 * z1 + 3.0f * c.d2 * z2);
    o[5 + d] = gB * c.d1 + 3.0f * gC * c.d2 * z1;
    o[9 + d] = gC * c.d1;
  }
  o[0] = gz;
}

// The analytic first layer's gradient terms at one (point, unit):
// d += (dW0[0], dW0[1], db0) contributions (pallas_psi.py:285-307).
__device__ __forceinline__ void psi_first_terms(float t0, float wx, float wy, float px, float py,
                                                const float G[kPsi], float d[3]) {
  const TanhChain c = tanh_chain(t0);
  const float r[4] = {wx, wy, wx + wy, wx - wy};
  float gz0 = G[0] * c.d1, grow[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float rr = r[k] * r[k];
    const float gA = G[1 + k], gB = G[5 + k], gC = G[9 + k];
    gz0 += gA * c.d2 * r[k] + gB * c.d3 * rr + gC * c.d4 * (rr * r[k]);
    grow[k] = gA * c.d1 + 2.0f * gB * c.d2 * r[k] + 3.0f * gC * c.d3 * rr;
  }
  d[0] += px * gz0 + grow[0] + grow[2] + grow[3];
  d[1] += py * gz0 + grow[1] + grow[2] - grow[3];
  d[2] += gz0;
}

// ------------------------------------------------------------ forward

// Zeroes the padding stream's rows of a carry buffer (T = 8 only).
template <int NP, int T>
__device__ void zero_pad_stream(bf16* buf, int hp) {
  if (T == 16) return;
  constexpr int rows = PsiTile<T>::S * T;
  const int ld = hp + 8, per = T * ld;
  for (int idx = threadIdx.x; idx < NP * per; idx += blockDim.x) {
    const int i = idx / per, rem = idx - i * per;
    buf[((long)i * rows + kPsi * T) * ld + rem] = __float2bfloat16_rn(0.0f);
  }
}

// Analytic first layer of tile n0 -> carry parts in buf (with TAPE, t0
// kept in tape[0]).
template <int NP, int T, bool TAPE>
__device__ void psi_first_layer_tc(const float* __restrict__ x, long n0, int n,
                                   const float* __restrict__ w0, const float* __restrict__ b0,
                                   bf16* buf, float* tape, const TcShapes& sh) {
  const int h = sh.h, hp = sh.hp;
  for (int idx = threadIdx.x; idx < T * hp; idx += blockDim.x) {
    const int p = idx / hp, j = idx - p * hp;
    const bool live = n0 + p < n && j < h;
    float t = 0.f, wx = 0.f, wy = 0.f;
    if (j < h) {
      wx = w0[j];
      wy = w0[h + j];
      float px = live ? x[2 * (n0 + p)] : 0.f, py = live ? x[2 * (n0 + p) + 1] : 0.f;
      t = tanhf(px * wx + py * wy + b0[j]);
    }
    float r[4], v[kPsi];
    dir_rows(wx, wy, r);
    psi_first_carry(t, r, v);
    store_one<NP, kPsi, PsiTile<T>::S>(buf, T, hp, p, j, v);
    if constexpr (TAPE) tape[idx] = t;
  }
}

// The order-3 epilogue of one warp's unit u of the panel at c0: the carry
// parts into nxt and, with TAPE, t and the 12 tangents into lt.
template <int NP, int T, bool TAPE>
__device__ __forceinline__ void psi_fwd_epilogue(float (&acc)[PsiTile<T>::MT][4], int u, int c0,
                                                 const float* __restrict__ bias, bf16* nxt,
                                                 float* lt, const TcShapes& sh) {
  constexpr int S = PsiTile<T>::S;
  const int h = sh.h, hp = sh.hp, lane = threadIdx.x & 31, g = lane >> 2, cq = lane & 3;
  const int col = c0 + u * 8 + 2 * cq;
  const float bb0 = col < h ? bias[col] : 0.f, bb1 = col + 1 < h ? bias[col + 1] : 0.f;
#pragma unroll
  for (int hf = 0; hf < PsiTile<T>::HALVES; ++hf) {
    const int p = g + 8 * hf;
    float z0[12], z1[12];
#pragma unroll
    for (int q = 1; q < kPsi; ++q) {
      z0[q - 1] = at<T>(acc, q, hf, 0);
      z1[q - 1] = at<T>(acc, q, hf, 1);
    }
    const float t0 = tanhf(at<T>(acc, 0, hf, 0) + bb0);
    const float t1 = tanhf(at<T>(acc, 0, hf, 1) + bb1);
    float v0[kPsi], v1[kPsi];
    psi_carry(t0, z0, v0);
    psi_carry(t1, z1, v1);
    store_pair<NP, kPsi, S>(nxt, T, hp, p, col, v0, v1);
    if constexpr (TAPE) {
      st2(lt + (long)p * hp + col, t0, t1);
#pragma unroll
      for (int q = 1; q < kPsi; ++q) st2(lt + ((long)q * T + p) * hp + col, z0[q - 1], z1[q - 1]);
    }
  }
}

// Packed forward of tile n0 through the hidden layers, with the product
// layers on the tensor cores; with TAPE (the backward's recompute) keeping
// t and the tangents of every layer in the tape. Returns the buffer that
// holds the last carry. STREAM: the streamed plan (a template flag, as in
// tc_forward); sa: its A panel.
template <int NP, int T, bool STREAM, bool TAPE = true>
__device__ bf16* psi_tc_forward(const float* __restrict__ x, const float* __restrict__ flat,
                                const bf16* __restrict__ wsplit, long n0, int n,
                                const TcShapes& sh, bf16* buf_a, bf16* buf_b, bf16* sa, bf16* wb,
                                float* tape) {
  constexpr int MT = PsiTile<T>::MT;
  const int h = sh.h, hp = sh.hp, L = sh.n_hidden, nc = sh.panel;
  const int warp = threadIdx.x >> 5;
  psi_first_layer_tc<NP, T, TAPE>(x, n0, n, flat, flat + 2 * h, buf_a, tape, sh);
  bf16* cur = buf_a;
  bf16* nxt = buf_b;
  for (int l = 1; l < L; ++l) {
    const float* bias = flat + hidden_off(l, h) + (long)h * h;
    const bf16* wl = wsplit + (long)(l - 1) * NP * hp * hp;
    float* lt = TAPE ? tape + psi_tape_off(l, T, hp) : nullptr;
    for (int c0 = 0; c0 < hp; c0 += nc) {
      float acc[MT][4];
      if constexpr (STREAM) {
        if (psi_streamed_unit<NP, T, true>(cur, wl, sa, wb, c0, sh, acc))
          psi_fwd_epilogue<NP, T, TAPE>(acc, warp, c0, bias, nxt, lt, sh);
        continue;
      }
      __syncthreads();  // readers of the previous panel / writers of cur are done
      stage_panel<NP>(wb, wl, hp, 0, hp, c0, nc);
      __syncthreads();
      for (int u = warp; u < nc / 8; u += kTcWarps) {
        psi_row_product<NP, T, true>(cur, wb, hp, nc, u, acc);
        psi_fwd_epilogue<NP, T, TAPE>(acc, u, c0, bias, nxt, lt, sh);
      }
    }
    bf16* tmp = cur;  // the next layer's first panel synchronises before reading
    cur = nxt;
    nxt = tmp;
  }
  __syncthreads();
  return cur;
}

// Head on the last carry (CUDA cores, the same passes) -> hb [13][T][K]:
// rows q T + p (q < 13) of the carry layout, so the padding stream of
// 8-point tiles is never read. The value rows get the head bias. K, the
// head width, is a constant so that its loops unroll; K = 0 reads it from
// sh.k.
template <int NP, int T, int K>
__device__ void psi_head(const bf16* cur, const bf16* whs, const float* __restrict__ bh,
                         float* hb, const TcShapes& sh) {
  constexpr int R = kPsi * T, rows = PsiTile<T>::S * T;
  const int hp = sh.hp, ld = hp + 8;
  const int k = K > 0 ? K : sh.k;
  for (int idx = threadIdx.x; idx < R * k; idx += blockDim.x) {
    const int r = idx / k, kk = idx - r * k;
    float a = 0.f;
    for (int m = 0; m < hp; ++m) {
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const float pv = __bfloat162float(cur[((long)i * rows + r) * ld + m]);
#pragma unroll
        for (int j = 0; j + i < NP; ++j) a += pv * __bfloat162float(whs[((long)j * hp + m) * k + kk]);
      }
    }
    if (r < T) a += bh[kk];
    hb[idx] = a;
  }
}

// ------------------------------------------------------------ reverse sweep

// P_l parts rebuilt from the tape into buf (bit for bit the forward's).
template <int NP, int T>
__device__ void psi_rebuild(const float* __restrict__ tape, const float* __restrict__ w0, int l,
                            bf16* buf, const TcShapes& sh) {
  constexpr int B = 4;  // points in flight per thread
  const int h = sh.h, hp = sh.hp;
  const float* lt = tape + psi_tape_off(l, T, hp);
  const int SS = T * hp, nq = l == 0 ? 1 : kPsi;
  for (int base = threadIdx.x; base < SS; base += B * blockDim.x) {
    float z[B][kPsi];
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int idx = base + u * blockDim.x;
#pragma unroll
      for (int q = 0; q < kPsi; ++q) z[u][q] = idx < SS && q < nq ? lt[q * SS + idx] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int idx = base + u * blockDim.x;
      if (idx >= SS) break;
      const int p = idx / hp, j = idx - p * hp;
      float v[kPsi];
      if (l == 0) {
        float r[4];
        dir_rows(j < h ? w0[j] : 0.f, j < h ? w0[h + j] : 0.f, r);
        psi_first_carry(z[u][0], r, v);
      } else {
        psi_carry(z[u][0], z[u] + 1, v);
      }
      store_one<NP, kPsi, PsiTile<T>::S>(buf, T, hp, p, j, v);
    }
  }
}

// Head backward of one tile on the CUDA cores. cur: the last carry's parts;
// ghp: the head cotangent parts [NP][13T][k]; hb: the head cotangents (fp32,
// value rows give dbh). Adds dWh / dbh into dp (red_add); writes the last
// tanh layer's pre-activation cotangent as parts into gz_out, and the column
// sums of its bias gradient (or, for a one-layer net, the first layer's
// terms) into dbs. K, the head width, is a constant so that its loops unroll; K = 0
// reads it from sh.k.
template <int NP, int T, int K>
__device__ void psi_head_backward(const float* __restrict__ x, const float* __restrict__ flat,
                                  long n0, int n, const bf16* cur, const bf16* whs,
                                  const float* ghp, const float* hb,
                                  const float* __restrict__ tape, bf16* gz_out, float* dbs,
                                  float* dp, const TcShapes& sh) {
  constexpr int S = PsiTile<T>::S, R = kPsi * T;  // R: the head cotangents' rows
  const int h = sh.h, hp = sh.hp, L = sh.n_hidden, ld = hp + 8, rows = S * T;
  const int k = K > 0 ? K : sh.k;
  const long wh = head_off(L, h);
  for (int idx = threadIdx.x; idx < h * k; idx += blockDim.x) {  // dWh = P^T G
    const int m = idx / k, kk = idx - m * k;
    float a = 0.f;
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const float pv = __bfloat162float(cur[((long)i * rows + r) * ld + m]);
#pragma unroll
        for (int j = 0; j + i < NP; ++j) a += pv * ghp[((long)j * R + r) * k + kk];
      }
    }
    red_add(dp + wh + idx, a);
  }
  for (int kk = threadIdx.x; kk < k; kk += blockDim.x) {
    float a = 0.f;
    for (int p = 0; p < T; ++p) a += hb[p * k + kk];
    red_add(dp + wh + (long)h * k + kk, a);
  }
  // G = g_head Wh^T, then the last layer's g_z algebra (or, for a one-layer
  // net, the first layer's terms): one thread per unit and 8-point group,
  // column sums into dbs[group][3][hp] (flush_sums adds them to dp)
  const float* lt = tape + psi_tape_off(L - 1, T, hp);
  const long SS = (long)T * hp;
  for (int idx = threadIdx.x; idx < (T / 8) * hp; idx += blockDim.x) {
    const int grp = idx / hp, m = idx - grp * hp;
    float d[3] = {0.f, 0.f, 0.f};
    float wv[NP][K > 0 ? K : 1];  // this unit's head weight parts (K > 0)
#pragma unroll
    for (int j = 0; j < NP; ++j)
#pragma unroll
      for (int kk = 0; kk < K; ++kk) wv[j][kk] = __bfloat162float(whs[(j * hp + m) * K + kk]);
    for (int u = 0; u < 8; ++u) {
      const int p = grp * 8 + u;
      float tz[kPsi];
#pragma unroll
      for (int q = 0; q < kPsi; ++q) tz[q] = q == 0 || L > 1 ? lt[q * SS + (long)p * hp + m] : 0.f;
      float G[kPsi];
#pragma unroll
      for (int q = 0; q < kPsi; ++q) {
        float a = 0.f;
#pragma unroll
        for (int kk = 0; kk < k; ++kk)
#pragma unroll
          for (int i = 0; i < NP; ++i) {
            const float gv = ghp[((long)i * R + q * T + p) * k + kk];
#pragma unroll
            for (int j = 0; j + i < NP; ++j)
              a += gv * (K > 0 ? wv[j][kk] : __bfloat162float(whs[(j * hp + m) * k + kk]));
          }
        G[q] = a;
      }
      if (L > 1) {
        float z[kPsi];
        psi_gz(tz[0], tz + 1, G, z);
        store_one<NP, kPsi, S>(gz_out, T, hp, p, m, z);
        d[0] += z[0];
      } else if (m < h) {
        const bool live = n0 + p < n;
        psi_first_terms(tz[0], flat[m], flat[h + m], live ? x[2 * (n0 + p)] : 0.f,
                        live ? x[2 * (n0 + p) + 1] : 0.f, G, d);
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) dbs[((long)grp * 3 + a) * hp + m] = d[a];
  }
}

// The tape entries of one warp's unit u of the panel at c0 at layer l - 1
// (lt): t and, above the first layer, the 12 tangents.
template <int T>
__device__ __forceinline__ void psi_load_tape(float2 (&tp)[PsiTile<T>::HALVES][kPsi],
                                              const float* __restrict__ lt, int l, int u, int c0,
                                              const TcShapes& sh) {
  const int hp = sh.hp, lane = threadIdx.x & 31, g = lane >> 2, cq = lane & 3;
  const int col = c0 + u * 8 + 2 * cq;
  const long SS = (long)T * hp;
#pragma unroll
  for (int hf = 0; hf < PsiTile<T>::HALVES; ++hf)
#pragma unroll
    for (int q = 0; q < kPsi; ++q)
      tp[hf][q] = q == 0 || l > 1 ? ld2(lt + q * SS + (long)(g + 8 * hf) * hp + col)
                                  : make_float2(0.f, 0.f);
}

// The order-3 adjoint's epilogue of one warp's unit u of the panel at c0 at
// layer l: Gz_{l-1} parts into other and its column sums into dbs (or, at
// l = 1, the first layer's terms).
template <int NP, int T>
__device__ __forceinline__ void psi_rev_epilogue(float (&acc)[PsiTile<T>::MT][4],
                                                 float2 (&tp)[PsiTile<T>::HALVES][kPsi], int l,
                                                 int u, int c0, const float* __restrict__ x,
                                                 const float* __restrict__ flat, long n0, int n,
                                                 bf16* other, float* dbs, const TcShapes& sh) {
  constexpr int S = PsiTile<T>::S;
  const int h = sh.h, hp = sh.hp, lane = threadIdx.x & 31, g = lane >> 2, cq = lane & 3;
  const int col = c0 + u * 8 + 2 * cq;
  float s[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
#pragma unroll
  for (int hf = 0; hf < PsiTile<T>::HALVES; ++hf) {
    const int p = g + 8 * hf;
    float G0[kPsi], G1[kPsi];
#pragma unroll
    for (int q = 0; q < kPsi; ++q) {
      G0[q] = at<T>(acc, q, hf, 0);
      G1[q] = at<T>(acc, q, hf, 1);
    }
    if (l > 1) {
      float z0[12], z1[12], o0[kPsi], o1[kPsi];
#pragma unroll
      for (int q = 1; q < kPsi; ++q) {
        z0[q - 1] = tp[hf][q].x;
        z1[q - 1] = tp[hf][q].y;
      }
      psi_gz(tp[hf][0].x, z0, G0, o0);
      psi_gz(tp[hf][0].y, z1, G1, o1);
      store_pair<NP, kPsi, S>(other, T, hp, p, col, o0, o1);
      s[0][0] += o0[0];
      s[1][0] += o1[0];
    } else {
      const bool live = n0 + p < n;
      const float px = live ? x[2 * (n0 + p)] : 0.f;
      const float py = live ? x[2 * (n0 + p) + 1] : 0.f;
      if (col < h) psi_first_terms(tp[hf][0].x, flat[col], flat[h + col], px, py, G0, s[0]);
      if (col + 1 < h)
        psi_first_terms(tp[hf][0].y, flat[col + 1], flat[h + col + 1], px, py, G1, s[1]);
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (l > 1 && a > 0) break;
    const float v0 = sum_over_rows(s[0][a]), v1 = sum_over_rows(s[1][a]);
    if (g == 0) st2(dbs + (long)a * hp + col, v0, v1);
  }
}

// The product layers in reverse, from gz (the last tanh layer's
// pre-activation cotangent parts) down to the first layer's terms. other:
// the second carry buffer; dbs: column sums; STREAM and sa as for
// psi_tc_forward. Both carry buffers are overwritten. The caller
// synchronises before the call.
template <int NP, int T, bool STREAM>
__device__ void psi_reverse(const float* __restrict__ x, const float* __restrict__ flat,
                            const bf16* __restrict__ wsplit, long n0, int n, bf16* gz,
                            bf16* other, bf16* sa, bf16* wb, float* dbs,
                            const float* __restrict__ tape, float* dp, const TcShapes& sh) {
  constexpr int MT = PsiTile<T>::MT, S = PsiTile<T>::S, HALVES = PsiTile<T>::HALVES;
  const int h = sh.h, hp = sh.hp, L = sh.n_hidden, nc = sh.panel;
  const int warp = threadIdx.x >> 5;
  for (int l = L - 1; l >= 1; --l) {
    const bf16* wl = wsplit + (long)(l - 1) * NP * hp * hp;
    psi_rebuild<NP, T>(tape, flat, l - 1, other, sh);
    __syncthreads();
    if constexpr (STREAM)
      dw_streamed<NP, S>(other, gz, dp + hidden_off(l, h), sa, wb, T, h, hp, sh.kpanel);
    else
      dw_product<NP, S>(other, gz, dp + hidden_off(l, h), T, h, hp);
    const float* lt = tape + psi_tape_off(l - 1, T, hp);
    for (int c0 = 0; c0 < hp; c0 += nc) {
      float acc[MT][4];
      float2 tp[HALVES][kPsi];
      if constexpr (STREAM) {
        if (psi_streamed_unit<NP, T, false>(gz, wl, sa, wb, c0, sh, acc)) {
          psi_load_tape<T>(tp, lt, l, warp, c0, sh);
          psi_rev_epilogue<NP, T>(acc, tp, l, warp, c0, x, flat, n0, n, other, dbs, sh);
        }
        continue;
      }
      __syncthreads();  // the dW product / the previous panel are done with other, wb
      stage_panel<NP>(wb, wl, hp, c0, nc, 0, hp);
      __syncthreads();
      for (int u = warp; u < nc / 8; u += kTcWarps) {
        psi_load_tape<T>(tp, lt, l, u, c0, sh);  // in flight during the products
        psi_row_product<NP, T, false>(gz, wb, hp, nc, u, acc);
        psi_rev_epilogue<NP, T>(acc, tp, l, u, c0, x, flat, n0, n, other, dbs, sh);
      }
    }
    __syncthreads();
    flush_sums(dbs, 1, l - 1, dp, h, hp);
    bf16* tmp = gz;  // Gz_{l-1} now lives in other
    gz = other;
    other = tmp;
  }
}

}  // namespace
