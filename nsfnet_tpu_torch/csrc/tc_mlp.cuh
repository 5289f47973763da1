// Tensor-core packed-MLP sweep for Hopper (sm_90a): the device code of the
// fused residual-loss pair (fused_residual.cu) and of the five-stream
// engine's pair (mlp_streams.cu); the order-3 engine's pair (tc_psi.cuh)
// builds on its primitives. It ports the parts of
// nsfnet_tpu/ops/pallas_mlp.py that the TPU kernels inline
// (_first_layer_packed, _layer_packed, _forward_streams, _recompute_forward,
// _packed_reverse_sweep) with every matrix product of a hidden layer on the
// tensor cores.
//
// Precision. The JAX kernels take a precision name; here it arrives as the
// number of bf16 parts NP each operand is split into (round to nearest:
// a_0 = bf16(a), a_1 = bf16(a - a_0), a_2 = bf16(a - a_0 - a_1)), and every
// product runs the passes a_i b_j with i + j < NP, fp32 accumulation:
//   "default" NP = 1:  1 pass  (a_0 b_0)
//   "high"    NP = 2:  3 passes (a_0 b_0 + a_0 b_1 + a_1 b_0), JAX's bf16x3
//                      (pallas_mlp.py:111-129)
//   "highest" NP = 3:  6 passes, Mosaic's HIGHEST, about exact fp32
// A bf16 x bf16 product is exact in fp32, so the kernel and the plain version
// (ops/fused_residual.py) differ only in the order of the sums. Weights are
// split once per launch (split_weights); carries and cotangents are split
// by the epilogue that produces them and kept as bf16 parts, the operand the
// next product reads.
//
// Route: mma.sync.m16n8k16 (bf16 in, fp32 accumulators) fed by ldmatrix,
// not wgmma. A tile of T = 16 or 32 points makes a [5T, H] packed carry,
// stream-major ([5][T][H]); one warp computes a 16-point group x 16 units of
// all five streams, so the five accumulator fragments of one (point, unit)
// sit in the same thread and the tanh Taylor algebra (forward) and the g_z
// algebra (backward) run on the fragments in registers. wgmma's 64-row
// warpgroup tiles do not divide the 5 x 16 rows of a point group, so a
// point's five streams would not meet in one thread without a shared-memory
// round trip before every epilogue.
//
// Products per hidden layer l (W_l [H, H], P packed carry, G cotangent):
//   forward  Z = P W        A: carry parts (ldmatrix), B: W parts (.trans)
//   backward G = Gz W^T     A: Gz parts,             B: W parts
//            dW += P^T Gz   A: P parts (.trans),     B: Gz parts (.trans)
// The head (K outputs) runs the same passes on the CUDA cores: a bf16 x bf16
// product is exact in fp32, so its result is that of the tensor cores.
//
// Widths. H is zero-padded to Hp, a multiple of 16, in the carries and in
// the launch's split copy of the weights: padded weight rows / columns and
// bias are zero, so padded units have t = 0
// and feed nothing (the role of _pad_params_lanes, pallas_mlp.py:371-413).
// Only real entries reach the gradient.
//
// Two plans (TcShapes::kpanel). The resident plan (kpanel = 0) keeps both
// packed carries in shared memory and stages the weight in column (forward)
// or row (backward) panels of `panel` units. Its carries grow with H, so it
// stops at some width (ops/fused_residual.pick_loss_tile). The streamed plan
// (kpanel > 0), taken only where no resident plan fits, keeps the carries,
// the head weight parts and the column sums in a block-private global
// scratch (tc_carry_floats) and stages per product a K-panel of the A
// operand [NP][5T][kpanel] and a [kpanel x panel] tile of the weight parts:
// its shared memory does not grow with H. Each warp then owns at most one
// 16-point x 16-unit output unit of an N-panel and accumulates it over the
// K-panels in registers, in the resident plan's k order, so that at equal
// tiles the two plans give bitwise-equal outputs.
//
// The weight ring (resident plan). The weight panels a block reads do not
// depend on the data: per tile W_1 .. W_{L-1} in the forward layout W[k][n],
// N-panel by N-panel, then, in a backward kernel, W_{L-1} .. W_1 in the
// layout W[n][k]. Each product's panel is cut into K-slots of kx rows
// (forward) or columns (backward), and the block holds a ring of `depth`
// slots in shared memory (tc_ring): while the warps run the product on one
// slot, the block's threads fill the other with cp.async copies of the next
// K-slot of the stream, which may belong to the next N-panel, layer, sweep
// or tile, so it also flies during the epilogues, the head, the carry
// rebuild and the dW product. Each warp accumulates its unit over the
// K-slots in ascending k, the mma_passes calls of one whole-panel product in
// their order, so the outputs are bitwise those of staging the whole panel.
// A product is cut in K only where each warp has at most one unit (its
// accumulators then stay in registers across the slots). Where not even two
// slots fit beside the plan's carries, the depth is 1: each slot is copied
// and waited for before its product, the synchronous staging.
//
// Backward tape. The recompute keeps, per tanh layer, only t and the four
// pre-activation tangents (fp32, [5][T][Hp]; t alone for the analytic first
// layer) in a block-private global scratch. The reverse sweep rebuilds the
// carry P_{l-1} from them with the forward's own arithmetic (carry_from_t),
// bit for bit, instead of storing it.
//
// Grid. A fixed number of persistent blocks (a constant of the wrapper, not
// the SM count) loops over tiles; each block adds into one partial, and
// sum_partials adds them in block order. Inside the tile loop the partial is
// never read, only added to, and each of its elements by one owning thread
// (red_add): that thread's reductions land in its program order, so equal
// inputs give bitwise-equal outputs, and no warp waits for the partial's
// load. A ragged last tile reads rows >= n as zero points; the callers give
// them zero weight.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_mlp.cuh"

namespace {

constexpr int kTcWarps = 10;  // 80 units = 5 n16-blocks x 2 point groups at T = 32
constexpr int kTcThreads = 32 * kTcWarps;

typedef __nv_bfloat16 bf16;

__host__ __device__ inline int pad16(int h) { return (h + 15) / 16 * 16; }
__host__ __device__ inline size_t round16(size_t b) { return (b + 15) / 16 * 16; }

struct TcShapes {
  int n_hidden;  // tanh layers
  int h;         // real hidden width
  int hp;        // padded width, a multiple of 16
  int k;         // head outputs
  int tile;      // points per tile: 16 or 32
  int panel;     // weight panel width (resident: divides hp; streamed: the N-panel)
  int kpanel;    // 0: the resident plan; else the streamed plan's K-panel
};

// Shared memory of one block, in bytes, region by region (16-byte aligned):
// two carry buffers [NP][5T][Hp+8] bf16 (resident only), the streamed A
// panel [NP][5T][kpanel+8] (streamed only), the weight buffer (resident: the
// ring's `depth` slots), the head weight parts [NP][Hp][K] bf16 (resident
// only), the head streams [5][T][K], the head cotangent parts [NP][5T][K],
// the loss terms [4][T], the column sums [T/8][3][Hp] (resident only).
struct TcSmem {
  size_t carry, sa, wbuf, whs, hb, ghp, red, dbs;
  int depth, kx;  // the weight ring (resident plan; 0 on the streamed plan)
  __host__ __device__ size_t total() const {
    return 2 * carry + sa + wbuf + whs + hb + ghp + red + dbs;
  }
};

// Bytes of one K-slot of the ring: kx rows of a forward panel [kx][panel+8]
// or kx columns of a backward panel [panel][kx+8], NP parts.
__host__ __device__ inline size_t ring_slot_bytes(int panel, int kx, int np) {
  const size_t fwd = (size_t)kx * (panel + 8), bwd = (size_t)panel * (kx + 8);
  return round16((size_t)np * (fwd > bwd ? fwd : bwd) * 2);
}

// The ring beside `rest` bytes of the block's other regions: two slots of
// the widest K-extent, a multiple of 16 dividing hp, that fit (cut below hp
// only where each warp has at most one unit of the panel); else one slot of
// the whole panel.
__host__ __device__ inline void tc_ring(int tile, int panel, int hp, int np, size_t rest,
                                        int& depth, int& kx) {
  const bool cut = (tile / 16) * (panel / 16) <= kTcWarps;
  for (kx = hp; kx >= 16; kx -= 16)
    if (hp % kx == 0 && (kx == hp || cut) &&
        rest + 2 * ring_slot_bytes(panel, kx, np) <= (size_t)kMaxSmem) {
      depth = 2;
      return;
    }
  depth = 1;
  kx = hp;
}

__host__ __device__ inline TcSmem tc_smem(int tile, int panel, int hp, int k, int np,
                                          int kpanel = 0) {
  TcSmem s;
  s.depth = s.kx = 0;
  if (kpanel == 0) {
    s.carry = round16((size_t)np * 5 * tile * (hp + 8) * 2);
    s.sa = 0;
    s.whs = round16((size_t)np * hp * k * 2);
    s.dbs = round16((size_t)(tile / 8) * 3 * hp * 4);
  } else {
    // the weight tile, forward [kpanel][panel+8] or backward [panel][kpanel+8],
    // or the dW product's cotangent panel [5T][kpanel+8]
    s.carry = s.whs = s.dbs = 0;
    const size_t a = (size_t)5 * tile * (kpanel + 8);
    size_t fwd = (size_t)kpanel * (panel + 8), bwd = (size_t)panel * (kpanel + 8);
    size_t w = fwd > bwd ? fwd : bwd;
    s.sa = round16((size_t)np * a * 2);
    s.wbuf = round16((size_t)np * (w > a ? w : a) * 2);
  }
  s.hb = round16((size_t)5 * tile * k * 4);
  s.ghp = round16((size_t)np * 5 * tile * k * 4);
  s.red = round16((size_t)4 * tile * 4);
  if (kpanel == 0) {
    s.wbuf = 0;
    tc_ring(tile, panel, hp, np, s.total(), s.depth, s.kx);
    s.wbuf = s.depth * ring_slot_bytes(panel, s.kx, np);
  }
  return s;
}

// The streamed plan's global regions of one block, in floats: the two
// carries [NP][5T][Hp+8] bf16, the head weight parts [NP][Hp][K] bf16, the
// column sums [T/8][3][Hp].
__host__ __device__ inline size_t tc_carry_bytes(int tile, int hp, int np) {
  return round16((size_t)np * 5 * tile * (hp + 8) * 2);
}
__host__ __device__ inline long tc_carry_floats(int tile, int hp, int k, int np) {
  return (long)((2 * tc_carry_bytes(tile, hp, np) + round16((size_t)np * hp * k * 2) +
                 round16((size_t)(tile / 8) * 3 * hp * 4)) / 4);
}

// Whether (tile, panel, kpanel) is a plan the sweep takes for padded width
// hp: resident, a panel that tiles hp; streamed, an N-panel whose 16 x 16
// units are at most one per warp and a K-panel, both multiples of 16.
__host__ __device__ inline bool tc_plan_ok(int hp, int tile, int panel, int kpanel) {
  if (panel <= 0 || panel % 16 != 0 || kpanel < 0 || kpanel % 16 != 0) return false;
  return kpanel == 0 ? hp % panel == 0 : (tile / 16) * (panel / 16) <= kTcWarps;
}

// Scratch floats of one block: t0 [T][Hp], then [5][T][Hp] (t, z_x, z_y,
// z_xx, z_yy) for each product layer 1 .. L-1.
__host__ __device__ inline long tc_scratch_floats(int tile, int hp, int n_hidden) {
  return (long)tile * hp * (1 + 5L * (n_hidden - 1));
}
__device__ inline long tc_tape_off(int l, int tile, int hp) {
  return l == 0 ? 0 : (long)tile * hp * (1 + 5L * (l - 1));
}

// The regions of tc_smem in one block's dynamic shared memory.
struct TcRegions {
  bf16 *buf_a, *buf_b, *sa, *wb, *whs;
  float *hb, *ghp, *red, *dbs;
};

__device__ inline TcRegions carve(unsigned char* smem, const TcSmem& L) {
  TcRegions r;
  r.buf_a = reinterpret_cast<bf16*>(smem);
  r.buf_b = reinterpret_cast<bf16*>(smem + L.carry);
  r.sa = reinterpret_cast<bf16*>(smem + 2 * L.carry);
  r.wb = reinterpret_cast<bf16*>(smem + 2 * L.carry + L.sa);
  unsigned char* f = smem + 2 * L.carry + L.sa + L.wbuf;
  r.whs = reinterpret_cast<bf16*>(f);
  r.hb = reinterpret_cast<float*>(f + L.whs);
  r.ghp = reinterpret_cast<float*>(f + L.whs + L.hb);
  r.red = reinterpret_cast<float*>(f + L.whs + L.hb + L.ghp);
  r.dbs = reinterpret_cast<float*>(f + L.whs + L.hb + L.ghp + L.red);
  return r;
}

// The block's regions under either plan: on the streamed plan the carries,
// the head weight parts and the column sums are this block's part of
// `carries` (tc_carry_floats per block).
template <bool STREAM>
__device__ inline TcRegions tc_regions(unsigned char* smem, float* carries, const TcShapes& sh,
                                       int np) {
  TcRegions r = carve(smem, tc_smem(sh.tile, sh.panel, sh.hp, sh.k, np, STREAM ? sh.kpanel : 0));
  if constexpr (STREAM) {
    unsigned char* g = reinterpret_cast<unsigned char*>(
        carries + blockIdx.x * tc_carry_floats(sh.tile, sh.hp, sh.k, np));
    const size_t c = tc_carry_bytes(sh.tile, sh.hp, np);
    r.buf_a = reinterpret_cast<bf16*>(g);
    r.buf_b = reinterpret_cast<bf16*>(g + c);
    r.whs = reinterpret_cast<bf16*>(g + 2 * c);
    r.dbs = reinterpret_cast<float*>(g + 2 * c + round16((size_t)np * sh.hp * sh.k * 2));
  }
  return r;
}

// ---------------------------------------------------------------- bf16 parts

template <int NP>
__device__ __forceinline__ void split_pair(float v0, float v1, uint32_t out[NP]) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);  // .x = v0: the lower column
    out[i] = *reinterpret_cast<uint32_t*>(&h);
    v0 = __fsub_rn(v0, __low2float(h));  // exact: the remainder has <= 16 bits
    v1 = __fsub_rn(v1, __high2float(h));
  }
}

template <int NP>
__device__ __forceinline__ void split_one(float v, bf16 out[NP]) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    out[i] = __float2bfloat16_rn(v);
    v = __fsub_rn(v, __bfloat162float(out[i]));
  }
}

// ------------------------------------------------------ tensor-core wrappers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// c += a b for one m16n8k16 tile: a row-major bf16, b col-major bf16, c fp32.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The passes a_i b_j, i + j < NP, on two n8 tiles (b[j] holds both).
template <int NP>
__device__ __forceinline__ void mma_passes(float acc[2][4], const uint32_t a[NP][4],
                                           const uint32_t b[NP][4]) {
#pragma unroll
  for (int i = 0; i < NP; ++i)
#pragma unroll
    for (int j = 0; j + i < NP; ++j) {
      mma_bf16(acc[0], a[i], b[j][0], b[j][1]);
      mma_bf16(acc[1], a[i], b[j][2], b[j][3]);
    }
}

// ------------------------------------------------------------ the algebra
// One function per formula, with rounded intrinsics (no contraction), so the
// reverse sweep rebuilds the forward's carries bit for bit.

// Hidden carry from t = tanh(z) and the pre-activation tangents.
__device__ __forceinline__ void carry_from_t(float t, float zx, float zy, float zxx, float zyy,
                                             float v[5]) {
  const float s = __fsub_rn(1.0f, __fmul_rn(t, t));
  const float c = __fmul_rn(__fmul_rn(-2.0f, t), s);
  v[0] = t;
  v[1] = __fmul_rn(s, zx);
  v[2] = __fmul_rn(s, zy);
  v[3] = __fadd_rn(__fmul_rn(__fmul_rn(c, zx), zx), __fmul_rn(s, zxx));
  v[4] = __fadd_rn(__fmul_rn(__fmul_rn(c, zy), zy), __fmul_rn(s, zyy));
}

// Analytic first-layer carry [t; s wx; s wy; c wx^2; c wy^2].
__device__ __forceinline__ void first_carry(float t, float wx, float wy, float v[5]) {
  const float s = __fsub_rn(1.0f, __fmul_rn(t, t));
  const float c = __fmul_rn(__fmul_rn(-2.0f, t), s);
  v[0] = t;
  v[1] = __fmul_rn(s, wx);
  v[2] = __fmul_rn(s, wy);
  v[3] = __fmul_rn(c, __fmul_rn(wx, wx));
  v[4] = __fmul_rn(c, __fmul_rn(wy, wy));
}

// Packed carry cotangent G -> pre-activation cotangent Gz at a tanh layer.
__device__ __forceinline__ void gz_from(float t, float zx, float zy, float zxx, float zyy,
                                        const float G[5], float z[5]) {
  const float s = 1.0f - t * t;
  const float c = -2.0f * t * s;
  const float u6 = (6.0f * t * t - 2.0f) * s;
  z[0] = G[0] * s + (G[1] * zx + G[2] * zy) * c + G[3] * (u6 * zx * zx + c * zxx) +
         G[4] * (u6 * zy * zy + c * zyy);
  z[1] = G[1] * s + 2.0f * G[3] * c * zx;
  z[2] = G[2] * s + 2.0f * G[4] * c * zy;
  z[3] = G[3] * s;
  z[4] = G[4] * s;
}

// The analytic first layer's gradient terms at one (point, unit):
// d += (dW0[0], dW0[1], db0) contributions (pallas_mlp.py:296-310).
__device__ __forceinline__ void first_terms(float t0, float wx, float wy, float px, float py,
                                            const float G[5], float d[3]) {
  const float s0 = 1.0f - t0 * t0;
  const float c0 = -2.0f * t0 * s0;
  const float u0 = (6.0f * t0 * t0 - 2.0f) * s0;
  const float gz0 = G[0] * s0 + (G[1] * wx + G[2] * wy) * c0 +
                    (G[3] * (wx * wx) + G[4] * (wy * wy)) * u0;
  d[0] += px * gz0 + G[1] * s0 + 2.0f * G[3] * c0 * wx;
  d[1] += py * gz0 + G[2] * s0 + 2.0f * G[4] * c0 * wy;
  d[2] += gz0;
}

// ------------------------------------------------------------ staging

// Global loads in flight per thread in the elementwise loops: a loop that
// stores between its loads would otherwise wait out one L2 round trip per item.
constexpr int kBatch = 8;

// The hidden weights W_1 .. W_{L-1}, each split once per launch into NP
// parts zero-padded to hp x hp: wsplit[l-1][NP][hp][hp] bf16. Staging a
// panel is then a copy of 16-byte rows.
__host__ __device__ inline long tc_wsplit_elems(int n_hidden, int hp, int np) {
  return (long)(n_hidden > 1 ? n_hidden - 1 : 1) * np * hp * hp;
}

template <int NP>
__global__ void split_weights(const float* __restrict__ flat, int n_hidden, int h, int hp,
                              bf16* wsplit) {
  const long per = (long)hp * hp, total = (long)(n_hidden - 1) * per;
  for (long idx = (long)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (long)gridDim.x * blockDim.x) {
    const int l = 1 + (int)(idx / per), r = (int)(idx % per) / hp, c = (int)(idx % per) % hp;
    bf16 part[NP];
    split_one<NP>(r < h && c < h ? flat[hidden_off(l, h) + (long)r * h + c] : 0.0f, part);
#pragma unroll
    for (int i = 0; i < NP; ++i) wsplit[((long)(l - 1) * NP + i) * per + idx % per] = part[i];
  }
}

// Splits the hidden weights into wsplit (tc_wsplit_elems bf16) on stream s.
template <int NP>
int launch_split(const float* flat, const TcShapes& sh, bf16* wsplit, cudaStream_t s) {
  if (sh.n_hidden < 2) return 0;
  const long total = (long)(sh.n_hidden - 1) * sh.hp * sh.hp;
  split_weights<NP><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(flat, sh.n_hidden, sh.h,
                                                                    sh.hp, wsplit);
  return (int)cudaGetLastError();
}

// Rows [r0, r0+nr) x columns [c0, c0+nc) of each of the NP parts of src
// (part stride src_part, row stride src_ld) into dst[NP][nr][dst_ld], 8
// bf16 (16 bytes) at a time. RO: src is read-only for the kernel's life
// (the split weights: the non-coherent cache path); a carry that the block
// writes is read with plain loads.
template <int NP, bool RO>
__device__ void stage_tile(bf16* dst, int dst_ld, const bf16* src, int src_ld, long src_part,
                           int r0, int nr, int c0, int nc) {
  const int row8 = nc / 8, per_part = nr * row8, total = NP * per_part;
  for (int base = threadIdx.x; base < total; base += kBatch * blockDim.x) {
    uint4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * blockDim.x;
      const int i = idx / per_part, rem = idx - i * per_part, r = rem / row8;
      if (idx < total) {
        const uint4* p = reinterpret_cast<const uint4*>(
            src + i * src_part + (long)(r0 + r) * src_ld + c0 + 8 * (rem - r * row8));
        v[u] = RO ? __ldg(p) : *p;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * blockDim.x;
      if (idx >= total) break;
      const int i = idx / per_part, rem = idx - i * per_part, r = rem / row8;
      *reinterpret_cast<uint4*>(dst + ((long)i * nr + r) * dst_ld + 8 * (rem - r * row8)) = v[u];
    }
  }
}

// Rows [r0, r0+nr) x columns [c0, c0+nc) of the layer's parts wl[NP][hp][hp]
// into wb[NP][nr][nc+8].
template <int NP>
__device__ void stage_panel(bf16* wb, const bf16* __restrict__ wl, int hp, int r0, int nr,
                            int c0, int nc) {
  stage_tile<NP, true>(wb, nc + 8, wl, hp, (long)hp * hp, r0, nr, c0, nc);
}

// Head weight [h, k] -> whs[NP][hp][k] bf16 parts.
template <int NP>
__device__ void stage_head(bf16* whs, const float* __restrict__ wh, int h, int hp, int k) {
  for (int idx = threadIdx.x; idx < hp * k; idx += blockDim.x) {
    const int m = idx / k;
    bf16 part[NP];
    split_one<NP>(m < h ? wh[idx] : 0.0f, part);
#pragma unroll
    for (int i = 0; i < NP; ++i) whs[(long)i * hp * k + idx] = part[i];
  }
}

// ------------------------------------------------------------ the weight ring

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One K-slot of the block's stream: layer l (1 .. L-1) of the forward (bwd
// false) or of the reverse sweep, the N-panel at c0, the K-slot at k0.
struct WSlot {
  int l, c0, k0;
  bool bwd;
};

// A block's ring (the header note): `depth` slots of `slot` elements from
// `base`, each holding kx rows (forward) or columns (backward) of a panel;
// the K-slot with index i of the stream lives in slot i % depth, and `seq`
// counts those acquired so far.
struct TcRing {
  bf16* base;
  const bf16* wsplit;
  long slot;
  int depth, kx, seq;
  bool reverse;    // the stream runs on into the reverse sweep (backward kernels)
  bool last_tile;  // the block's current tile is its last: the stream ends with it
};

// Starts the cp.async copies of K-slot s into dst: forward, rows
// [k0, k0+kx) x columns [c0, c0+panel) into [NP][kx][panel+8]; backward,
// rows [c0, c0+panel) x columns [k0, k0+kx) into [NP][panel][kx+8]; one
// commit group. A thread copies one 16-byte column of a row group, so its
// addresses step by whole rows.
template <int NP>
__device__ void ring_issue(const TcRing& rg, const WSlot& s, bf16* dst, const TcShapes& sh) {
  const int hp = sh.hp, nc = sh.panel;
  const int r0 = s.bwd ? s.c0 : s.k0, nr = s.bwd ? nc : rg.kx;
  const int c0 = s.bwd ? s.k0 : s.c0, ncol = s.bwd ? rg.kx : nc;
  const int row8 = ncol / 8, step = blockDim.x / row8, r1 = threadIdx.x / row8;
  const int c = 8 * (threadIdx.x - r1 * row8);
  const bf16* src = rg.wsplit + (long)(s.l - 1) * NP * hp * hp + (long)r0 * hp + c0 + c;
  if (r1 < step) {
#pragma unroll
    for (int i = 0; i < NP; ++i)
      for (int r = r1; r < nr; r += step)
        cp_async16(dst + ((long)i * nr + r) * (ncol + 8) + c,
                   src + (long)i * hp * hp + (long)r * hp);
  }
  cp_async_commit();
}

// Moves s to the K-slot after it in the block's stream; false where the
// stream ends (the block's last tile is done).
__device__ inline bool ring_next(const TcRing& rg, const TcShapes& sh, WSlot& s) {
  if ((s.k0 += rg.kx) < sh.hp) return true;
  s.k0 = 0;
  if ((s.c0 += sh.panel) < sh.hp) return true;
  s.c0 = 0;
  if (!s.bwd && s.l + 1 < sh.n_hidden) {
    ++s.l;
    return true;
  }
  if (!s.bwd && rg.reverse) {  // the reverse sweep starts at the forward's last layer
    s.bwd = true;
    return true;
  }
  if (s.bwd && s.l > 1) {
    --s.l;
    return true;
  }
  s = WSlot{1, 0, 0, false};  // the next tile's first
  return !rg.last_tile;
}

// The ring of a block that runs the tiles blockIdx.x, + gridDim.x, ... <
// n_tiles; at depth 2 the copies of its first K-slot start now, ahead of the
// first tile's first layer. The streamed plan has no ring.
template <int NP, bool STREAM>
__device__ TcRing ring_begin(bf16* wb, const bf16* wsplit, const TcShapes& sh, bool reverse,
                             int n_tiles) {
  TcRing rg{wb, wsplit, 0, 0, 0, 0, reverse, false};
  if constexpr (!STREAM) {
    const TcSmem m = tc_smem(sh.tile, sh.panel, sh.hp, sh.k, NP);
    rg.depth = m.depth;
    rg.kx = m.kx;
    rg.slot = (long)(ring_slot_bytes(sh.panel, m.kx, NP) / sizeof(bf16));
    if (rg.depth == 2 && sh.n_hidden > 1 && (int)blockIdx.x < n_tiles)
      ring_issue<NP>(rg, WSlot{1, 0, 0, false}, wb, sh);
  }
  return rg;
}

// The slot that holds K-slot s, the next of the block's stream, once every
// thread's copies of it have landed and the block has synchronised; at
// depth 2 the copies of the K-slot after s then start into the other slot,
// whose readers (the product on the K-slot before s) that barrier has seen
// done. At depth 1 the one slot's readers are waited for first, then s is
// copied: the synchronous staging.
template <int NP>
__device__ const bf16* ring_acquire(TcRing& rg, const WSlot& s, const TcShapes& sh) {
  bf16* slot = rg.base + (rg.depth == 2 ? (rg.seq & 1) * rg.slot : 0);
  if (rg.depth == 1) {
    __syncthreads();
    ring_issue<NP>(rg, s, slot, sh);
  }
  cp_async_wait_all();
  __syncthreads();
  WSlot nx = s;
  if (rg.depth == 2 && ring_next(rg, sh, nx))
    ring_issue<NP>(rg, nx, rg.base + ((rg.seq + 1) & 1) * rg.slot, sh);
  ++rg.seq;
  return slot;
}

// ------------------------------------------------------------ products

// One warp's unit of a row product over kn of the k dimension: the 16-point
// group pg x the 16 columns nb*16.. of the panel, all five streams:
// acc[q][tile][4] += in[q] x W. in: carry parts, part stride apart, row
// stride lda; wb: the weight parts, part stride bpart, row stride ldb,
// W[k][n] (forward: BT = true) or W[n][k] (backward: BT = false).
template <int NP, bool BT>
__device__ __forceinline__ void row_mma(const bf16* in, int lda, long apart, const bf16* wb,
                                        int ldb, long bpart, int kn, int tile, int pg, int nb,
                                        float (&acc)[5][2][4]) {
  const int lane = threadIdx.x & 31, mi = lane >> 3;
  for (int k0 = 0; k0 < kn; k0 += 16) {
    uint32_t b[NP][4];
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      if (BT) {
        const int kr = k0 + (lane & 7) + ((mi & 1) << 3);
        const int nn = nb * 16 + ((mi >> 1) << 3);
        ldsm_x4_t(b[j], wb + j * bpart + (long)kr * ldb + nn);
      } else {
        const int nn = nb * 16 + (lane & 7) + ((mi >> 1) << 3);
        const int kc = k0 + ((mi & 1) << 3);
        ldsm_x4(b[j], wb + j * bpart + (long)nn * ldb + kc);
      }
    }
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      uint32_t a[NP][4];
      const int r = q * tile + pg * 16 + (lane & 15);
      const int kc = k0 + ((lane >> 4) << 3);
#pragma unroll
      for (int i = 0; i < NP; ++i) ldsm_x4(a[i], in + i * apart + (long)r * lda + kc);
      mma_passes<NP>(acc[q], a, b);
    }
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[5][2][4]) {
#pragma unroll
  for (int q = 0; q < 5; ++q)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][t][e] = 0.0f;
}

// Adds v into the block's gradient partial at p, as a reduction that no
// thread waits for. Every caller adds each element of the partial from one
// owning thread, the same on every tile: dw_block's unit u on warp
// u % kTcWarps at a fixed lane, flush_sums' column j and the head
// backwards' idx / kk on thread j (idx, kk) % blockDim.x. Reductions of one
// thread to one address take effect in its program order (the PTX memory
// model's coherence order follows causality order, which holds program
// order), so each element sums its terms in tile order, as the load-add-store
// did, bitwise (red.add.f32 flushes subnormal inputs and results to zero: a
// difference only below 2^-126). The kernels zero their partial with plain
// stores from any thread before the tile loop; the loop's first
// __syncthreads orders every one of them before the block's first
// reduction, and sum_partials, the next launch on the stream, reads the
// partials after every reduction has landed.
__device__ __forceinline__ void red_add(float* p, float v) { atomicAdd(p, v); }

// p[0] += a and, where `two`, p[1] += b: one 8-byte reduction where p is
// 8-byte aligned (a partial of odd length leaves every other block's odd).
__device__ __forceinline__ void red_add2(float* p, float a, float b, bool two) {
  if (two && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(a, b));
    return;
  }
  atomicAdd(p, a);
  if (two) atomicAdd(p + 1, b);
}

// dW[m][j] += sum_r P[r][m] Gz[r][j] over the S T rows of the tile (S
// streams of T points, stream-major), for the real m, j < h, over the
// columns [m0, m0+mc) of P and [j0, j0+jc) of Gz; P and Gz hold those
// columns at row stride ld. dw is the layer's [h, h] block of the block's
// partial, added to by red_add2. One warp per 16 x 16 block of dW.
template <int NP, int S>
__device__ void dw_block(const bf16* P, const bf16* Gz, int ld, float* dw, int tile, int h,
                         int m0, int mc, int j0, int jc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, mi = lane >> 3;
  const int g = lane >> 2, cq = lane & 3;
  const int rows = S * tile, mbs = mc / 16, nbs = jc / 16;
  for (int u = warp; u < mbs * nbs; u += kTcWarps) {
    const int mb = u / nbs, nb = u - mb * nbs;
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int r0 = 0; r0 < rows; r0 += 16) {
      uint32_t a[NP][4], b[NP][4];
      const int ra = r0 + (lane & 7) + ((mi >> 1) << 3), ca = mb * 16 + ((mi & 1) << 3);
      const int rb = r0 + (lane & 7) + ((mi & 1) << 3), cb = nb * 16 + ((mi >> 1) << 3);
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        ldsm_x4_t(a[i], P + ((long)i * rows + ra) * ld + ca);
        ldsm_x4_t(b[i], Gz + ((long)i * rows + rb) * ld + cb);
      }
      mma_passes<NP>(acc, a, b);
    }
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {  // rows g and g + 8, columns 2 cq and 2 cq + 1
        const int m = m0 + mb * 16 + g + 8 * hf, j = j0 + nb * 16 + t * 8 + 2 * cq;
        if (m < h && j < h)
          red_add2(dw + (long)m * h + j, acc[t][2 * hf], acc[t][2 * hf + 1], j + 1 < h);
      }
  }
}

// The resident plan's dW product: P and Gz whole in shared memory.
template <int NP, int S = 5>
__device__ void dw_product(const bf16* P, const bf16* Gz, float* dw, int tile, int h, int hp) {
  dw_block<NP, S>(P, Gz, hp + 8, dw, tile, h, 0, hp, 0, hp);
}

// The streamed plan's dW product: P and Gz in global memory, staged in
// column panels of kp units (P's into sa, Gz's into sb). The caller
// synchronises after it before the buffers are reused.
template <int NP, int S = 5>
__device__ void dw_streamed(const bf16* P, const bf16* Gz, float* dw, bf16* sa, bf16* sb,
                            int tile, int h, int hp, int kp) {
  const int rows = S * tile, ld = hp + 8;
  const long part = (long)rows * ld;
  for (int m0 = 0; m0 < hp; m0 += kp) {
    const int mc = min(kp, hp - m0);
    for (int j0 = 0; j0 < hp; j0 += kp) {
      const int jc = min(kp, hp - j0);
      __syncthreads();  // the previous panels' readers are done
      if (j0 == 0) stage_tile<NP, false>(sa, kp + 8, P, ld, part, 0, rows, m0, mc);
      stage_tile<NP, false>(sb, kp + 8, Gz, ld, part, 0, rows, j0, jc);
      __syncthreads();
      dw_block<NP, S>(sa, sb, kp + 8, dw, tile, h, m0, mc, j0, jc);
    }
  }
}

// Sums over the 8 lane groups g (rows g and g+8 are already added): lanes
// 0..3 end with the column sums of their two columns.
__device__ __forceinline__ float sum_over_rows(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// Stores the NQ stream values of one (point, column pair) as NP bf16x2
// parts, in a carry of S streams (S >= NQ; the rest are padding).
template <int NP, int NQ = 5, int S = NQ>
__device__ __forceinline__ void store_pair(bf16* buf, int tile, int hp, int p, int col,
                                           const float* v0, const float* v1) {
  const int ld = hp + 8, rows = S * tile;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    uint32_t part[NP];
    split_pair<NP>(v0[q], v1[q], part);
#pragma unroll
    for (int i = 0; i < NP; ++i)
      *reinterpret_cast<uint32_t*>(buf + ((long)i * rows + q * tile + p) * ld + col) = part[i];
  }
}

// Stores the NQ stream values of one (point, unit) as NP bf16 parts, in a
// carry of S streams.
template <int NP, int NQ = 5, int S = NQ>
__device__ __forceinline__ void store_one(bf16* buf, int tile, int hp, int p, int m,
                                          const float* v) {
  const int ld = hp + 8, rows = S * tile;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    bf16 part[NP];
    split_one<NP>(v[q], part);
#pragma unroll
    for (int i = 0; i < NP; ++i) buf[((long)i * rows + q * tile + p) * ld + m] = part[i];
  }
}

__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// ------------------------------------------------------------ forward

// Analytic first layer of tile n0 -> carry parts in buf (t0 kept in tape[0]).
template <int NP>
__device__ void tc_first_layer(const float* __restrict__ x, long n0, int n,
                               const float* __restrict__ w0, const float* __restrict__ b0,
                               bf16* buf, float* tape, const TcShapes& sh) {
  const int T = sh.tile, h = sh.h, hp = sh.hp;
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
    float v[5];
    first_carry(t, wx, wy, v);
    store_one<NP>(buf, T, hp, p, j, v);
    if (tape) tape[idx] = t;
  }
}

// The tanh epilogue of one warp's unit (pg, nb) of the panel at c0: the
// carry parts into nxt and, with lt != nullptr, t and the tangents into the
// tape.
template <int NP>
__device__ __forceinline__ void fwd_epilogue(float (&acc)[5][2][4], int pg, int nb, int c0,
                                             const float* __restrict__ bias, bf16* nxt, float* lt,
                                             const TcShapes& sh) {
  const int T = sh.tile, h = sh.h, hp = sh.hp;
  const int lane = threadIdx.x & 31, g = lane >> 2, cq = lane & 3;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int col = c0 + nb * 16 + t * 8 + 2 * cq;
    const float bb0 = col < h ? bias[col] : 0.f, bb1 = col + 1 < h ? bias[col + 1] : 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = pg * 16 + g + 8 * half, e = 2 * half;
      const float t0 = tanhf(acc[0][t][e] + bb0), t1 = tanhf(acc[0][t][e + 1] + bb1);
      float v0[5], v1[5];
      carry_from_t(t0, acc[1][t][e], acc[2][t][e], acc[3][t][e], acc[4][t][e], v0);
      carry_from_t(t1, acc[1][t][e + 1], acc[2][t][e + 1], acc[3][t][e + 1], acc[4][t][e + 1],
                   v1);
      store_pair<NP>(nxt, T, hp, p, col, v0, v1);
      if (lt) {
        st2(lt + (long)p * hp + col, t0, t1);
#pragma unroll
        for (int q = 1; q < 5; ++q)
          st2(lt + ((long)q * T + p) * hp + col, acc[q][t][e], acc[q][t][e + 1]);
      }
    }
  }
}

// The streamed plan's N-panel at c0 (width min(panel, hp - c0)): stages the
// K-panels of `in` into sa and of the weight parts into wb, accumulates the
// warp's unit over them and returns whether the warp owns a unit (then
// (pg, nb) name it). BT as in row_mma: wl is the layer's parts
// [NP][hp][hp], read as W[k][n] (forward) or W[n][k] (backward).
template <int NP, bool BT>
__device__ __forceinline__ bool streamed_unit(const bf16* in, const bf16* __restrict__ wl,
                                              bf16* sa, bf16* wb, int c0, const TcShapes& sh,
                                              int& pg, int& nb, float (&acc)[5][2][4]) {
  const int T = sh.tile, hp = sh.hp, nc = sh.panel, kp = sh.kpanel, rows = 5 * T;
  const int warp = threadIdx.x >> 5;
  const int ncur = min(nc, hp - c0), nbs = ncur / 16;
  const bool has = warp < (T / 16) * nbs;
  pg = warp / nbs;
  nb = warp - pg * nbs;
  zero_acc(acc);
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
      row_mma<NP, BT>(sa, kp + 8, (long)rows * (kp + 8), wb, BT ? nc + 8 : kp + 8,
                      BT ? (long)kc * (nc + 8) : (long)ncur * (kp + 8), kc, T, pg, nb, acc);
  }
  return has;
}

// The resident plan's product on N-panel c0 of layer l (the forward's or,
// with BWD, the reverse sweep's) over the K-slots of the ring: in rounds of one
// unit (pg, nb) a warp, each unit's accumulators over the K-slots in
// ascending k, then epi(acc, pg, nb) for each unit (more than one round
// only where a slot holds the whole panel). in: carry or cotangent parts
// [NP][5T][hp+8]; pre(pg, nb) runs before a unit's product.
template <int NP, bool BWD, class Pre, class Epi>
__device__ __forceinline__ void ring_product(TcRing& rg, const bf16* in, int l, int c0,
                                             const TcShapes& sh, Pre pre, Epi epi) {
  const int T = sh.tile, hp = sh.hp, nc = sh.panel, kx = rg.kx;
  const int units = (T / 16) * (nc / 16), warp = threadIdx.x >> 5;
  const bf16* slot = nullptr;
  for (int u0 = 0; u0 < units; u0 += kTcWarps) {
    const int u = u0 + warp, pg = u / (nc / 16), nb = u - pg * (nc / 16);
    const bool has = u < units;
    float acc[5][2][4];
    if (has) pre(pg, nb);
    zero_acc(acc);
    for (int k0 = 0; k0 < hp; k0 += kx) {
      if (u0 == 0) slot = ring_acquire<NP>(rg, WSlot{l, c0, k0, BWD}, sh);
      if (has)
        row_mma<NP, !BWD>(in + k0, hp + 8, (long)5 * T * (hp + 8), slot,
                          BWD ? kx + 8 : nc + 8, BWD ? (long)nc * (kx + 8) : (long)kx * (nc + 8),
                          kx, T, pg, nb, acc);
    }
    if (has) epi(acc, pg, nb);
  }
}

// Packed forward of tile n0 through the hidden layers, with the product
// layers on the tensor cores. Returns the buffer that holds the last carry.
// With tape != nullptr keeps t and the tangents of every layer. STREAM: the
// streamed plan (a template flag, so that the resident plan's instances
// carry no code of it); sa: its A panel. rg: the resident plan's ring.
template <int NP, bool STREAM>
__device__ bf16* tc_forward(const float* __restrict__ x, const float* __restrict__ flat,
                            const bf16* __restrict__ wsplit, long n0, int n, const TcShapes& sh,
                            bf16* buf_a, bf16* buf_b, bf16* sa, bf16* wb, float* tape,
                            TcRing& rg) {
  const int T = sh.tile, h = sh.h, hp = sh.hp, L = sh.n_hidden, nc = sh.panel;
  tc_first_layer<NP>(x, n0, n, flat, flat + 2 * h, buf_a, tape, sh);
  bf16* cur = buf_a;
  bf16* nxt = buf_b;
  for (int l = 1; l < L; ++l) {
    const float* bias = flat + hidden_off(l, h) + (long)h * h;
    const bf16* wl = wsplit + (long)(l - 1) * NP * hp * hp;
    float* lt = tape ? tape + tc_tape_off(l, T, hp) : nullptr;
    for (int c0 = 0; c0 < hp; c0 += nc) {
      float acc[5][2][4];
      if constexpr (STREAM) {
        int pg, nb;
        if (streamed_unit<NP, true>(cur, wl, sa, wb, c0, sh, pg, nb, acc))
          fwd_epilogue<NP>(acc, pg, nb, c0, bias, nxt, lt, sh);
        continue;
      }
      // each acquire synchronises: the writers of cur are done before it is read
      ring_product<NP, false>(
          rg, cur, l, c0, sh, [](int, int) {},
          [&](float(&a)[5][2][4], int pg, int nb) {
            fwd_epilogue<NP>(a, pg, nb, c0, bias, nxt, lt, sh);
          });
    }
    bf16* tmp = cur;  // the next layer's first K-slot synchronises before reading
    cur = nxt;
    nxt = tmp;
  }
  __syncthreads();
  return cur;
}

// Head on the last carry (CUDA cores, the same passes) -> hb [5][T][K].
// K, the head width, is a constant so that its loops unroll; K = 0 reads
// the width from sh.k.
template <int NP, int K>
__device__ void tc_head(const bf16* cur, const bf16* whs, const float* __restrict__ bh,
                        float* hb, const TcShapes& sh) {
  const int T = sh.tile, hp = sh.hp, ld = hp + 8, rows = 5 * T;
  const int k = K > 0 ? K : sh.k;
  for (int idx = threadIdx.x; idx < rows * k; idx += blockDim.x) {
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

// P_{l-1} parts rebuilt from the tape into buf (bit for bit the forward's).
template <int NP>
__device__ void rebuild_carry(const float* tape, const float* __restrict__ w0, int l,
                              bf16* buf, const TcShapes& sh) {
  const int T = sh.tile, h = sh.h, hp = sh.hp;
  const float* lt = tape + tc_tape_off(l, T, hp);
  const int S = T * hp, nq = l == 0 ? 1 : 5;
  for (int base = threadIdx.x; base < S; base += kBatch * blockDim.x) {
    float z[kBatch][5];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * blockDim.x;
#pragma unroll
      for (int q = 0; q < 5; ++q) z[u][q] = idx < S && q < nq ? lt[q * S + idx] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * blockDim.x;
      if (idx >= S) break;
      const int p = idx / hp, j = idx - p * hp;
      float v[5];
      if (l == 0)
        first_carry(z[u][0], j < h ? w0[j] : 0.f, j < h ? w0[h + j] : 0.f, v);
      else
        carry_from_t(z[u][0], z[u][1], z[u][2], z[u][3], z[u][4], v);
      store_one<NP>(buf, T, hp, p, j, v);
    }
  }
}

// Head backward of one tile. cur: the last carry's parts; ghp: the head
// cotangent parts [NP][5T][k]; hb: the head cotangents (fp32, value rows
// give dbh). Adds dWh / dbh into dp (red_add); writes the pre-activation
// cotangent of the last tanh layer as parts into gz_out, and the column sums
// of its bias gradient (or, for a one-layer net, the first layer's terms)
// into dbs.
// K, the head width, is a constant so that its loops unroll; K = 0 reads
// the width from sh.k (any width, loops not unrolled).
template <int NP, int K>
__device__ void tc_head_backward(const float* __restrict__ x, const float* __restrict__ flat,
                                 long n0, int n, const bf16* cur, const bf16* whs,
                                 const float* ghp, const float* hb, const float* tape,
                                 bf16* gz_out, float* dbs, float* dp, const TcShapes& sh) {
  const int T = sh.tile, h = sh.h, hp = sh.hp, L = sh.n_hidden;
  const int k = K > 0 ? K : sh.k;
  const int ld = hp + 8, rows = 5 * T;
  const long wh = head_off(L, h);
  for (int idx = threadIdx.x; idx < h * k; idx += blockDim.x) {  // dWh = P^T G
    const int m = idx / k, kk = idx - m * k;
    float a = 0.f;
    for (int r = 0; r < rows; ++r) {
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const float pv = __bfloat162float(cur[((long)i * rows + r) * ld + m]);
#pragma unroll
        for (int j = 0; j + i < NP; ++j) a += pv * ghp[((long)j * rows + r) * k + kk];
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
  const float* lt = tape + tc_tape_off(L - 1, T, hp);
  const long S = (long)T * hp;
  for (int idx = threadIdx.x; idx < (T / 8) * hp; idx += blockDim.x) {
    const int grp = idx / hp, m = idx - grp * hp;
    float d[3] = {0.f, 0.f, 0.f};
    float wv[NP][K > 0 ? K : 1];  // this unit's head weight parts (K > 0)
#pragma unroll
    for (int j = 0; j < NP; ++j)
#pragma unroll
      for (int kk = 0; kk < K; ++kk) wv[j][kk] = __bfloat162float(whs[(j * hp + m) * K + kk]);
    float tv[8][5];
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int q = 0; q < 5; ++q)
        tv[u][q] = q == 0 || L > 1 ? lt[q * S + (long)(grp * 8 + u) * hp + m] : 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int p = grp * 8 + u;
      float G[5];
#pragma unroll
      for (int q = 0; q < 5; ++q) {
        float a = 0.f;
#pragma unroll
        for (int kk = 0; kk < k; ++kk)
#pragma unroll
          for (int i = 0; i < NP; ++i) {
            const float gv = ghp[(i * rows + q * T + p) * k + kk];
#pragma unroll
            for (int j = 0; j + i < NP; ++j)
              a += gv * (K > 0 ? wv[j][kk] : __bfloat162float(whs[(j * hp + m) * k + kk]));
          }
        G[q] = a;
      }
      if (L > 1) {
        float z[5];
        gz_from(tv[u][0], tv[u][1], tv[u][2], tv[u][3], tv[u][4], G, z);
        store_one<NP>(gz_out, T, hp, p, m, z);
        d[0] += z[0];
      } else if (m < h) {
        const bool live = n0 + p < n;
        first_terms(tv[u][0], flat[m], flat[h + m], live ? x[2 * (n0 + p)] : 0.f,
                    live ? x[2 * (n0 + p) + 1] : 0.f, G, d);
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) dbs[((long)grp * 3 + a) * hp + m] = d[a];
  }
}

// Adds the column sums dbs[group][3][hp] (in group order) to the gradient
// of layer `layer` (red_add): its bias (layer >= 1, sums of g_z), or dW0 / db0.
__device__ void flush_sums(const float* dbs, int groups, int layer, float* dp, int h, int hp) {
  for (int j = threadIdx.x; j < h; j += blockDim.x) {
    float d[3] = {0.f, 0.f, 0.f};
    for (int grp = 0; grp < groups; ++grp)
      for (int a = 0; a < (layer > 0 ? 1 : 3); ++a) d[a] += dbs[((long)grp * 3 + a) * hp + j];
    if (layer > 0) {
      red_add(dp + hidden_off(layer, h) + (long)h * h + j, d[0]);
    } else {
      red_add(dp + j, d[0]);
      red_add(dp + h + j, d[1]);
      red_add(dp + 2 * h + j, d[2]);
    }
  }
}

// The tape entries of one warp's unit (pg, nb) of the panel at c0 at layer
// l - 1 (lt): t and, above the first layer, the four tangents.
__device__ __forceinline__ void load_tape(float2 (&tp)[2][2][5], const float* lt, int l, int pg,
                                          int nb, int c0, const TcShapes& sh) {
  const int hp = sh.hp, lane = threadIdx.x & 31, g = lane >> 2, cq = lane & 3;
  const long S = (long)sh.tile * hp;
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int q = 0; q < 5; ++q)
        tp[t][half][q] = q == 0 || l > 1
            ? ld2(lt + q * S + (long)(pg * 16 + g + 8 * half) * hp + c0 + nb * 16 + t * 8 + 2 * cq)
            : make_float2(0.f, 0.f);
}

// The g_z epilogue of one warp's unit (pg, nb) of the panel at c0 at layer
// l: Gz_{l-1} parts into other and its column sums into dbs (or, at l = 1,
// the first layer's terms).
template <int NP>
__device__ __forceinline__ void rev_epilogue(float (&acc)[5][2][4], float2 (&tp)[2][2][5], int l,
                                             int pg, int nb, int c0,
                                             const float* __restrict__ x,
                                             const float* __restrict__ flat, long n0, int n,
                                             bf16* other, float* dbs, const TcShapes& sh) {
  const int T = sh.tile, h = sh.h, hp = sh.hp;
  const int lane = threadIdx.x & 31, g = lane >> 2, cq = lane & 3;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int col = c0 + nb * 16 + t * 8 + 2 * cq;
    float s[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = pg * 16 + g + 8 * half, e = 2 * half;
      float G0[5], G1[5];
#pragma unroll
      for (int q = 0; q < 5; ++q) {
        G0[q] = acc[q][t][e];
        G1[q] = acc[q][t][e + 1];
      }
      const float2 tt = tp[t][half][0];
      if (l > 1) {
        const float2 zx = tp[t][half][1], zy = tp[t][half][2];
        const float2 zxx = tp[t][half][3], zyy = tp[t][half][4];
        float z0[5], z1[5];
        gz_from(tt.x, zx.x, zy.x, zxx.x, zyy.x, G0, z0);
        gz_from(tt.y, zx.y, zy.y, zxx.y, zyy.y, G1, z1);
        store_pair<NP>(other, T, hp, p, col, z0, z1);
        s[0][0] += z0[0];
        s[1][0] += z1[0];
      } else {
        const bool live = n0 + p < n;
        const float px = live ? x[2 * (n0 + p)] : 0.f;
        const float py = live ? x[2 * (n0 + p) + 1] : 0.f;
        if (col < h) first_terms(tt.x, flat[col], flat[h + col], px, py, G0, s[0]);
        if (col + 1 < h) first_terms(tt.y, flat[col + 1], flat[h + col + 1], px, py, G1, s[1]);
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      if (l > 1 && a > 0) break;
      const float v0 = sum_over_rows(s[0][a]), v1 = sum_over_rows(s[1][a]);
      if (g == 0) st2(dbs + ((long)pg * 3 + a) * hp + col, v0, v1);
    }
  }
}

// The product layers in reverse, from gz (the last tanh layer's
// pre-activation cotangent parts) down to the first layer's terms. other:
// the second carry buffer; dbs: column sums; STREAM, sa and rg as for
// tc_forward. Both carry buffers are overwritten. The caller synchronises
// before the call.
template <int NP, bool STREAM>
__device__ void tc_reverse(const float* __restrict__ x, const float* __restrict__ flat,
                           const bf16* __restrict__ wsplit, long n0, int n, bf16* gz,
                           bf16* other, bf16* sa, bf16* wb, float* dbs, const float* tape,
                           float* dp, const TcShapes& sh, TcRing& rg) {
  const int T = sh.tile, h = sh.h, hp = sh.hp, L = sh.n_hidden, nc = sh.panel;
  const int pgs = T / 16;
  for (int l = L - 1; l >= 1; --l) {
    const bf16* wl = wsplit + (long)(l - 1) * NP * hp * hp;
    rebuild_carry<NP>(tape, flat, l - 1, other, sh);
    __syncthreads();
    if constexpr (STREAM)
      dw_streamed<NP>(other, gz, dp + hidden_off(l, h), sa, wb, T, h, hp, sh.kpanel);
    else
      dw_product<NP>(other, gz, dp + hidden_off(l, h), T, h, hp);
    const float* lt = tape + tc_tape_off(l - 1, T, hp);
    for (int c0 = 0; c0 < hp; c0 += nc) {
      float acc[5][2][4];
      float2 tp[2][2][5];
      if constexpr (STREAM) {
        int pg, nb;
        if (streamed_unit<NP, false>(gz, wl, sa, wb, c0, sh, pg, nb, acc)) {
          load_tape(tp, lt, l, pg, nb, c0, sh);
          rev_epilogue<NP>(acc, tp, l, pg, nb, c0, x, flat, n0, n, other, dbs, sh);
        }
        continue;
      }
      // the first acquire synchronises: the dW product is done with other
      ring_product<NP, true>(
          rg, gz, l, c0, sh,
          [&](int pg, int nb) { load_tape(tp, lt, l, pg, nb, c0, sh); },  // in flight meanwhile
          [&](float(&a)[5][2][4], int pg, int nb) {
            rev_epilogue<NP>(a, tp, l, pg, nb, c0, x, flat, n0, n, other, dbs, sh);
          });
    }
    __syncthreads();
    flush_sums(dbs, pgs, l - 1, dp, h, hp);
    bf16* tmp = gz;  // Gz_{l-1} now lives in other
    gz = other;
    other = tmp;
  }
}

}  // namespace
