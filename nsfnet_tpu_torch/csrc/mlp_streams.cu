// Five-stream derivative engine for Hopper (sm_90a), the hidden-layer
// products of both kernels on the tensor cores.
//
// Replaces the TPU kernels of nsfnet_tpu/ops/pallas_mlp.py:
//   streams_fwd_kernel<NP, K> <- _fwd_kernel (:183, launched by _fwd_pallas, pallas_call at :218)
//   streams_bwd_kernel<NP, K> <- _bwd_kernel (:313, launched by _bwd_pallas, pallas_call at :352)
//
// What they compute, for a tanh MLP 2 -> H (x n_hidden) -> K and points
// x[N,2], at a precision name (NP bf16 parts per operand, the passes
// i + j < NP: "default" 1, "high" 3 = JAX's bf16x3, "highest" 6):
//   forward : the packed value + 4 Taylor streams through every layer, then
//             the five [N,K] head streams (value, d/dx, d/dy, d2/dx2, d2/dy2)
//             of every output, written row-major to global memory, the value
//             stream with the head bias.
//   backward: recompute the forward keeping the tape, read the five [N,K]
//             cotangent streams, run the packed reverse sweep -> dW / db of
//             every layer in the flat parameter layout of models/mlp.py. x
//             gets no cotangent: collocation points are constants.
//
// What bounds them on this card: operations. Per point the forward does
// 5 streams x 2*H*H FLOP per product layer (0.43 MFLOP at 4x120, 0.32 at
// 6x80) and the backward three times that, each times the pass count,
// against 8 B read and 20*K B written (forward) or read (backward) per
// point: both sit far above the ridge point.
//
// Both run tc_mlp.cuh's sweep, which says how each part works, as the fused
// residual-loss pair does (fused_residual.cu): the hidden weights split once
// per launch (split_weights), 132 persistent blocks of 32-point tiles (16
// where 32 do not fit; the tile and the weight panel from tc_smem, the rule
// of the pair; where no block with both carries fits, the streamed plan), a
// ragged last tile read as zero points and never written.
// The forward is loss_fwd_kernel with the tile's [5][T][K] head block
// written out in place of the residual algebra: tc_forward without the tape,
// then tc_head. The backward is loss_bwd_kernel without the residual
// algebra, as the TPU kernel is _recompute_forward + _packed_reverse_sweep:
// tc_forward with the tape, the tile's five cotangent rows loaded as the
// head's cotangents and split into bf16 parts, tc_head_backward and
// tc_reverse, one partial per block, added in block order. The backward does
// not run the head product: the head's output is not an input of its own
// gradient, only the last carry and the cotangents are.

#include "tc_mlp.cuh"

namespace {

struct Streams {
  float* s[5];  // value, d/dx, d/dy, d2/dx2, d2/dy2: each [N, K] row-major
};

struct ConstStreams {
  const float* s[5];
};

// K, the head width, is a constant so that the head's loops unroll (3, the
// velocity head); K = 0 takes any width from sh.k. STREAM: the streamed plan
// (tc_mlp.cuh), a template flag as in fused_residual.cu.
template <int NP, int K, bool STREAM>
__global__ void __launch_bounds__(kTcThreads, 1)
streams_fwd_kernel(const float* __restrict__ x, const float* __restrict__ flat,
                   const bf16* __restrict__ wsplit, int n, TcShapes sh, Streams out,
                   float* carries) {
  extern __shared__ __align__(16) unsigned char tc_buf[];
  const TcRegions R = tc_regions<STREAM>(tc_buf, carries, sh, NP);
  const int T = sh.tile, h = sh.h;
  const int k = K > 0 ? K : sh.k, TK = T * k;
  const long wh = head_off(sh.n_hidden, h), nk = (long)n * k;
  const int n_tiles = (n + T - 1) / T;
  TcRing rg = ring_begin<NP, STREAM>(R.wb, wsplit, sh, false, n_tiles);
  stage_head<NP>(R.whs, flat + wh, h, sh.hp, k);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long n0 = (long)tile * T;
    rg.last_tile = tile + (int)gridDim.x >= n_tiles;
    __syncthreads();  // the previous tile's readers of the buffers and hb are done
    const bf16* cur = tc_forward<NP, STREAM>(x, flat, wsplit, n0, n, sh, R.buf_a, R.buf_b, R.sa,
                                             R.wb, nullptr, rg);
    tc_head<NP, K>(cur, R.whs, flat + wh + (long)h * k, R.hb, sh);
    __syncthreads();
    // a tile's rows are contiguous in each [N, K] stream; rows >= n are not written
    for (int idx = threadIdx.x; idx < 5 * TK; idx += blockDim.x) {
      const int q = idx / TK, r = idx - q * TK;
      if (n0 * k + r < nk) out.s[q][n0 * k + r] = R.hb[idx];
    }
  }
}

// K, the head width, is a constant so that the head's loops unroll (3, the
// velocity head); K = 0 takes any width from sh.k. STREAM as for the forward.
template <int NP, int K, bool STREAM>
__global__ void __launch_bounds__(kTcThreads, 1)
streams_bwd_kernel(const float* __restrict__ x, const float* __restrict__ flat,
                   const bf16* __restrict__ wsplit, int n, TcShapes sh, ConstStreams ct,
                   float* scratch, float* dpart, float* carries) {
  extern __shared__ __align__(16) unsigned char tc_buf[];
  const TcRegions R = tc_regions<STREAM>(tc_buf, carries, sh, NP);
  const int T = sh.tile, h = sh.h, L = sh.n_hidden, rows = 5 * T;
  const int k = K > 0 ? K : sh.k, TK = T * k;
  const long P = n_params(L, h, k);
  float* dp = dpart + blockIdx.x * P;
  float* tape = scratch + blockIdx.x * tc_scratch_floats(T, sh.hp, L);

  const int n_tiles = (n + T - 1) / T;
  TcRing rg = ring_begin<NP, STREAM>(R.wb, wsplit, sh, true, n_tiles);
  for (long i = threadIdx.x; i < P; i += blockDim.x) dp[i] = 0.f;
  stage_head<NP>(R.whs, flat + head_off(L, h), h, sh.hp, k);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long n0 = (long)tile * T;
    rg.last_tile = tile + (int)gridDim.x >= n_tiles;
    __syncthreads();  // the previous tile's sweep is done with the buffers, hb and ghp
    // the tile's rows of the five cotangent streams (rows >= n are zero)
    for (int idx = threadIdx.x; idx < rows * k; idx += blockDim.x) {
      const int q = idx / TK, r = idx - q * TK;
      R.hb[idx] = n0 * k + r < (long)n * k ? ct.s[q][n0 * k + r] : 0.f;
    }
    bf16* cur = tc_forward<NP, STREAM>(x, flat, wsplit, n0, n, sh, R.buf_a, R.buf_b, R.sa, R.wb,
                                       tape, rg);
    bf16* other = cur == R.buf_a ? R.buf_b : R.buf_a;
    for (int idx = threadIdx.x; idx < rows * k; idx += blockDim.x) {  // head cotangent parts
      bf16 part[NP];
      split_one<NP>(R.hb[idx], part);
#pragma unroll
      for (int i = 0; i < NP; ++i) R.ghp[(long)i * rows * k + idx] = __bfloat162float(part[i]);
    }
    __syncthreads();
    tc_head_backward<NP, K>(x, flat, n0, n, cur, R.whs, R.ghp, R.hb, tape, other, R.dbs, dp, sh);
    __syncthreads();
    flush_sums(R.dbs, T / 8, L - 1, dp, h, sh.hp);
    tc_reverse<NP, STREAM>(x, flat, wsplit, n0, n, other, cur, R.sa, R.wb, R.dbs, tape, dp, sh,
                           rg);
  }
}

template <int NP, int K>
int launch_fwd(const float* x, const float* flat, bf16* wsplit, int n, TcShapes sh, int n_blocks,
               Streams out, float* carries, size_t smem, cudaStream_t s) {
  const auto kernel =
      sh.kpanel ? streams_fwd_kernel<NP, K, true> : streams_fwd_kernel<NP, K, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int bad = launch_split<NP>(flat, sh, wsplit, s);
  if (bad) return bad;
  kernel<<<n_blocks, kTcThreads, smem, s>>>(x, flat, wsplit, n, sh, out, carries);
  return (int)cudaGetLastError();
}

template <int NP>
int launch_fwd_k(const float* x, const float* flat, bf16* wsplit, int n, TcShapes sh,
                 int n_blocks, Streams out, float* carries, size_t smem, cudaStream_t s) {
  return sh.k == 3 ? launch_fwd<NP, 3>(x, flat, wsplit, n, sh, n_blocks, out, carries, smem, s)
                   : launch_fwd<NP, 0>(x, flat, wsplit, n, sh, n_blocks, out, carries, smem, s);
}

template <int NP, int K>
int launch_bwd(const float* x, const float* flat, bf16* wsplit, int n, TcShapes sh,
               int n_blocks, ConstStreams ct, float* scratch, float* dpart, float* carries,
               size_t smem, cudaStream_t s) {
  const auto kernel =
      sh.kpanel ? streams_bwd_kernel<NP, K, true> : streams_bwd_kernel<NP, K, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int bad = launch_split<NP>(flat, sh, wsplit, s);
  if (bad) return bad;
  kernel<<<n_blocks, kTcThreads, smem, s>>>(x, flat, wsplit, n, sh, ct, scratch, dpart, carries);
  return (int)cudaGetLastError();
}

template <int NP>
int launch_bwd_k(const float* x, const float* flat, bf16* wsplit, int n, TcShapes sh,
                 int n_blocks, ConstStreams ct, float* scratch, float* dpart, float* carries,
                 size_t smem, cudaStream_t s) {
  return sh.k == 3 ? launch_bwd<NP, 3>(x, flat, wsplit, n, sh, n_blocks, ct, scratch, dpart,
                                       carries, smem, s)
                   : launch_bwd<NP, 0>(x, flat, wsplit, n, sh, n_blocks, ct, scratch, dpart,
                                       carries, smem, s);
}

// What both kernels take: a tile of 16 or 32 (a ragged last tile is
// allowed), a plan the sweep takes (tc_plan_ok), 1-3 parts, a block that
// fits, the streamed plan's global regions.
int check_args(int n, int h, int k, int tile, int panel, int kpanel, int n_hidden, int n_blocks,
               int parts, size_t smem, const float* carries) {
  if (n <= 0 || h <= 0 || k <= 0 || n_hidden < 1 || n_blocks <= 0 ||
      (tile != 16 && tile != 32) || !tc_plan_ok(pad16(h), tile, panel, kpanel) || parts < 1 ||
      parts > 3 || smem > (size_t)kMaxSmem || (kpanel && !carries))
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" {

// Shared memory one block of either kernel uses, in bytes (tc_smem; kpanel
// 0: the resident plan).
int nsf_mlp_streams_smem_bytes(int tile, int panel, int h, int k, int parts, int kpanel) {
  return (int)tc_smem(tile, panel, pad16(h), k, parts, kpanel).total();
}

// Floats of backward tape one block uses; the wrapper allocates n_blocks of them.
long nsf_mlp_streams_tape_floats(int tile, int h, int n_hidden) {
  return tc_scratch_floats(tile, pad16(h), n_hidden);
}

// Floats of the streamed plan's global regions one block uses (either
// kernel; the wrapper allocates n_blocks of them on that plan only).
long nsf_mlp_streams_carry_floats(int tile, int h, int k, int parts) {
  return tc_carry_floats(tile, pad16(h), k, parts);
}

// Bytes of either kernel's split copy of the hidden weights.
long nsf_mlp_streams_weight_bytes(int n_hidden, int h, int parts) {
  return tc_wsplit_elems(n_hidden, pad16(h), parts) * (long)sizeof(bf16);
}

// Forward: o, ox, oy, oxx, oyy <- the five [n, k] streams, at `parts` bf16
// parts per operand (1-3). The plan: tile 16 or 32, panel, kpanel (0: the
// resident plan, a panel dividing the padded width); wsplit:
// nsf_mlp_streams_weight_bytes of scratch; carries: [n_blocks,
// nsf_mlp_streams_carry_floats] on the streamed plan, else null. Returns a
// cudaError_t code (0 = launched).
int nsf_mlp_streams_fwd(const float* x, const float* flat, int n, int n_hidden, int h, int k,
                        int tile, int panel, int n_blocks, int parts, void* wsplit, float* o,
                        float* ox, float* oy, float* oxx, float* oyy, void* stream, int kpanel,
                        float* carries) {
  const int hp = pad16(h);
  const size_t smem = tc_smem(tile, panel, hp, k, parts, kpanel).total();
  int bad = check_args(n, h, k, tile, panel, kpanel, n_hidden, n_blocks, parts, smem, carries);
  if (bad) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  TcShapes sh{n_hidden, h, hp, k, tile, panel, kpanel};
  Streams out{{o, ox, oy, oxx, oyy}};
  bf16* ws = static_cast<bf16*>(wsplit);
  return parts == 1   ? launch_fwd_k<1>(x, flat, ws, n, sh, n_blocks, out, carries, smem, s)
         : parts == 2 ? launch_fwd_k<2>(x, flat, ws, n, sh, n_blocks, out, carries, smem, s)
                      : launch_fwd_k<3>(x, flat, ws, n, sh, n_blocks, out, carries, smem, s);
}

// Backward: dflat = sum over the five streams of <cotangent, d stream / d params>,
// in the flat layout, at `parts` bf16 parts per operand (1-3). g*: the
// [n, k] cotangents of o, ox, oy, oxx, oyy. The plan, wsplit and carries as
// for the forward; scratch: [n_blocks, nsf_mlp_streams_tape_floats]; dpart:
// [n_blocks, n_params]. Returns a cudaError_t code (0 = launched).
int nsf_mlp_streams_bwd(const float* x, const float* flat, int n, int n_hidden, int h, int k,
                        int tile, int panel, int n_blocks, int parts, void* wsplit,
                        const float* g, const float* gx, const float* gy, const float* gxx,
                        const float* gyy, float* scratch, float* dpart, float* dflat,
                        void* stream, int kpanel, float* carries) {
  const int hp = pad16(h);
  const size_t smem = tc_smem(tile, panel, hp, k, parts, kpanel).total();
  int bad = check_args(n, h, k, tile, panel, kpanel, n_hidden, n_blocks, parts, smem, carries);
  if (bad) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  TcShapes sh{n_hidden, h, hp, k, tile, panel, kpanel};
  ConstStreams ct{{g, gx, gy, gxx, gyy}};
  bf16* ws = static_cast<bf16*>(wsplit);
  int err = parts == 1
                ? launch_bwd_k<1>(x, flat, ws, n, sh, n_blocks, ct, scratch, dpart, carries, smem, s)
            : parts == 2
                ? launch_bwd_k<2>(x, flat, ws, n, sh, n_blocks, ct, scratch, dpart, carries, smem, s)
                : launch_bwd_k<3>(x, flat, ws, n, sh, n_blocks, ct, scratch, dpart, carries, smem, s);
  if (err) return err;
  return (int)sum_gradient_partials(dpart, n_blocks, n_params(n_hidden, h, k), dflat, s);
}

}  // extern "C"
