// Order-3 streamfunction derivative engine for Hopper (sm_90a), the
// hidden-layer products of both kernels on the tensor cores.
//
// Replaces the TPU kernels of nsfnet_tpu/ops/pallas_psi.py:
//   psi_fwd_kernel<NP, T, K> <- _fwd_kernel (:176, launched by _fwd_pallas, pallas_call at :204)
//   psi_bwd_kernel<NP, T, K> <- _bwd_kernel (:223, launched by _bwd_pallas, pallas_call at :330)
//
// What they compute, for a tanh MLP 2 -> H (x n_hidden) -> K and points
// x[N,2], at a precision name (NP bf16 parts per operand, the passes
// i + j < NP: "default" 1, "high" 3 = JAX's bf16x3, "highest" 6):
//   forward : the packed value + 12 Taylor streams (orders 1-3 along e_x,
//             e_y, (1,1), (1,-1)) through every layer, then the thirteen
//             [N,K] head streams, written row-major to global memory, the
//             value stream with the head bias.
//   backward: recompute the forward keeping the tape, read the thirteen
//             [N,K] cotangent streams, run the packed order-3 reverse sweep
//             -> dW / db of every layer in the flat parameter layout of
//             models/mlp.py. x gets no cotangent: collocation points are
//             constants.
// The (u, v, p) bundle is assembled from the raw streams outside, in plain
// PyTorch (ops/derivatives.assemble_psi_bundle), as the JAX package does.
//
// What bounds them on this card: operations. Per point the forward does
// 13 streams x 2*H*H FLOP per product layer (0.83 MFLOP at 6x80) and the
// backward three times that, each times the pass count, against 8 B read
// and 52*K B written (forward) or read (backward) per point: both sit far
// above the ridge point.
//
// Both run tc_psi.cuh's sweep, which says how each part works: the hidden
// weights split once per launch (split_weights), 132 persistent blocks of
// 16- or 8-point tiles with the weight panel from psi_smem (one rule for
// both, chosen by the wrapper; where no block with both carries fits, the
// streamed plan of 16-point tiles), a ragged last tile read as zero points. The
// forward is the backward's recompute without the tape (psi_tc_forward
// with TAPE = false) and psi_head, the 13-stream head on the CUDA cores at
// the same passes, with the tile's [13][T][K] head block written out; rows
// >= n are not written. The backward recomputes with the tape of t and the
// 12 tangents, splits the tile's thirteen cotangent rows into the head's
// cotangent parts, runs the head backward on the CUDA cores and the reverse
// sweep with the three products per layer on the tensor cores, one partial
// per block, added in block order; each element of a block's partial is
// added to by one owning thread, in program order (tc_mlp.cuh red_add), so
// the outputs are bitwise the same on every run. The backward does not
// run the head product: the head's output is not an input of its own
// gradient, only the last carry and the cotangents are.

#include "tc_psi.cuh"

namespace {

struct PsiOut {
  float* s[kPsi];  // o, a_x a_y a_p a_m, b_*, c_*: each [N, K] row-major
};

struct PsiCt {
  const float* s[kPsi];
};

// K, the head width, is a constant so that the head's loops unroll (2, the
// (psi, p) head); K = 0 takes any width from sh.k. STREAM: the streamed
// plan, a template flag so that the resident plan's instances carry no code
// of it (instantiated at T = 16 only: psi_plan_ok).
template <int NP, int T, int K, bool STREAM>
__global__ void __launch_bounds__(kTcThreads, 1)
psi_fwd_kernel(const float* __restrict__ x, const float* __restrict__ flat,
               const bf16* __restrict__ wsplit, int n, TcShapes sh, PsiOut out,
               float* carries) {
  extern __shared__ __align__(16) unsigned char tc_buf[];
  const PsiRegions R = psi_regions<STREAM>(tc_buf, carries, sh, NP);
  const int h = sh.h, hp = sh.hp;
  const int k = K > 0 ? K : sh.k, TK = T * k;
  const long wh = head_off(sh.n_hidden, h), nk = (long)n * k;
  stage_head<NP>(R.whs, flat + wh, h, hp, k);
  zero_pad_stream<NP, T>(R.buf_a, hp);
  zero_pad_stream<NP, T>(R.buf_b, hp);

  const int n_tiles = (n + T - 1) / T;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long n0 = (long)tile * T;
    __syncthreads();  // the previous tile's readers of the buffers and hb are done
    const bf16* cur = psi_tc_forward<NP, T, STREAM, false>(x, flat, wsplit, n0, n, sh, R.buf_a,
                                                           R.buf_b, R.sa, R.wb, nullptr);
    psi_head<NP, T, K>(cur, R.whs, flat + wh + (long)h * k, R.hb, sh);
    __syncthreads();
    // a tile's rows are contiguous in each [N, K] stream; rows >= n are not written
    for (int idx = threadIdx.x; idx < kPsi * TK; idx += blockDim.x) {
      const int q = idx / TK, r = idx - q * TK;
      if (n0 * k + r < nk) out.s[q][n0 * k + r] = R.hb[idx];
    }
  }
}

// K, the head width, is a constant so that the head's loops unroll (2, the
// (psi, p) head); K = 0 takes any width from sh.k. STREAM as for the forward.
template <int NP, int T, int K, bool STREAM>
__global__ void __launch_bounds__(kTcThreads, 1)
psi_bwd_kernel(const float* __restrict__ x, const float* __restrict__ flat,
               const bf16* __restrict__ wsplit, int n, TcShapes sh, PsiCt ct, float* scratch,
               float* dpart, float* carries) {
  extern __shared__ __align__(16) unsigned char tc_buf[];
  const PsiRegions R = psi_regions<STREAM>(tc_buf, carries, sh, NP);
  const int h = sh.h, hp = sh.hp, L = sh.n_hidden;
  const int k = K > 0 ? K : sh.k, TK = T * k;
  const long P = n_params(L, h, k);
  float* dp = dpart + blockIdx.x * P;
  float* tape = scratch + blockIdx.x * psi_tape_floats(T, hp, L);

  for (long i = threadIdx.x; i < P; i += blockDim.x) dp[i] = 0.f;
  stage_head<NP>(R.whs, flat + head_off(L, h), h, hp, k);
  zero_pad_stream<NP, T>(R.buf_a, hp);
  zero_pad_stream<NP, T>(R.buf_b, hp);

  const int n_tiles = (n + T - 1) / T;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long n0 = (long)tile * T;
    __syncthreads();  // the previous tile's sweep is done with the buffers, hb and ghp
    // the tile's rows of the thirteen cotangent streams (rows >= n are zero)
    for (int idx = threadIdx.x; idx < kPsi * TK; idx += blockDim.x) {
      const int q = idx / TK, r = idx - q * TK;
      R.hb[idx] = n0 * k + r < (long)n * k ? ct.s[q][n0 * k + r] : 0.f;
    }
    bf16* cur =
        psi_tc_forward<NP, T, STREAM>(x, flat, wsplit, n0, n, sh, R.buf_a, R.buf_b, R.sa, R.wb,
                                      tape);
    bf16* other = cur == R.buf_a ? R.buf_b : R.buf_a;
    for (int idx = threadIdx.x; idx < kPsi * TK; idx += blockDim.x) {  // head cotangent parts
      bf16 part[NP];
      split_one<NP>(R.hb[idx], part);
#pragma unroll
      for (int i = 0; i < NP; ++i) R.ghp[(long)i * kPsi * TK + idx] = __bfloat162float(part[i]);
    }
    __syncthreads();
    psi_head_backward<NP, T, K>(x, flat, n0, n, cur, R.whs, R.ghp, R.hb, tape, other, R.dbs, dp,
                                sh);
    __syncthreads();
    flush_sums(R.dbs, T / 8, L - 1, dp, h, hp);
    psi_reverse<NP, T, STREAM>(x, flat, wsplit, n0, n, other, cur, R.sa, R.wb, R.dbs, tape, dp,
                               sh);
  }
}

template <int NP, int T, int K, bool STREAM>
int launch_fwd(const float* x, const float* flat, bf16* wsplit, int n, TcShapes sh, int n_blocks,
               const PsiOut& out, float* carries, size_t smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(psi_fwd_kernel<NP, T, K, STREAM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int bad = launch_split<NP>(flat, sh, wsplit, s);
  if (bad) return bad;
  psi_fwd_kernel<NP, T, K, STREAM><<<n_blocks, kTcThreads, smem, s>>>(x, flat, wsplit, n, sh, out,
                                                                      carries);
  return (int)cudaGetLastError();
}

template <int NP>
int launch_fwd_np(const float* x, const float* flat, bf16* wsplit, int n, TcShapes sh,
                  int n_blocks, const PsiOut& out, float* carries, size_t smem, cudaStream_t s) {
  auto go = [&](auto fn) { return fn(x, flat, wsplit, n, sh, n_blocks, out, carries, smem, s); };
  if (sh.kpanel)
    return sh.k == 2 ? go(launch_fwd<NP, 16, 2, true>) : go(launch_fwd<NP, 16, 0, true>);
  if (sh.tile == 16)
    return sh.k == 2 ? go(launch_fwd<NP, 16, 2, false>) : go(launch_fwd<NP, 16, 0, false>);
  return sh.k == 2 ? go(launch_fwd<NP, 8, 2, false>) : go(launch_fwd<NP, 8, 0, false>);
}

template <int NP, int T, int K, bool STREAM>
int launch_bwd(const float* x, const float* flat, bf16* wsplit, int n, TcShapes sh, int n_blocks,
               const PsiCt& ct, float* scratch, float* dpart, float* carries, size_t smem,
               cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(psi_bwd_kernel<NP, T, K, STREAM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int bad = launch_split<NP>(flat, sh, wsplit, s);
  if (bad) return bad;
  psi_bwd_kernel<NP, T, K, STREAM><<<n_blocks, kTcThreads, smem, s>>>(x, flat, wsplit, n, sh, ct,
                                                                      scratch, dpart, carries);
  return (int)cudaGetLastError();
}

template <int NP>
int launch_bwd_np(const float* x, const float* flat, bf16* wsplit, int n, TcShapes sh,
                  int n_blocks, const PsiCt& ct, float* scratch, float* dpart, float* carries,
                  size_t smem, cudaStream_t s) {
  auto go = [&](auto fn) {
    return fn(x, flat, wsplit, n, sh, n_blocks, ct, scratch, dpart, carries, smem, s);
  };
  if (sh.kpanel)
    return sh.k == 2 ? go(launch_bwd<NP, 16, 2, true>) : go(launch_bwd<NP, 16, 0, true>);
  if (sh.tile == 16)
    return sh.k == 2 ? go(launch_bwd<NP, 16, 2, false>) : go(launch_bwd<NP, 16, 0, false>);
  return sh.k == 2 ? go(launch_bwd<NP, 8, 2, false>) : go(launch_bwd<NP, 8, 0, false>);
}

// What both kernels take: a tile of 16 or 8 (a ragged last tile is
// allowed; the streamed plan 16), a plan the sweep takes (psi_plan_ok), 1-3
// parts, a block that fits, the streamed plan's global regions.
int check_args(int n, int h, int k, int tile, int panel, int kpanel, int n_hidden, int n_blocks,
               int parts, size_t smem, const float* carries) {
  if (n <= 0 || h <= 0 || k <= 0 || n_hidden < 1 || n_blocks <= 0 ||
      (tile != 16 && tile != 8) || !psi_plan_ok(pad16(h), tile, panel, kpanel) || parts < 1 ||
      parts > 3 || smem > (size_t)kMaxSmem || (kpanel && !carries))
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" {

// Shared memory one block of either kernel uses, in bytes (psi_smem; kpanel
// 0: the resident plan).
int nsf_psi_streams_smem_bytes(int tile, int panel, int h, int k, int parts, int kpanel) {
  return (int)psi_smem(tile, panel, pad16(h), k, parts, kpanel).total();
}

// Floats of backward tape one block uses; the wrapper allocates n_blocks of them.
long nsf_psi_streams_tape_floats(int tile, int h, int n_hidden) {
  return psi_tape_floats(tile, pad16(h), n_hidden);
}

// Floats of the streamed plan's global regions one block uses (either
// kernel; the wrapper allocates n_blocks of them on that plan only).
long nsf_psi_streams_carry_floats(int tile, int h, int k, int parts) {
  return psi_carry_floats(tile, pad16(h), k, parts);
}

// Bytes of either kernel's split copy of the hidden weights.
long nsf_psi_streams_weight_bytes(int n_hidden, int h, int parts) {
  return tc_wsplit_elems(n_hidden, pad16(h), parts) * (long)sizeof(bf16);
}

// Forward: outs[0..12] <- the thirteen [n, k] streams (outs is a host array
// of device pointers), at `parts` bf16 parts per operand (1-3). The plan:
// tile 16 or 8, panel, kpanel (0: the resident plan, a panel dividing the
// padded width); wsplit: nsf_psi_streams_weight_bytes of scratch; carries:
// [n_blocks, nsf_psi_streams_carry_floats] on the streamed plan, else null.
// Returns a cudaError_t code (0 = launched).
int nsf_psi_streams_fwd(const float* x, const float* flat, int n, int n_hidden, int h, int k,
                        int tile, int panel, int n_blocks, int parts, void* wsplit,
                        float* const* outs, void* stream, int kpanel, float* carries) {
  const int hp = pad16(h);
  const size_t smem = psi_smem(tile, panel, hp, k, parts, kpanel).total();
  int bad = check_args(n, h, k, tile, panel, kpanel, n_hidden, n_blocks, parts, smem, carries);
  if (bad) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  TcShapes sh{n_hidden, h, hp, k, tile, panel, kpanel};
  PsiOut out;
  for (int q = 0; q < kPsi; ++q) out.s[q] = outs[q];
  bf16* ws = static_cast<bf16*>(wsplit);
  return parts == 1   ? launch_fwd_np<1>(x, flat, ws, n, sh, n_blocks, out, carries, smem, s)
         : parts == 2 ? launch_fwd_np<2>(x, flat, ws, n, sh, n_blocks, out, carries, smem, s)
                      : launch_fwd_np<3>(x, flat, ws, n, sh, n_blocks, out, carries, smem, s);
}

// Backward: dflat = sum over the thirteen streams of <cotangent, d stream / d params>,
// in the flat layout, at `parts` bf16 parts per operand (1-3). cts[0..12]:
// the [n, k] cotangents (a host array of device pointers). The plan, wsplit
// and carries as for the forward; scratch: [n_blocks,
// nsf_psi_streams_tape_floats]; dpart: [n_blocks, n_params].
// Returns a cudaError_t code (0 = launched).
int nsf_psi_streams_bwd(const float* x, const float* flat, int n, int n_hidden, int h, int k,
                        int tile, int panel, int n_blocks, int parts, void* wsplit,
                        const float* const* cts, float* scratch, float* dpart, float* dflat,
                        void* stream, int kpanel, float* carries) {
  const int hp = pad16(h);
  const size_t smem = psi_smem(tile, panel, hp, k, parts, kpanel).total();
  int bad = check_args(n, h, k, tile, panel, kpanel, n_hidden, n_blocks, parts, smem, carries);
  if (bad) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  TcShapes sh{n_hidden, h, hp, k, tile, panel, kpanel};
  PsiCt ct;
  for (int q = 0; q < kPsi; ++q) ct.s[q] = cts[q];
  bf16* ws = static_cast<bf16*>(wsplit);
  int err = parts == 1   ? launch_bwd_np<1>(x, flat, ws, n, sh, n_blocks, ct, scratch, dpart,
                                            carries, smem, s)
            : parts == 2 ? launch_bwd_np<2>(x, flat, ws, n, sh, n_blocks, ct, scratch, dpart,
                                            carries, smem, s)
                         : launch_bwd_np<3>(x, flat, ws, n, sh, n_blocks, ct, scratch, dpart,
                                            carries, smem, s);
  if (err) return err;
  return (int)sum_gradient_partials(dpart, n_blocks, n_params(n_hidden, h, k), dflat, s);
}

}  // extern "C"
