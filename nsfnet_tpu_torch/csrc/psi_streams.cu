// Order-3 streamfunction derivative engine for Hopper (sm_90a), fp32 on the
// CUDA cores.
//
// Replaces the TPU kernels of nsfnet_tpu/ops/pallas_psi.py:
//   psi_fwd_kernel <- _fwd_kernel (:176, launched by _fwd_pallas, pallas_call at :204)
//   psi_bwd_kernel <- _bwd_kernel (:223, launched by _bwd_pallas, pallas_call at :330)
//
// What they compute, for a tanh MLP 2 -> H (x n_hidden) -> K and points x[N,2]:
//   forward : the packed value + 12 Taylor streams (orders 1-3 along e_x,
//             e_y, (1,1), (1,-1)) through every layer, then the thirteen
//             [N,K] head streams, written row-major to global memory, the
//             value stream with the head bias.
//   backward: recompute the forward keeping every carry and tangent row,
//             read the thirteen [N,K] cotangent streams, run the packed
//             order-3 reverse sweep -> dW / db of every layer in the flat
//             parameter layout of models/mlp.py. x gets no cotangent:
//             collocation points are constants.
// The (u, v, p) bundle is assembled from the raw streams outside, in plain
// PyTorch (ops/derivatives.assemble_psi_bundle), as the JAX package does.
//
// What bounds them on this card: operations. Per point the forward does
// 13 streams x 2*H*H FLOP per product layer (0.83 MFLOP at 6x80) and the
// backward three times that, against 8 B read and 52*K B written (forward)
// or read (backward) per point: both sit far above the fp32 ridge point.
// The products run as fp32 FMAs on the CUDA cores, as in the other two
// pairs; tensor-core passes are later work.
//
// Design: packed_psi.cuh holds the 13-stream device functions over
// packed_mlp.cuh's tile, fixed grid, ordered partial sums and backward
// scratch. The TPU kernels' tile functions (fwd_tile_for_psi,
// bwd_tile_for_psi) are VMEM budgets and are not carried over: the tile
// here comes from shared memory (two [13][T][H] carries, the staged weight
// and the [13][T][K] head block must fit in one block's 227 KB), chosen by
// the wrapper and checked against nsf_psi_streams_smem_bytes. As in
// mlp_streams.cu, the backward does not run the head product.

#include "packed_psi.cuh"

namespace {

struct PsiOut {
  float* s[kPsi];  // o, a_x a_y a_p a_m, b_*, c_*: each [N, K] row-major
};

struct PsiCt {
  const float* s[kPsi];
};

__global__ void __launch_bounds__(kPsiThreads)
psi_fwd_kernel(const float* __restrict__ x, const float* __restrict__ flat, int n, Shapes sh,
               PsiOut out) {
  extern __shared__ float smem[];
  const int T = sh.tile, h = sh.h, k = sh.k, S = T * h, TK = T * k;
  float* buf_a = smem;
  float* buf_b = buf_a + kPsi * S;
  float* ws = buf_b + kPsi * S;
  float* hb = ws + h * (h + 1);
  const long wh = head_off(sh.n_hidden, h);

  const int n_tiles = n / T;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long n0 = (long)tile * T;
    __syncthreads();  // the previous tile's readers of buf_a / hb are done
    float* cur = psi_forward_tile(x, flat, n0, sh, buf_a, buf_b, ws, nullptr);
    __syncthreads();
    psi_head_layer(cur, flat + wh, flat + wh + (long)h * k, hb, T, h, k);
    __syncthreads();
    // a tile's rows are contiguous in each [N, K] stream
    for (int idx = threadIdx.x; idx < kPsi * TK; idx += blockDim.x) {
      int q = idx / TK, r = idx - q * TK;
      out.s[q][n0 * k + r] = hb[idx];
    }
  }
}

__global__ void __launch_bounds__(kPsiThreads)
psi_bwd_kernel(const float* __restrict__ x, const float* __restrict__ flat, int n, Shapes sh,
               PsiCt ct, float* scratch, float* dpart) {
  extern __shared__ float smem[];
  const int T = sh.tile, h = sh.h, k = sh.k, L = sh.n_hidden, S = T * h, TK = T * k;
  float* buf_a = smem;
  float* buf_b = buf_a + kPsi * S;
  float* ws = buf_b + kPsi * S;
  float* hb = ws + h * (h + 1);
  const long P = n_params(L, h, k);
  float* dp = dpart + blockIdx.x * P;
  float* store = scratch + blockIdx.x * psi_scratch_floats(T, h, L);

  for (long i = threadIdx.x; i < P; i += blockDim.x) dp[i] = 0.f;

  const int n_tiles = n / T;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long n0 = (long)tile * T;
    __syncthreads();  // the previous tile's sweep is done with the buffers and hb
    for (int idx = threadIdx.x; idx < kPsi * TK; idx += blockDim.x) {
      int q = idx / TK, r = idx - q * TK;
      hb[idx] = ct.s[q][n0 * k + r];
    }
    float* cur = psi_forward_tile(x, flat, n0, sh, buf_a, buf_b, ws, store);
    float* other = cur == buf_a ? buf_b : buf_a;
    __syncthreads();
    psi_reverse_sweep(x, flat, n0, sh, cur, other, ws, hb, store, dp);
  }
}

}  // namespace

extern "C" {

// Shared memory one block of either kernel uses, in bytes.
int nsf_psi_streams_smem_bytes(int tile, int h, int k) {
  return (int)(psi_smem_floats(tile, h, k) * sizeof(float));
}

// Floats of backward scratch one block uses; the wrapper allocates n_blocks of them.
long nsf_psi_streams_scratch_floats(int tile, int h, int n_hidden) {
  return psi_scratch_floats(tile, h, n_hidden);
}

// Forward: outs[0..12] <- the thirteen [n, k] streams (outs is a host array
// of device pointers). Returns a cudaError_t code (0 = launched).
int nsf_psi_streams_fwd(const float* x, const float* flat, int n, int n_hidden, int h, int k,
                        int tile, int n_blocks, float* const* outs, void* stream) {
  const size_t smem = psi_smem_floats(tile, h, k) * sizeof(float);
  int bad = check_launch_args(n, h, k, tile, n_hidden, n_blocks, smem);
  if (bad) return bad;
  cudaError_t err = cudaFuncSetAttribute(psi_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  Shapes sh{n_hidden, h, k, tile};
  PsiOut out;
  for (int q = 0; q < kPsi; ++q) out.s[q] = outs[q];
  psi_fwd_kernel<<<n_blocks, kPsiThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, flat, n, sh, out);
  return (int)cudaGetLastError();
}

// Backward: dflat = sum over the thirteen streams of <cotangent, d stream / d params>,
// in the flat layout. cts[0..12]: the [n, k] cotangents (a host array of
// device pointers). scratch: [n_blocks, nsf_psi_streams_scratch_floats],
// dpart: [n_blocks, n_params]. Returns a cudaError_t code (0 = launched).
int nsf_psi_streams_bwd(const float* x, const float* flat, int n, int n_hidden, int h, int k,
                        int tile, int n_blocks, const float* const* cts, float* scratch,
                        float* dpart, float* dflat, void* stream) {
  const size_t smem = psi_smem_floats(tile, h, k) * sizeof(float);
  int bad = check_launch_args(n, h, k, tile, n_hidden, n_blocks, smem);
  if (bad) return bad;
  cudaError_t err = cudaFuncSetAttribute(psi_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Shapes sh{n_hidden, h, k, tile};
  PsiCt ct;
  for (int q = 0; q < kPsi; ++q) ct.s[q] = cts[q];
  psi_bwd_kernel<<<n_blocks, kPsiThreads, smem, s>>>(x, flat, n, sh, ct, scratch, dpart);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)sum_gradient_partials(dpart, n_blocks, n_params(n_hidden, h, k), dflat, s);
}

}  // extern "C"
