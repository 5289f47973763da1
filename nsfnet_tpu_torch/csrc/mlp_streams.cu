// Five-stream derivative engine for Hopper (sm_90a), fp32 on the CUDA cores.
//
// Replaces the TPU kernels of nsfnet_tpu/ops/pallas_mlp.py:
//   streams_fwd_kernel <- _fwd_kernel (:183, launched by _fwd_pallas, pallas_call at :218)
//   streams_bwd_kernel <- _bwd_kernel (:313, launched by _bwd_pallas, pallas_call at :352)
//
// What they compute, for a tanh MLP 2 -> H (x n_hidden) -> K and points x[N,2]:
//   forward : the packed value + 4 Taylor streams through every layer, then
//             the five [N,K] head streams (value, d/dx, d/dy, d2/dx2, d2/dy2)
//             of every output, written row-major to global memory, the value
//             stream with the head bias.
//   backward: recompute the forward keeping every carry, read the five [N,K]
//             cotangent streams, run the packed reverse sweep -> dW / db of
//             every layer in the flat parameter layout of models/mlp.py.
//             x gets no cotangent: collocation points are constants.
//
// What bounds them on this card: operations. Per point the forward does
// 5 streams x 2*H*H FLOP per product layer (0.43 MFLOP at 4x120, 0.32 at
// 6x80) and the backward three times that, against 8 B read and 20*K B
// written (forward) or read (backward) per point: both sit far above the
// fp32 ridge point. The products run as fp32 FMAs on the CUDA cores, as in
// fused_residual.cu; tensor-core passes are later work.
//
// Design: packed_mlp.cuh holds the tile, the fixed grid, the ordered partial
// sums and the backward scratch, shared with the fused residual-loss pair.
// The forward reduces nothing, so any grid would give the same result; it
// keeps the fixed-block loop so that both kernels have one code shape. The
// backward does not run the head product: the head's output is not an input
// of its own gradient, only the last carry and the cotangents are.

#include "packed_mlp.cuh"

namespace {

struct Streams {
  float* s[5];  // value, d/dx, d/dy, d2/dx2, d2/dy2: each [N, K] row-major
};

struct ConstStreams {
  const float* s[5];
};

__global__ void __launch_bounds__(kThreads)
streams_fwd_kernel(const float* __restrict__ x, const float* __restrict__ flat, int n,
                   Shapes sh, Streams out) {
  extern __shared__ float smem[];
  const int T = sh.tile, h = sh.h, k = sh.k, S = T * h, TK = T * k;
  float* buf_a = smem;
  float* buf_b = buf_a + 5 * S;
  float* ws = buf_b + 5 * S;
  float* hb = ws + h * (h + 1) + 4 * T;
  const long wh = head_off(sh.n_hidden, h);

  const int n_tiles = n / T;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long n0 = (long)tile * T;
    __syncthreads();  // the previous tile's readers of buf_a / hb are done
    float* cur = forward_tile(x, flat, n0, sh, buf_a, buf_b, ws, nullptr);
    __syncthreads();
    head_layer(cur, flat + wh, flat + wh + (long)h * k, hb, T, h, k);
    __syncthreads();
    // a tile's rows are contiguous in each [N, K] stream
    for (int idx = threadIdx.x; idx < 5 * TK; idx += blockDim.x) {
      int q = idx / TK, r = idx - q * TK;
      out.s[q][n0 * k + r] = hb[idx];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
streams_bwd_kernel(const float* __restrict__ x, const float* __restrict__ flat, int n,
                   Shapes sh, ConstStreams ct, float* scratch, float* dpart) {
  extern __shared__ float smem[];
  const int T = sh.tile, h = sh.h, k = sh.k, L = sh.n_hidden, S = T * h, TK = T * k;
  float* buf_a = smem;
  float* buf_b = buf_a + 5 * S;
  float* ws = buf_b + 5 * S;
  float* hb = ws + h * (h + 1) + 4 * T;
  const long P = n_params(L, h, k);
  float* dp = dpart + blockIdx.x * P;
  float* store = scratch + blockIdx.x * scratch_floats(T, h, L);

  for (long i = threadIdx.x; i < P; i += blockDim.x) dp[i] = 0.f;

  const int n_tiles = n / T;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long n0 = (long)tile * T;
    __syncthreads();  // the previous tile's sweep is done with the buffers and hb
    for (int idx = threadIdx.x; idx < 5 * TK; idx += blockDim.x) {
      int q = idx / TK, r = idx - q * TK;
      hb[idx] = ct.s[q][n0 * k + r];
    }
    float* cur = forward_tile(x, flat, n0, sh, buf_a, buf_b, ws, store);
    float* other = cur == buf_a ? buf_b : buf_a;
    __syncthreads();
    reverse_sweep(x, flat, n0, sh, cur, other, ws, hb, store, dp);
  }
}

}  // namespace

extern "C" {

// Shared memory one block of either kernel uses, in bytes.
int nsf_mlp_streams_smem_bytes(int tile, int h, int k) {
  return (int)(smem_floats(tile, h, k) * sizeof(float));
}

// Floats of backward scratch one block uses; the wrapper allocates n_blocks of them.
long nsf_mlp_streams_scratch_floats(int tile, int h, int n_hidden) {
  return scratch_floats(tile, h, n_hidden);
}

// Forward: o, ox, oy, oxx, oyy <- the five [n, k] streams.
// Returns a cudaError_t code (0 = launched).
int nsf_mlp_streams_fwd(const float* x, const float* flat, int n, int n_hidden, int h, int k,
                        int tile, int n_blocks, float* o, float* ox, float* oy, float* oxx,
                        float* oyy, void* stream) {
  const size_t smem = smem_floats(tile, h, k) * sizeof(float);
  int bad = check_launch_args(n, h, k, tile, n_hidden, n_blocks, smem);
  if (bad) return bad;
  cudaError_t err = cudaFuncSetAttribute(streams_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  Shapes sh{n_hidden, h, k, tile};
  Streams out{{o, ox, oy, oxx, oyy}};
  streams_fwd_kernel<<<n_blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, flat, n, sh, out);
  return (int)cudaGetLastError();
}

// Backward: dflat = sum over the five streams of <cotangent, d stream / d params>,
// in the flat layout. g*: the [n, k] cotangents of o, ox, oy, oxx, oyy.
// scratch: [n_blocks, nsf_mlp_streams_scratch_floats], dpart: [n_blocks, n_params].
// Returns a cudaError_t code (0 = launched).
int nsf_mlp_streams_bwd(const float* x, const float* flat, int n, int n_hidden, int h, int k,
                        int tile, int n_blocks, const float* g, const float* gx,
                        const float* gy, const float* gxx, const float* gyy, float* scratch,
                        float* dpart, float* dflat, void* stream) {
  const size_t smem = smem_floats(tile, h, k) * sizeof(float);
  int bad = check_launch_args(n, h, k, tile, n_hidden, n_blocks, smem);
  if (bad) return bad;
  cudaError_t err = cudaFuncSetAttribute(streams_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Shapes sh{n_hidden, h, k, tile};
  ConstStreams ct{{g, gx, gy, gxx, gyy}};
  streams_bwd_kernel<<<n_blocks, kThreads, smem, s>>>(x, flat, n, sh, ct, scratch, dpart);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)sum_gradient_partials(dpart, n_blocks, n_params(n_hidden, h, k), dflat, s);
}

}  // extern "C"
