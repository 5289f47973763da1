// What every kernel of the port shares outside its sweep: the flat parameter
// layout of models/mlp.py, the shared memory a block may use, and the
// ordered second pass that adds the per-block partials. The sweeps
// themselves run on the tensor cores (tc_mlp.cuh, tc_psi.cuh).
//
// Grid. A FIXED number of blocks (a constant of the wrapper, not the SM
// count) loops over tiles; a kernel that reduces keeps one partial per
// block (a full gradient vector in the flat parameter layout, or a few loss
// sums), and sum_partials adds the partials in block order in double
// precision. A backward adds into its gradient partial by reductions, each
// element from one owning thread in program order (tc_mlp.cuh red_add), so
// equal inputs give bitwise-equal outputs.
//
// Each .cu that includes this header is its own shared library, so
// everything here has internal linkage.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90

// Flat parameter layout (models/mlp.py flatten_params):
//   W0[2,h] b0[h] | W1[h,h] b1[h] | ... | W_{L-1}[h,h] b_{L-1}[h] | Wh[h,k] bh[k]
__host__ __device__ inline long hidden_off(int l, int h) {  // W_l, l >= 1
  return 3L * h + (long)(l - 1) * ((long)h * h + h);
}
__host__ __device__ inline long head_off(int n_hidden, int h) { return hidden_off(n_hidden, h); }
__host__ __device__ inline long n_params(int n_hidden, int h, int k) {
  return head_off(n_hidden, h) + (long)h * k + k;
}

// out[i] = sum over blocks b (in order) of partial[b * width + i], in double.
__global__ void sum_partials(const float* __restrict__ partial, int n_blocks, long width,
                             long n_cols, float* out) {
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_cols) return;
  double s = 0.0;
  for (int b = 0; b < n_blocks; ++b) s += (double)partial[b * width + i];
  out[i] = (float)s;
}

// Launches sum_partials over a [n_blocks, P] gradient partial on stream s.
inline cudaError_t sum_gradient_partials(const float* dpart, int n_blocks, long P, float* dflat,
                                         cudaStream_t s) {
  sum_partials<<<(unsigned)((P + 255) / 256), 256, 0, s>>>(dpart, n_blocks, P, P, dflat);
  return cudaGetLastError();
}

}  // namespace
