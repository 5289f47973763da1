// The order-3 streamfunction engine's pack and the derivatives of tanh it
// needs (tc_psi.cuh builds the sweep on them).
//
// For a tanh MLP 2 -> H (x n_hidden) -> K, the value and the order-1/2/3
// directional derivatives along e_x, e_y, (1,1), (1,-1) travel as one
// packed carry of kPsi = 13 streams (nsfnet_tpu/ops/pallas_psi.py):
//
//     [ h | a_x a_y a_p a_m | b_x b_y b_p b_m | c_x c_y c_p c_m ]
//
// so every layer is one product against the shared weight matrix with the
// Faa di Bruno algebra fused into its epilogue (tc_psi.cuh says how).

#pragma once

#include "packed_mlp.cuh"

namespace {

constexpr int kPsi = 13;  // value + 4 directions x 3 orders

struct TanhChain {
  float d1, d2, d3, d4;
};

// tanh', tanh'', tanh''', tanh'''' in t = tanh(z).
__device__ inline TanhChain tanh_chain(float t) {
  const float d1 = 1.0f - t * t;
  const float d2 = -2.0f * t * d1;
  const float u = 1.0f - 3.0f * t * t;
  const float d3 = -2.0f * d1 * u;
  const float d4 = -2.0f * (d2 * u - 6.0f * t * d1 * d1);
  return {d1, d2, d3, d4};
}

}  // namespace
