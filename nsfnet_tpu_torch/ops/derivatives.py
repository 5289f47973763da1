"""Closed-form derivative engine for 2-D PINN residuals.

The port of `mlp_derivatives_2d` (nsfnet_tpu/ops/derivatives.py:245-287):
value + Taylor-tangent propagation through a tanh MLP, giving every first
derivative and the two diagonal second derivatives of all outputs in one
forward sweep — where the reference chains six reverse-mode
`torch.autograd.grad` passes (ev-NSFnet/pinn_solver.py:301-309).

It is the CPU engine and the oracle the fused kernel pair
(ops/fused_residual.py) is held against. The generic jvp-of-jvp engine,
the streamfunction engines and the KAN engine come in later slices.
"""

from __future__ import annotations

from typing import Tuple

import torch

from nsfnet_tpu_torch.models.mlp import Params

Derivs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
# (out, d/dx, d/dy, d2/dx2, d2/dy2), each [N, K]


def mlp_derivatives_2d(params: Params, x: torch.Tensor) -> Derivs:
    """Carries (h, h_x, h_y, h_xx, h_yy) through each layer. For z = h W + b
    and t = tanh(z) with s = 1 - t^2 (tanh') and -2 t s (tanh''):

        t_x  = s * z_x
        t_xx = -2 t s * z_x^2 + s * z_xx

    The first layer is analytic: its input tangents are the coordinate unit
    vectors, so z_x/z_y are the rows of W0 and z_xx = z_yy = 0. The head
    layer is linear.
    """
    w0, b0 = params[0]
    z = x @ w0 + b0
    t = torch.tanh(z)
    s = 1.0 - t * t
    curv = -2.0 * t * s
    wx, wy = w0[0], w0[1]
    h = t
    hx = s * wx
    hy = s * wy
    hxx = curv * (wx * wx)
    hyy = curv * (wy * wy)

    for w, b in params[1:-1]:
        z = h @ w + b
        zx, zy, zxx, zyy = hx @ w, hy @ w, hxx @ w, hyy @ w
        t = torch.tanh(z)
        s = 1.0 - t * t
        curv = -2.0 * t * s
        h = t
        hxx = curv * zx * zx + s * zxx
        hyy = curv * zy * zy + s * zyy
        hx = s * zx
        hy = s * zy

    w, b = params[-1]
    return (h @ w + b, hx @ w, hy @ w, hxx @ w, hyy @ w)
