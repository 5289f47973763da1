"""Closed-form derivative engines for 2-D PINN residuals.

The port of the tanh-MLP engines of nsfnet_tpu/ops/derivatives.py: value +
Taylor-tangent propagation through the network in one forward sweep — where
the reference chains six reverse-mode `torch.autograd.grad` passes
(ev-NSFnet/pinn_solver.py:301-309).

  * `mlp_derivatives_2d` (:245-287): every first derivative and the two
    diagonal second derivatives of all outputs (velocity formulation);
  * `mlp_psi_derivatives_2d` (:191-242) with `assemble_psi_bundle`
    (:139-164), `tanh_chain` (:179) and `psi_p_uv` (:167-176): the
    streamfunction formulation, where the net outputs (psi, p), u = psi_y,
    v = -psi_x, and the momentum Laplacian needs third derivatives of psi.

They are the CPU engines and the oracles the CUDA kernel pairs
(ops/fused_residual.py, ops/mlp_streams.py, ops/psi_streams.py) are held
against. The generic nested-jvp engines serve only the Fourier / KAN
backbones and come with them.
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


N_PSI_STREAMS = 13  # value + 4 directions x 3 orders


def tanh_chain(t: torch.Tensor):
    """The first four derivatives of tanh, expressed in t = tanh(z)."""
    d1 = 1.0 - t * t
    d2 = -2.0 * t * d1
    d3 = -2.0 * d1 * (1.0 - 3.0 * t * t)
    d4 = -2.0 * (d2 * (1.0 - 3.0 * t * t) - 6.0 * t * d1 * d1)
    return d1, d2, d3, d4


def mlp_psi_streams(params: Params, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The 13 raw order-3 Taylor streams of a tanh MLP, each [N, K]:

        [o | a_x a_y a_p a_m | b_x b_y b_p b_m | c_x c_y c_p c_m]

    the value and, along e_x, e_y, (1,1) and (1,-1), the directional
    derivatives of order 1 (a), 2 (b) and 3 (c). All four directions share
    one primal forward: the tangents ride a stacked [4, N, H] axis. Per
    layer, with t = tanh(z) and (d1, d2, d3) = tanh_chain(t), the order-3
    chain rule (Faa di Bruno) along a fixed direction is

        h1 = d1 z1
        h2 = d2 z1^2 + d1 z2
        h3 = d3 z1^3 + 3 d2 z1 z2 + d1 z3

    The first layer is analytic: its pre-activation tangents are the
    constant rows W0[0], W0[1], W0[0] + W0[1], W0[0] - W0[1] and
    z2 = z3 = 0. The head is linear (bias on the value stream only)."""
    w0, b0 = params[0]
    z = x @ w0 + b0
    wx, wy = w0[0], w0[1]
    dirs = torch.stack([wx, wy, wx + wy, wx - wy])[:, None, :]  # [4, 1, H]
    t = torch.tanh(z)
    d1, d2, d3, _ = tanh_chain(t)
    h = t
    h1 = d1[None] * dirs
    h2 = d2[None] * (dirs * dirs)
    h3 = d3[None] * (dirs * dirs * dirs)

    for w, b in params[1:-1]:
        z = h @ w + b
        z1, z2, z3 = h1 @ w, h2 @ w, h3 @ w
        t = torch.tanh(z)
        d1, d2, d3, _ = tanh_chain(t)
        h = t
        h3 = d3 * z1 * z1 * z1 + 3.0 * d2 * z1 * z2 + d1 * z3
        h2 = d2 * z1 * z1 + d1 * z2
        h1 = d1 * z1

    w, b = params[-1]
    o1, o2, o3 = h1 @ w, h2 @ w, h3 @ w
    return (h @ w + b, *o1.unbind(0), *o2.unbind(0), *o3.unbind(0))


def assemble_psi_bundle(streams, uv_scale: float = 1.0) -> Derivs:
    """The 13 raw streams of a (psi, p) net -> the (u, v, p) `Derivs` bundle
    with u = s psi_y, v = -s psi_x, so that every consumer of the velocity
    bundle works unchanged and continuity (u_x + v_y) is identically zero.
    The mixed partials come from the diagonal sweeps:

        D2_(1,+-1) = psi_xx +- 2 psi_xy + psi_yy
        D3_(1,+-1) = psi_xxx +- 3 psi_xxy + 3 psi_xyy +- psi_yyy

    `uv_scale` (s) is the coordinate-transform chain-rule factor applied
    once to the psi-derived u, v (the residuals scale per derivative order
    on top); the p columns are returned unscaled. The order-1 diagonal
    streams (a_p, a_m) are carried by the layer recursion but unused here."""
    out, gx, gy, _, _, gxx, gyy, m2, n2, gxxx, gyyy, m3, n3 = streams
    col = lambda a, k: a[:, k:k + 1]
    psi_x, psi_xx, psi_xxx = col(gx, 0), col(gxx, 0), col(gxxx, 0)
    psi_y, psi_yy, psi_yyy = col(gy, 0), col(gyy, 0), col(gyyy, 0)
    p, p_x, p_y = col(out, 1), col(gx, 1), col(gy, 1)
    psi_xy = (col(m2, 0) - col(n2, 0)) * 0.25
    psi_xyy = ((col(m3, 0) + col(n3, 0)) - 2.0 * psi_xxx) / 6.0
    psi_xxy = ((col(m3, 0) - col(n3, 0)) - 2.0 * psi_yyy) / 6.0

    s = uv_scale
    zero = torch.zeros_like(p)
    cat = lambda a, b, c: torch.cat([a, b, c], dim=1)
    return (
        cat(s * psi_y, -s * psi_x, p),          # (u, v, p)
        cat(s * psi_xy, -s * psi_xx, p_x),      # d/dx
        cat(s * psi_yy, -s * psi_xy, p_y),      # d/dy  (v_y = -u_x exactly)
        cat(s * psi_xxy, -s * psi_xxx, zero),   # d2/dx2 (p_xx unused)
        cat(s * psi_yyy, -s * psi_xyy, zero),   # d2/dy2
    )


def mlp_psi_derivatives_2d(params: Params, x: torch.Tensor,
                           uv_scale: float = 1.0) -> Derivs:
    """Closed-form streamfunction engine: the (u, v, p) bundle of a tanh MLP
    [N,2] -> [N,2] = (psi, p)."""
    return assemble_psi_bundle(mlp_psi_streams(params, x), uv_scale)


def psi_p_uv(params: Params, x: torch.Tensor, uv_scale: float = 1.0) -> torch.Tensor:
    """(u, v, p) VALUES [N,3] of the streamfunction formulation — the
    first-order companion of mlp_psi_derivatives_2d, used for the boundary
    loss and prediction (u = s psi_y, v = -s psi_x). A closed-form value +
    first-tangent pass; autograd differentiates it wrt the weights."""
    w0, b0 = params[0]
    h = torch.tanh(x @ w0 + b0)
    s = 1.0 - h * h
    hx, hy = s * w0[0], s * w0[1]
    for w, b in params[1:-1]:
        h = torch.tanh(h @ w + b)
        s = 1.0 - h * h
        hx, hy = s * (hx @ w), s * (hy @ w)
    w, b = params[-1]
    out, fx, fy = h @ w + b, hx @ w, hy @ w
    return torch.cat([uv_scale * fy[:, 0:1], -uv_scale * fx[:, 0:1], out[:, 1:2]], dim=1)
