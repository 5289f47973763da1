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
against.

The other backbones (no kernel serves them, in either package):
  * `derivatives_2d`, `first_derivatives_2d` (:34-84) and
    `psi_p_derivatives_2d` (:107-137), with `psi_p_uv_generic` (:167-176):
    the generic engines, nested `torch.func.jvp` over any batched smooth
    `apply(x)` (the Fourier-embedded MLP); autograd differentiates them
    wrt weights captured by the closure;
  * `make_kan_derivatives_2d` (:290-341): the KAN's closed form, one
    B-spline basis evaluation per layer for the value and both orders.
Eager forward mode runs the primal again in every jvp trace (two per
direction at order 2, three at order 3), where XLA's CSE merges them.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch.func import jvp

from nsfnet_tpu_torch.models.mlp import Params, unflatten_params

Derivs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
# (out, d/dx, d/dy, d2/dx2, d2/dy2), each [N, K]


Apply = Callable[[torch.Tensor], torch.Tensor]


def _tangents(x: torch.Tensor, *dirs) -> Tuple[torch.Tensor, ...]:
    """Tangent batches [N, 2], one per direction. (The JAX package wraps
    them in an optimization_barrier against a TPU fusion crash; eager
    PyTorch has no such fusion.)"""
    return tuple(x.new_tensor(d).expand_as(x) for d in dirs)


def _directional_second_order(apply_fn: Apply, x: torch.Tensor, v: torch.Tensor):
    """f(x), Df v, D2f (v, v) by a jvp of a jvp."""
    (out, d1), (_, d2) = jvp(lambda z: jvp(apply_fn, (z,), (v,)), (x,), (v,))
    return out, d1, d2


def _directional_third_order(apply_fn: Apply, x: torch.Tensor, v: torch.Tensor):
    """f, Df v, D2f (v, v), D3f (v, v, v) by three nested jvps (exact
    directional derivatives, not Taylor coefficients)."""
    def first(u):
        return jvp(apply_fn, (u,), (v,))

    def second(w):
        return jvp(first, (w,), (v,))

    ((f, d1), (_, d2)), (_, (_, d3)) = jvp(second, (x,), (v,))
    return f, d1, d2, d3


def derivatives_2d(apply_fn: Apply, x: torch.Tensor) -> Derivs:
    """All first and the two diagonal second derivatives of a batched
    f: [N,2] -> [N,K] wrt x and y: one order-2 sweep per coordinate."""
    ex, ey = _tangents(x, (1.0, 0.0), (0.0, 1.0))
    out, fx, fxx = _directional_second_order(apply_fn, x, ex)
    _, fy, fyy = _directional_second_order(apply_fn, x, ey)
    return out, fx, fy, fxx, fyy


def first_derivatives_2d(apply_fn: Apply, x: torch.Tensor):
    """(out, d/dx, d/dy) only, for first-order residuals."""
    ex, ey = _tangents(x, (1.0, 0.0), (0.0, 1.0))
    out, fx = jvp(apply_fn, (x,), (ex,))
    _, fy = jvp(apply_fn, (x,), (ey,))
    return out, fx, fy


def psi_p_derivatives_2d(apply_fn: Apply, x: torch.Tensor, uv_scale: float = 1.0) -> Derivs:
    """The (u, v, p) bundle of a generic (psi, p) net f: [N,2] -> [N,2]:
    four order-3 sweeps along e_x, e_y, (1,1) and (1,-1) give the 13 raw
    streams that `assemble_psi_bundle` takes (the closed-form engine's
    assembly)."""
    ex, ey, dp, dm = _tangents(x, (1.0, 0.0), (0.0, 1.0), (1.0, 1.0), (1.0, -1.0))
    out, gx, gxx, gxxx = _directional_third_order(apply_fn, x, ex)
    _, gy, gyy, gyyy = _directional_third_order(apply_fn, x, ey)
    _, a_p, m2, m3 = _directional_third_order(apply_fn, x, dp)
    _, a_m, n2, n3 = _directional_third_order(apply_fn, x, dm)
    return assemble_psi_bundle((out, gx, gy, a_p, a_m, gxx, gyy, m2, n2, gxxx, gyyy, m3, n3),
                               uv_scale)


def psi_p_uv_generic(apply_fn: Apply, x: torch.Tensor, uv_scale: float = 1.0) -> torch.Tensor:
    """(u, v, p) VALUES [N,3] of a generic (psi, p) net by one tangent sweep
    per coordinate (u = s psi_y, v = -s psi_x)."""
    out, fx, fy = first_derivatives_2d(apply_fn, x)
    return torch.cat([uv_scale * fy[:, 0:1], -uv_scale * fx[:, 0:1], out[:, 1:2]], dim=1)


def make_kan_derivatives_2d(kan) -> Callable[..., Derivs]:
    """Closed-form value + tangent propagation through a KAN (the KAN
    analogue of mlp_derivatives_2d). Each layer is y_j = sum_i phi_ij(h_i),
    so the chain rule needs only phi' and phi'' elementwise (the B-spline
    derivative bases and silu's derivatives) against the carried tangents:

        y_x  = sum_i phi'(h_i) h_i,x
        y_xx = sum_i phi''(h_i) h_i,x^2 + phi'(h_i) h_i,xx

    `kan` carries grid and k (models/kan.KAN; the grid spans its
    GRID_RANGE); the engine takes the per-layer (coef, w_base, w_sp) tuple and X[N,2]."""
    from nsfnet_tpu_torch.models.kan import bspline_basis_derivs

    grid, k = kan.grid, kan.k

    def engine(params, x: torch.Tensor) -> Derivs:
        h = x
        hx, hy = _tangents(x, (1.0, 0.0), (0.0, 1.0))
        hxx = torch.zeros_like(x)
        hyy = torch.zeros_like(x)
        for coef, w_base, w_sp in params:
            basis, dbasis, d2basis = bspline_basis_derivs(h, grid, k)
            sp = torch.einsum("nib,iob->nio", basis, coef)
            dsp = torch.einsum("nib,iob->nio", dbasis, coef)
            d2sp = torch.einsum("nib,iob->nio", d2basis, coef)
            sig = torch.sigmoid(h)
            base = h * sig                                            # silu
            dbase = sig + h * sig * (1.0 - sig)                       # silu'
            d2base = sig * (1.0 - sig) * (2.0 + h * (1.0 - 2.0 * sig))  # silu''
            phi = w_base[None] * base[..., None] + w_sp[None] * sp
            dphi = w_base[None] * dbase[..., None] + w_sp[None] * dsp
            d2phi = w_base[None] * d2base[..., None] + w_sp[None] * d2sp
            y = phi.sum(dim=1)
            y_x = (dphi * hx[..., None]).sum(dim=1)
            y_y = (dphi * hy[..., None]).sum(dim=1)
            y_xx = (d2phi * (hx * hx)[..., None] + dphi * hxx[..., None]).sum(dim=1)
            y_yy = (d2phi * (hy * hy)[..., None] + dphi * hyy[..., None]).sum(dim=1)
            h, hx, hy, hxx, hyy = y, y_x, y_y, y_xx, y_yy
        return h, hx, hy, hxx, hyy

    return engine


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


class _StackedPsiPUV(torch.autograd.Function):
    """psi_p_uv on the flat weights with the value and both tangents
    stacked into one [3N, H] product a layer, and its backward written out:
    ~110 operations forward and backward where autograd of psi_p_uv runs
    ~220, the same fp32 arithmetic but for the order of each product's
    sums. Gradients flow to flat only. First order only (no jvp)."""

    @staticmethod
    def forward(ctx, flat, x, sizes, uv_scale):
        params = unflatten_params(flat, sizes)
        n = x.shape[0]
        w0, b0 = params[0]
        h = torch.tanh(torch.addmm(b0, x, w0))
        s = 1.0 - h * h
        stack = torch.cat([h[None], s[None] * w0[:, None, :]])  # [h; h_x; h_y], [3, N, H]
        saved = [h, s]
        for w, b in params[1:-1]:
            z = (stack.view(3 * n, -1) @ w).view(3, n, -1)
            h = torch.tanh(z[0] + b)
            s = 1.0 - h * h
            saved += [stack, z, h, s]
            stack = torch.cat([h[None], s[None] * z[1:]])
        w, b = params[-1]
        o = (stack.view(3 * n, -1) @ w).view(3, n, -1)
        ctx.save_for_backward(flat, x, stack, *saved)
        ctx.meta = (sizes, uv_scale)
        return torch.cat([uv_scale * o[2, :, 0:1], -uv_scale * o[1, :, 0:1], o[0, :, 1:2] + b[1]],
                         dim=1)

    @staticmethod
    def backward(ctx, g):
        flat, x, last, h0, s0, *saved = ctx.saved_tensors
        sizes, uv_scale = ctx.meta
        params = unflatten_params(flat, sizes)
        n = x.shape[0]
        go = g.new_zeros((3, n, sizes[-1]))
        go[2, :, 0] = uv_scale * g[:, 0]
        go[1, :, 0] = -uv_scale * g[:, 1]
        go[0, :, 1] = g[:, 2]
        w, _ = params[-1]
        go = go.view(3 * n, -1)
        db = g.new_zeros(sizes[-1])
        db[1] = g[:, 2].sum()
        grads = [(last.view(3 * n, -1).T @ go, db)]
        d = (go @ w.T).view(3, n, -1)
        for (w, _), i in zip(reversed(params[1:-1]), range(len(saved) - 4, -1, -4)):
            stack, z, h, s = saved[i:i + 4]
            # stack_out = [h; s z_x; s z_y], h = tanh(z_0 + b), s = 1 - h^2
            ds = (d[1:] * z[1:]).sum(0)
            dz0 = torch.addcmul(d[0], h, ds, value=-2.0) * s
            dz = torch.cat([dz0[None], s[None] * d[1:]]).view(3 * n, -1)
            grads.append((stack.view(3 * n, -1).T @ dz, dz0.sum(0)))
            d = (dz @ w.T).view(3, n, -1)
        w0, _ = params[0]
        # the first layer: [h; s w0_x; s w0_y], h = tanh(x w0 + b0)
        ds = (d[1:] * w0[:, None, :]).sum(0)
        da = torch.addcmul(d[0], h0, ds, value=-2.0) * s0
        grads.append((torch.addmm((d[1:] * s0[None]).sum(1), x.T, da), da.sum(0)))
        return torch.cat([t.reshape(-1) for pair in reversed(grads) for t in pair]), None, None, \
            None


def psi_p_uv_stacked(flat: torch.Tensor, sizes, x: torch.Tensor,
                     uv_scale: float = 1.0) -> torch.Tensor:
    """psi_p_uv of the MLP whose flat weights are `flat` (`sizes` its layer
    sizes), for the Adam step's boundary loss: on a card the stacked pass
    and its written-out backward (`_StackedPsiPUV`), half the launches; on
    the CPU psi_p_uv itself. Differentiable wrt `flat` only."""
    if x.device.type == "cpu":
        return psi_p_uv(unflatten_params(flat, sizes), x, uv_scale)
    return _StackedPsiPUV.apply(flat, x.detach(), tuple(sizes), float(uv_scale))
