"""Kolmogorov-Arnold Network (KAN) backbone (port of nsfnet_tpu/models/kan.py).

The reference's physics-informed KAN notebook builds a pykan
`KAN(width=[2,16,16,8], grid=5, k=3, grid_eps=1.0)` and trains it as a PINN.
Each layer maps x in R^in -> R^out by out_j = sum_i phi_ij(x_i) with

    phi_ij(x) = w_base_ij * silu(x) + w_sp_ij * sum_m c_ijm B_m(x),

B_m the degree-k B-spline basis on a uniform grid over GRID_RANGE
(grid_eps=1.0: a pure uniform grid, no re-gridding). The basis is the Cox-de Boor recursion written as batched
tensor operations, so the network is smooth almost everywhere and runs
under `torch.func.jvp` and autograd alike. The comparisons of the degree-0
base case carry no tangent.

Params per layer are (coef[in, out, grid+k], w_base[in, out], w_sp[in, out]),
the JAX tree's leaf order. The `KAN` module keeps all of them in ONE flat
parameter vector, as models/mlp.py's MLP does, so that Adam, L-BFGS, LM and
the checkpoints work on the flat vector for either backbone.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

KanLayerParams = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (coef, w_base, w_sp)
KanParams = Tuple[KanLayerParams, ...]

GRID_RANGE = (-1.0, 1.0)  # the notebook's grid_range
NOISE_SCALE = 0.1  # the notebook's noise_scale: coef ~ N(0, 1) * NOISE_SCALE / grid


def _knots(grid: int, k: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Uniform knot vector extended by k intervals on each side."""
    lo, hi = GRID_RANGE
    h = (hi - lo) / grid
    return torch.arange(-k, grid + k + 1, dtype=dtype, device=device) * h + lo


def _cox_de_boor(x: torch.Tensor, t: torch.Tensor, degree: int) -> torch.Tensor:
    """Cox-de Boor recursion to `degree` over the knot vector t: [...] ->
    [..., len(t) - 1 - degree]. Uniform knots: every denominator is a
    positive multiple of the spacing."""
    xe = x[..., None]
    b = ((xe >= t[:-1]) & (xe < t[1:])).to(x.dtype)
    for d in range(1, degree + 1):
        left = (xe - t[: -(d + 1)]) / (t[d:-1] - t[: -(d + 1)]) * b[..., :-1]
        right = (t[d + 1:] - xe) / (t[d + 1:] - t[1:-d]) * b[..., 1:]
        b = left + right
    return b


def bspline_basis(x: torch.Tensor, grid: int, k: int) -> torch.Tensor:
    """Degree-k B-spline basis values of each scalar in x: [...] ->
    [..., grid + k]. Assumes the uniform knot vector of `_knots`."""
    return _cox_de_boor(x, _knots(grid, k, x.dtype, x.device), k)


def bspline_basis_derivs(x: torch.Tensor, grid: int, k: int):
    """(B, B', B'') of the degree-k basis at x, each [..., grid + k], from
    ONE degree-k recursion (nsfnet_tpu/models/kan.py:52-87). On uniform
    knots of spacing h the derivative recurrences are finite differences
    of the lower-degree bases, which are the recursion's intermediates:

        B'_m  = (B_{m,k-1} - B_{m+1,k-1}) / h
        B''_m = (B_{m,k-2} - 2 B_{m+1,k-2} + B_{m+2,k-2}) / h^2

    Needs k >= 2."""
    if k < 2:
        raise ValueError("second derivatives need spline degree k >= 2")
    lo, hi = GRID_RANGE
    h = (hi - lo) / grid
    t = _knots(grid, k, x.dtype, x.device)
    xe = x[..., None]
    b = ((xe >= t[:-1]) & (xe < t[1:])).to(x.dtype)
    b_k2 = b if k == 2 else None
    b_k1 = None
    for d in range(1, k + 1):
        left = (xe - t[: -(d + 1)]) / (t[d:-1] - t[: -(d + 1)]) * b[..., :-1]
        right = (t[d + 1:] - xe) / (t[d + 1:] - t[1:-d]) * b[..., 1:]
        b = left + right
        if d == k - 2:
            b_k2 = b
        elif d == k - 1:
            b_k1 = b
    db = (b_k1[..., :-1] - b_k1[..., 1:]) / h
    d2b = (b_k2[..., :-2] - 2.0 * b_k2[..., 1:-1] + b_k2[..., 2:]) / (h * h)
    return b, db, d2b


def init_kan(width: Sequence[int], generator: torch.Generator, grid: int = 5,
             k: int = 3) -> KanParams:
    """Per-layer (coef, w_base, w_sp) with the JAX package's shapes and
    scales, float32: coef ~ N(0, 1) * NOISE_SCALE / grid, w_base ~ U(+-sqrt(6 / (in +
    out))), w_sp = 1. Drawn on the CPU from `generator`, layer by layer,
    coef before w_base; JAX draws from jax.random, so one seed gives other
    numbers there (tests carry weights across with models/convert.py)."""
    params = []
    for fan_in, fan_out in zip(width[:-1], width[1:]):
        coef = (NOISE_SCALE / grid) * torch.randn((fan_in, fan_out, grid + k),
                                                  generator=generator)
        limit = (6.0 / (fan_in + fan_out)) ** 0.5
        w_base = torch.rand((fan_in, fan_out), generator=generator) \
            * (2 * limit) - limit
        params.append((coef, w_base, torch.ones((fan_in, fan_out))))
    return tuple(params)


def kan_layer_apply(layer: KanLayerParams, x: torch.Tensor, grid: int, k: int) -> torch.Tensor:
    coef, w_base, w_sp = layer
    basis = bspline_basis(x, grid, k)                        # [N, in, n_basis]
    spline = torch.einsum("nib,iob->nio", basis, coef)       # [N, in, out]
    base = x * torch.sigmoid(x)                              # silu, [N, in]
    phi = w_base[None] * base[..., None] + w_sp[None] * spline
    return phi.sum(dim=1)                                    # [N, out]


def kan_apply(params: KanParams, x: torch.Tensor, grid: int = 5, k: int = 3) -> torch.Tensor:
    h = x
    for layer in params:
        h = kan_layer_apply(layer, h, grid, k)
    return h


def kan_leaf_shapes(width: Sequence[int], grid: int, k: int):
    """((coef shape, w_base shape, w_sp shape), ...) per layer."""
    return tuple(((i, o, grid + k), (i, o), (i, o)) for i, o in zip(width[:-1], width[1:]))


def flatten_kan(params: KanParams) -> torch.Tensor:
    """coef0, w_base0, w_sp0, coef1, ... as one flat vector."""
    return torch.cat([t.reshape(-1) for layer in params for t in layer])


def unflatten_kan(flat: torch.Tensor, width: Sequence[int], grid: int, k: int) -> KanParams:
    """Views of a flat vector in the (coef, w_base, w_sp) layout."""
    out, off = [], 0
    for shapes in kan_leaf_shapes(width, grid, k):
        layer = []
        for shape in shapes:
            n = 1
            for s in shape:
                n *= s
            layer.append(flat[off:off + n].view(shape))
            off += n
        out.append(tuple(layer))
    if off != flat.numel():
        raise ValueError(f"flat vector has {flat.numel()} entries; KAN width "
                         f"{tuple(width)}, grid {grid}, k {k} needs {off}")
    return tuple(out)


class KAN(nn.Module):
    """A KAN whose parameters live in one flat parameter (`self.flat`); the
    notebook's defaults: width [2, 16, 16, 8], grid 5, k 3."""

    def __init__(self, width: Sequence[int] = (2, 16, 16, 8), grid: int = 5, k: int = 3,
                 generator: torch.Generator | None = None,
                 device: torch.device | str = "cpu"):
        super().__init__()
        self.width = tuple(int(w) for w in width)
        self.grid, self.k = int(grid), int(k)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        flat = flatten_kan(init_kan(self.width, gen, self.grid, self.k))
        self.flat = nn.Parameter(flat.to(device))

    def leaf_shapes(self):
        return kan_leaf_shapes(self.width, self.grid, self.k)

    def unflatten(self, flat: torch.Tensor) -> KanParams:
        return unflatten_kan(flat, self.width, self.grid, self.k)

    def params(self) -> KanParams:
        return self.unflatten(self.flat)

    def apply_params(self, params: KanParams, x: torch.Tensor) -> torch.Tensor:
        return kan_apply(params, x, self.grid, self.k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply_params(self.params(), x)
