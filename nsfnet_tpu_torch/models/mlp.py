"""Fully-connected tanh network (the PINN backbone).

The port of nsfnet_tpu/models/mlp.py: a `[num_ins] + [hidden]*num_layers +
[num_outs]` stack of Linear+Tanh with a linear head, initialized like
torch.nn.Linear (uniform ±1/sqrt(fan_in) for weight and bias), as the
reference FCNet (ev-NSFnet/net.py:22-54).

The public functions keep the JAX package's layout: params are a tuple of
(W[fan_in, fan_out], b[fan_out]) pairs. The `MLP` module stores all of them
in ONE flat parameter vector and hands out views in that layout. The flat
vector is what the fused kernel reads, what its backward writes, and what
Adam updates with a handful of whole-vector operations per step.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

Params = Tuple[Tuple[torch.Tensor, torch.Tensor], ...]


def layer_sizes(num_ins: int, num_outs: int, num_layers: int,
                hidden_size: int) -> Tuple[int, ...]:
    """Mirror of the reference layer-size recipe (ev-NSFnet/net.py:30)."""
    return tuple([num_ins] + [hidden_size] * num_layers + [num_outs])


def init_mlp(sizes: Sequence[int], generator: torch.Generator,
             dtype=torch.float32) -> Params:
    """U(-k, k) with k = 1/sqrt(fan_in) for W and b, drawn on the CPU from
    `generator` (so a seed gives the same weights on every device), layer
    by layer, W before b. The JAX package draws from jax.random, so the two
    give different weights for one seed; tests carry weights across with
    models/convert.py instead."""
    params = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        bound = 1.0 / fan_in ** 0.5
        w = torch.rand((fan_in, fan_out), generator=generator, dtype=dtype)
        b = torch.rand((fan_out,), generator=generator, dtype=dtype)
        params.append((w * (2 * bound) - bound, b * (2 * bound) - bound))
    return tuple(params)


def mlp_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Forward pass: tanh on all layers except the linear head.
    x: [N, num_ins] -> [N, num_outs]."""
    h = x
    for w, b in params[:-1]:
        h = torch.tanh(h @ w + b)
    w, b = params[-1]
    return h @ w + b


def widen_mlp_params(params: Params, new_hidden: int, generator: torch.Generator,
                     scale: float = 1e-2) -> Params:
    """Function-preserving width increase (Net2Net; nsfnet_tpu/models/mlp.py:98).

    The old blocks are copied; new hidden units get N(0, scale^2) incoming
    weights drawn on the CPU from `generator` (so they carry distinct
    activations from the first step) and exactly zero weights out to the
    old units and the head (the [fi:, :fo] block), so the widened net
    computes the donor's function. New biases are zero."""
    out = []
    for li, (w, b) in enumerate(params):
        fi, fo = w.shape
        nfi = fi if li == 0 else new_hidden
        nfo = fo if li == len(params) - 1 else new_hidden
        W = torch.zeros((nfi, nfo), dtype=w.dtype)
        W[:fi, :fo] = w.detach().cpu()
        if nfo > fo:
            W[:fi, fo:] = scale * torch.randn((fi, nfo - fo), generator=generator, dtype=w.dtype)
            if nfi > fi:
                W[fi:, fo:] = scale * torch.randn((nfi - fi, nfo - fo), generator=generator,
                                                  dtype=w.dtype)
        B = torch.zeros((nfo,), dtype=b.dtype)
        B[:fo] = b.detach().cpu()
        out.append((W.to(w.device), B.to(b.device)))
    return tuple(out)


def param_count(sizes: Sequence[int]) -> int:
    return sum(i * o + o for i, o in zip(sizes[:-1], sizes[1:]))


def flatten_params(params: Params) -> torch.Tensor:
    """Concatenate (W, b) pairs into one flat vector: W0, b0, W1, b1, ..."""
    return torch.cat([t.reshape(-1) for pair in params for t in pair])


def unflatten_params(flat: torch.Tensor, sizes: Sequence[int]) -> Params:
    """Views of a flat vector in the (W[fan_in, fan_out], b) layout."""
    out, off = [], 0
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        w = flat[off:off + fan_in * fan_out].view(fan_in, fan_out)
        off += fan_in * fan_out
        b = flat[off:off + fan_out]
        off += fan_out
        out.append((w, b))
    if off != flat.numel():
        raise ValueError(f"flat vector has {flat.numel()} entries; "
                         f"sizes {tuple(sizes)} need {off}")
    return tuple(out)


class MLP(nn.Module):
    """A tanh MLP whose weights live in one flat parameter (`self.flat`).

    Matches the reference constructor semantics (FCNet(num_ins, num_outs,
    num_layers, hidden_size), ev-NSFnet/net.py:23-27)."""

    def __init__(self, num_ins: int, num_outs: int,
                 num_layers: int, hidden_size: int, generator: torch.Generator,
                 device: torch.device | str = "cpu"):
        super().__init__()
        self.sizes = layer_sizes(num_ins, num_outs, num_layers, hidden_size)
        flat = flatten_params(init_mlp(self.sizes, generator))
        self.flat = nn.Parameter(flat.to(device))

    def params(self) -> Params:
        return unflatten_params(self.flat, self.sizes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_apply(self.params(), x)
