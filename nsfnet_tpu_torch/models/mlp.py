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

The random Fourier input embedding (nsfnet_tpu/models/mlp.py:71-92,
130-159): with `fourier_features` m > 0 the net sees [x, sin(2 pi x B),
cos(2 pi x B)], so its layer sizes start at num_ins + 2m. B is fixed, not
trained, and is rebuilt from (num_ins, m, sigma, seed) alone, so that a
checkpoint stays a plain (W, b) tuple. To keep a JAX checkpoint of a
Fourier net the same function here, `fourier_b_matrix` reproduces the JAX
package's draw, `sigma * jax.random.normal(jax.random.PRNGKey(seed),
(num_ins, m), float32)`, in numpy: the threefry-2x32 stream in the
partitionable layout (`jax_threefry_partitionable` True, the default since
JAX 0.5; checked against JAX 0.9.0), the uniform on [nextafter(-1, 0), 1)
from `bits >> 9 | 0x3F800000`, then sqrt(2) erfinv(u) by XLA's float32
polynomial (Giles) with its fused multiply-adds. Against JAX 0.9.0 on the
CPU the uniform bits are equal and B agrees bitwise at most entries and
within an ulp at the rest.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

Params = Tuple[Tuple[torch.Tensor, torch.Tensor], ...]

FOURIER_SEED = 0  # the JAX package's fourier_seed default; no config sets another


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


def _rotl32(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: Tuple[int, int], x0: np.ndarray, x1: np.ndarray):
    """The 20-round threefry-2x32 block of JAX's PRNG on uint32 arrays."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, np.uint32(k0 ^ k1 ^ np.uint32(0x1BD11BDA)))
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    with np.errstate(over="ignore"):
        x0, x1 = x0 + ks[0], x1 + ks[1]
        for i in range(5):
            for r in rotations[i % 2]:
                x0 = x0 + x1
                x1 = _rotl32(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def jax_random_bits32(seed: int, shape: Sequence[int]) -> np.ndarray:
    """`jax.random.bits(jax.random.PRNGKey(seed), shape, uint32)` under the
    partitionable threefry layout: each flat index i hashed as the counter
    pair (i >> 32, i & 0xFFFFFFFF) under the key (seed >> 32, seed &
    0xFFFFFFFF), the two output words xor-ed."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry2x32(((seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF), hi, lo)
    return (b0 ^ b1).reshape(tuple(shape))


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _erfinv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 erfinv (Giles' polynomial in w = -log1p(-x^2)); each
    Horner step a fused multiply-add, emulated by one rounding of the
    float64 product-sum."""
    x = x.astype(np.float32)
    w = -np.log1p(-x * x)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = np.where(lt, np.float32(a), np.float32(b))
        p = (p.astype(np.float64) * w + c).astype(np.float32)
    return np.where(np.abs(x) == 1, x * np.finfo(np.float32).max, p * x).astype(np.float32)


def jax_random_normal32(seed: int, shape: Sequence[int]) -> np.ndarray:
    """`jax.random.normal(jax.random.PRNGKey(seed), shape, float32)`."""
    bits = jax_random_bits32(seed, shape)
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo, hi = np.nextafter(np.float32(-1.0), np.float32(0.0)), np.float32(1.0)
    u = np.maximum(lo, f * (hi - lo) + lo)
    return np.float32(np.sqrt(2.0)) * _erfinv_f32(u)


def fourier_b_matrix(num_ins: int, num_features: int, sigma: float,
                     seed: int = FOURIER_SEED) -> torch.Tensor:
    """The fixed random Fourier projection B ~ N(0, sigma^2) [num_ins, m] of
    the JAX package, float32 (the embedding casts it to the points' dtype)."""
    b = np.float32(sigma) * jax_random_normal32(int(seed), (num_ins, num_features))
    return torch.from_numpy(b.astype(np.float32))


def fourier_embed(x: torch.Tensor, b_matrix: torch.Tensor) -> torch.Tensor:
    """[x, sin(2 pi x B), cos(2 pi x B)] (Tancik et al.)."""
    proj = (2.0 * np.pi) * (x @ b_matrix)
    return torch.cat([x, torch.sin(proj), torch.cos(proj)], dim=1)


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
    num_layers, hidden_size), ev-NSFnet/net.py:23-27); `fourier_features`
    m > 0 puts the random Fourier embedding in front (B in the buffer
    `b_matrix`, not a parameter)."""

    def __init__(self, num_ins: int, num_outs: int,
                 num_layers: int, hidden_size: int, generator: torch.Generator,
                 device: torch.device | str = "cpu", fourier_features: int = 0,
                 fourier_sigma: float = 3.0):
        super().__init__()
        self.fourier_features = int(fourier_features)
        self.fourier_sigma = float(fourier_sigma)
        self.sizes = layer_sizes(num_ins + 2 * self.fourier_features, num_outs,
                                 num_layers, hidden_size)
        flat = flatten_params(init_mlp(self.sizes, generator))
        self.flat = nn.Parameter(flat.to(device))
        self.register_buffer("b_matrix", fourier_b_matrix(
            num_ins, self.fourier_features, self.fourier_sigma).to(device)
            if self.fourier_features else None)

    def leaf_shapes(self):
        """((W shape, b shape), ...) per layer."""
        return tuple(((i, o), (o,)) for i, o in zip(self.sizes[:-1], self.sizes[1:]))

    def unflatten(self, flat: torch.Tensor) -> Params:
        return unflatten_params(flat, self.sizes)

    def params(self) -> Params:
        return self.unflatten(self.flat)

    def apply_params(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        if self.b_matrix is not None:
            x = fourier_embed(x, self.b_matrix.to(x.dtype))
        return mlp_apply(params, x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply_params(self.params(), x)
