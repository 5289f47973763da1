"""The inputs of a run, made from `--seed` on the device: the cavity's
collocation points with their SDF weights, its boundary points, and the
weights of both nets. The program and the reference are handed the same
tensors; neither makes its own.

The distributions are the reference data loader's (ev-NSFnet/cavity_data.py):
a Latin-Hypercube draw on the unit square, SDF weights min_w + (1 - min_w)
exp(-decay d) normalised to mean 1, 513 boundary points an edge with the
regularised lid u = 1 - cosh(10 (x - 1/2)) / cosh(5), and nn.Linear's
U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for every weight and bias.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from benchmark.flops import mlp_sizes, param_count

POINTS_PER_EDGE = 513
LID_REG = 10.0

Params = Tuple[Tuple[torch.Tensor, torch.Tensor], ...]


class Inputs(NamedTuple):
    x_f: torch.Tensor  # [N_f, 1] float32
    y_f: torch.Tensor
    w_f: torch.Tensor  # SDF weights, mean 1
    x_b: torch.Tensor  # [4 * 513, 1]
    y_b: torch.Tensor
    u_b: torch.Tensor
    v_b: torch.Tensor
    params: Params      # main net, (W[fan_in, fan_out], b[fan_out]) per layer
    params_evm: Params  # EVM net


def _latin_hypercube(n: int, g: torch.Generator, device) -> torch.Tensor:
    """[n, 2] float64: one uniform draw in each of n strata per axis, the
    strata of each axis in a random order."""
    u = (torch.arange(n, device=device, dtype=torch.float64)[:, None]
         + torch.rand((n, 2), generator=g, device=device, dtype=torch.float64)) / n
    cols = [u[torch.randperm(n, generator=g, device=device), j] for j in range(2)]
    return torch.stack(cols, dim=1)


def _sdf_weights(pts: torch.Tensor, min_w: float, decay: float) -> torch.Tensor:
    d = torch.minimum(torch.minimum(pts[:, 0], 1.0 - pts[:, 0]),
                      torch.minimum(pts[:, 1], 1.0 - pts[:, 1])).clamp(min=0.0)
    w = min_w + (1.0 - min_w) * torch.exp(-decay * d)
    return w / w.mean()


def _boundary(device):
    n = POINTS_PER_EDGE
    line = np.linspace(0.0, 1.0, n)
    lid = 1.0 - np.cosh(LID_REG * (line - 0.5)) / np.cosh(LID_REG * 0.5)
    x_b = np.concatenate([line, line, np.zeros(n), np.ones(n)])
    y_b = np.concatenate([np.zeros(n), np.ones(n), line, line])
    u_b = np.concatenate([np.zeros(n), lid, np.zeros(n), np.zeros(n)])
    col = lambda a: torch.from_numpy(a.reshape(-1, 1).astype(np.float32)).to(device)
    return col(x_b), col(y_b), col(u_b), col(np.zeros_like(x_b))


def _weights(sizes: Sequence[int], g: torch.Generator, device) -> Params:
    """One uniform draw for the whole net, cut into its layers."""
    u = torch.rand(param_count(sizes), generator=g, device=device, dtype=torch.float32)
    out, off = [], 0
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        k = 1.0 / fan_in ** 0.5
        w = (u[off:off + fan_in * fan_out] * (2 * k) - k).view(fan_in, fan_out)
        off += fan_in * fan_out
        b = u[off:off + fan_out] * (2 * k) - k
        off += fan_out
        out.append((w, b))
    return tuple(out)


def make_inputs(app: dict, seed: int, device, n_f: int = None) -> Inputs:
    """The inputs of a run of the configuration `app` (its `app_config`),
    drawn from `seed` on `device`; `n_f` overrides the collocation count
    (tests at small sizes)."""
    net, tr = app["network"], app["training"]
    sdf = tr["sdf_weighting"]
    n = int(tr["N_f"] if n_f is None else n_f)
    g = torch.Generator(device=device).manual_seed(int(seed))
    pts = _latin_hypercube(n, g, device)
    if sdf["enabled"]:
        w = _sdf_weights(pts, float(sdf["min_weight"]), float(sdf["decay"]))
    else:
        w = torch.ones(n, device=device, dtype=torch.float64)
    col = lambda a: a.reshape(-1, 1).to(torch.float32).contiguous()
    params = _weights(mlp_sizes(net["layers"], net["hidden_size"]), g, device)
    params_evm = _weights(mlp_sizes(net["layers_1"], net["hidden_size_1"], n_out=1), g, device)
    return Inputs(col(pts[:, 0]), col(pts[:, 1]), col(w), *_boundary(device),
                  params, params_evm)
