"""Fused residual-loss engine: the hand-written CUDA kernel pair and its
plain PyTorch version.

The port of nsfnet_tpu/ops/pallas_residual.py. One call computes

    x -> packed MLP forward -> (u,v,p) Taylor streams -> eq1..eq4
      -> per-equation weighted sums S_i = sum(eq_w * eq_i^2)

and its gradient wrt the main-net parameters and the EVM output e:

  * kernel 1, `fused_fwd`: csrc/fused_residual.cu loss_fwd_kernel, which
    replaces `_loss_fwd_kernel` (pallas_residual.py:100);
  * kernel 2, `fused_bwd`: loss_bwd_kernel, which replaces
    `_loss_bwd_kernel` (pallas_residual.py:128).

The CUDA source says what bounds them (operations) and how the design
deals with the TPU kernels' sequential-grid accumulation (fixed block
count, per-block partials, an ordered second pass: bitwise deterministic).

`fused_residual_loss` is the entry point. On a CPU tensor it runs
`plain_residual_sums` (closed-form derivative engine -> residuals -> masked
sums, differentiated by autograd); on a CUDA tensor it launches the kernel
pair through `_FusedResidualLoss`, or raises. x, vis_t, eq_w and Re get no
gradient: they are optimization constants (collocation points, the lagged
eddy viscosity, the SDF weights, the stage Reynolds number).

Every precision name of the JAX package ("highest", "high", "default") is
accepted so configs run unchanged; the kernels compute exact fp32 for all
three. Tensor-core passes are later work.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from nsfnet_tpu_torch.models.mlp import Params, param_count, unflatten_params
from nsfnet_tpu_torch.ops import _build
from nsfnet_tpu_torch.ops import losses as L
from nsfnet_tpu_torch.ops import residuals as R
from nsfnet_tpu_torch.ops.derivatives import mlp_derivatives_2d

PRECISIONS = ("highest", "high", "default")
ROW_ALIGN = 16         # batches are padded to this; every tile size divides it
PARTIAL_BLOCKS = 264   # fixed grid = number of partials: fixes the summation order
_TILES = (16, 8, 4, 2, 1)
_MAX_SMEM = 232_448    # bytes of shared memory a block may use on sm_90

# Launches of each kernel since the last reset; the wrappers add one per launch.
launch_counts = {"fused_residual_fwd": 0, "fused_residual_bwd": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def smem_bytes(tile: int, h: int, k: int = 3) -> int:
    """Shared memory of one block, for choosing the tile without the library;
    the source's nsf_fused_loss_smem_bytes owns the layout and must agree
    (tests/test_torch_gpu.py checks every tile). _MAX_SMEM is its kMaxSmem."""
    return 4 * (10 * tile * h + h * (h + 1) + 4 * tile + 5 * tile * k)


def pick_tile(h: int, k: int = 3) -> int:
    """Largest tile (at most 16 points) whose block fits in shared memory.
    At the flagship width 16 points take 78 KB: two blocks per SM."""
    for t in _TILES:
        if smem_bytes(t, h, k) <= _MAX_SMEM:
            return t
    raise ValueError(f"hidden width {h} does not fit the kernel's shared memory")


def flop_counts(sizes: Sequence[int], n: int) -> Tuple[int, int]:
    """Matrix-product FLOPs of kernel 1 and kernel 2 on n points (the
    elementwise tanh / residual algebra, a few percent, is left out, so
    these give lower bounds on the time)."""
    n_hidden, h, k = len(sizes) - 2, sizes[1], sizes[-1]
    hidden = (n_hidden - 1) * 5 * 2 * h * h
    head = 5 * 2 * h * k
    return n * (hidden + head), n * 3 * (hidden + head)


def byte_counts(sizes: Sequence[int], n: int, evm: bool) -> Tuple[int, int]:
    """Bytes kernel 1 and kernel 2 must move: each input read once, each
    output written once."""
    p = param_count(sizes)
    n_out = 4 if evm else 3
    per_point = (2 + (3 if evm else 1)) * 4
    fwd = n * per_point + 4 * p + 4 * n_out
    bwd = n * per_point + 4 * p + 4 * n_out + 4 * p + (4 * n if evm else 0)
    return fwd, bwd


def plain_residual_sums(params: Params, x: torch.Tensor, e: Optional[torch.Tensor],
                        vis_t: Optional[torch.Tensor], eq_w: torch.Tensor, re: float,
                        coord_scale: float = 1.0, evm: bool = True) -> torch.Tensor:
    """The plain PyTorch version of the kernel pair: S_i = sum(eq_w * eq_i^2),
    [4] (EVM) or [3] (vanilla). Its gradient is autograd's."""
    derivs = mlp_derivatives_2d(params, x)
    if evm:
        res = R.ev_ns_residuals(derivs, e, vis_t, re, coord_scale)
        eqs = (res.eq1, res.eq2, res.eq3, res.eq4)
    else:
        res = R.ns_residuals(derivs, re, coord_scale)
        eqs = (res.eq1, res.eq2, res.eq3)
    return torch.stack([L.masked_sum_sq(eq, eq_w) for eq in eqs])


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_residual")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    common = [p, p, p, p, p, i, i, i, i, i, i, f, f, i]
    lib.nsf_fused_loss_fwd.argtypes = common + [p, p, p]
    lib.nsf_fused_loss_fwd.restype = i
    lib.nsf_fused_loss_bwd.argtypes = common + [p, p, p, p, p, p]
    lib.nsf_fused_loss_bwd.restype = i
    lib.nsf_fused_loss_smem_bytes.argtypes = [i, i, i]
    lib.nsf_fused_loss_smem_bytes.restype = i
    lib.nsf_fused_loss_scratch_floats.argtypes = [i, i, i]
    lib.nsf_fused_loss_scratch_floats.restype = ctypes.c_long
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_inputs(flat, sizes, x, e, vis_t, eq_w, evm):
    n = x.shape[0]
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {x.device}")
    if sizes[-1] != 3 or sizes[0] != 2 or len(set(sizes[1:-1])) != 1:
        raise ValueError(f"the kernel takes a 2 -> H x L -> 3 MLP, got {tuple(sizes)}")
    streams = [eq_w] + ([e, vis_t] if evm else [])
    for name, t, shape in [("flat", flat, (param_count(sizes),)), ("x", x, (n, 2))] + [
            ("stream", s, (n, 1)) for s in streams]:
        if t is None or t.dtype != torch.float32 or t.device != x.device \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: need contiguous float32 {shape} on {x.device}")
    tile = pick_tile(sizes[1], sizes[-1])
    if n % tile != 0:
        raise ValueError(f"batch {n} must be padded to a multiple of {ROW_ALIGN}")
    return n, tile


def _launch_args(flat, sizes, x, e, vis_t, eq_w, re, scale, evm, tile):
    n_hidden = len(sizes) - 2
    return [_ptr(x), _ptr(flat), _ptr(e) if evm else None, _ptr(vis_t) if evm else None,
            _ptr(eq_w), x.shape[0], n_hidden, sizes[1], sizes[-1], tile, PARTIAL_BLOCKS,
            float(re), float(scale), int(evm)]


def _raise_on(code: int, what: str):
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def fused_fwd(flat: torch.Tensor, sizes: Sequence[int], x: torch.Tensor,
              e: Optional[torch.Tensor], vis_t: Optional[torch.Tensor],
              eq_w: torch.Tensor, re: float, scale: float, evm: bool) -> torch.Tensor:
    """Kernel 1: the [3|4] weighted sums of squares."""
    e = e.contiguous() if evm else None
    n, tile = _check_inputs(flat, sizes, x, e, vis_t, eq_w, evm)
    partial = torch.empty(PARTIAL_BLOCKS * 4, dtype=torch.float32, device=x.device)
    out = torch.empty(4 if evm else 3, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = _lib().nsf_fused_loss_fwd(
            *_launch_args(flat, sizes, x, e, vis_t, eq_w, re, scale, evm, tile),
            _ptr(partial), _ptr(out), stream)
    _raise_on(code, "fused residual loss forward")
    launch_counts["fused_residual_fwd"] += 1
    return out


def fused_bwd(flat: torch.Tensor, sizes: Sequence[int], x: torch.Tensor,
              e: Optional[torch.Tensor], vis_t: Optional[torch.Tensor],
              eq_w: torch.Tensor, re: float, ct: torch.Tensor, scale: float,
              evm: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Kernel 2: (d(ct . S)/dflat, d(ct . S)/de) — the latter None if vanilla."""
    e = e.contiguous() if evm else None
    n, tile = _check_inputs(flat, sizes, x, e, vis_t, eq_w, evm)
    n_out = 4 if evm else 3
    ct = ct.to(device=x.device, dtype=torch.float32).contiguous().reshape(-1)
    if ct.numel() != n_out:
        raise ValueError(f"ct: need {n_out} cotangents, got {ct.numel()}")
    p = param_count(sizes)
    dev = x.device
    block_floats = _lib().nsf_fused_loss_scratch_floats(tile, sizes[1], len(sizes) - 2)
    scratch = torch.empty(PARTIAL_BLOCKS * block_floats, dtype=torch.float32, device=dev)
    dpart = torch.empty(PARTIAL_BLOCKS * p, dtype=torch.float32, device=dev)
    dflat = torch.empty(p, dtype=torch.float32, device=dev)
    g_e = torch.empty((n, 1), dtype=torch.float32, device=dev) if evm else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = _lib().nsf_fused_loss_bwd(
            *_launch_args(flat, sizes, x, e, vis_t, eq_w, re, scale, evm, tile),
            _ptr(ct), _ptr(scratch), _ptr(dpart), _ptr(dflat), _ptr(g_e), stream)
    _raise_on(code, "fused residual loss backward")
    launch_counts["fused_residual_bwd"] += 1
    return dflat, g_e


class _FusedResidualLoss(torch.autograd.Function):
    """Kernel 1 forward, kernel 2 backward (the custom_vjp of
    pallas_residual.py:302-310). Gradients flow to flat and e only."""

    @staticmethod
    def forward(ctx, flat, x, e, vis_t, eq_w, re, sizes, scale, evm):
        ctx.save_for_backward(flat, x, e, vis_t, eq_w)
        ctx.meta = (re, sizes, scale, evm)
        return fused_fwd(flat, sizes, x, e, vis_t, eq_w, re, scale, evm)

    @staticmethod
    def backward(ctx, ct):
        flat, x, e, vis_t, eq_w = ctx.saved_tensors
        re, sizes, scale, evm = ctx.meta
        dflat, g_e = fused_bwd(flat, sizes, x, e, vis_t, eq_w, re, ct, scale, evm)
        return dflat, None, g_e, None, None, None, None, None, None


def fused_residual_loss(flat: torch.Tensor, sizes: Sequence[int], x: torch.Tensor,
                        e: Optional[torch.Tensor], vis_t: Optional[torch.Tensor],
                        eq_w: torch.Tensor, re: float, *, coord_scale: float = 1.0,
                        evm: bool = True, precision: str = "high") -> torch.Tensor:
    """S_i = sum(eq_w * eq_i^2) for the MLP whose flat weights are `flat`
    (models/mlp.py layout, `sizes` its layer sizes); [4] with EVM, [3]
    vanilla (pass e = vis_t = None). Divide by the real-point count for the
    per-equation mean losses. The batch must be padded to ROW_ALIGN rows,
    with eq_w = 0 on pad rows."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; one of {PRECISIONS}")
    if x.device.type == "cpu":
        return plain_residual_sums(unflatten_params(flat, sizes), x, e, vis_t, eq_w,
                                   re, coord_scale, evm)
    return _FusedResidualLoss.apply(flat, x, e, vis_t, eq_w, float(re), tuple(sizes),
                                    float(coord_scale), bool(evm))
