"""Order-3 streamfunction derivative engine: the hand-written CUDA kernel
pair and its plain PyTorch version.

The port of nsfnet_tpu/ops/pallas_psi.py. For a tanh MLP 2 -> H (x L) -> K
and points x[N,2], one call computes the thirteen raw [N,K] Taylor streams

    [o | a_x a_y a_p a_m | b_x b_y b_p b_m | c_x c_y c_p c_m]

(the value and the order-1/2/3 directional derivatives along e_x, e_y,
(1,1), (1,-1)), and its backward turns thirteen [N,K] cotangents into the
gradient wrt the flat weights:

  * kernel 5, `psi_fwd`: csrc/psi_streams.cu psi_fwd_kernel, which replaces
    `_fwd_kernel` (pallas_psi.py:176);
  * kernel 6, `psi_bwd`: psi_bwd_kernel, which replaces `_bwd_kernel`
    (pallas_psi.py:223).

`psi_streams` is the entry point of the streamfunction formulation (the net
outputs (psi, p); u = psi_y, v = -psi_x, continuity exact): it returns the
(u, v, p) `Derivs` bundle, assembled from the raw streams in plain PyTorch
outside the kernel, as the JAX package does (pallas_psi.py:373-380). On a
CPU tensor it runs `plain_psi_streams` (the closed-form engine,
differentiated by autograd); on anything else it launches the kernel pair
through `_PsiStreams`, or raises. x gets no gradient: collocation points
are optimization constants (pallas_psi.py:367-369).

The tile comes from this card's shared memory (`pick_tile` here: the packed
carries are 13/5 the size of the five-stream engine's), not from the TPU
kernels' VMEM budgets (`fwd_tile_for_psi` / `bwd_tile_for_psi`) or their
NSFNET_PALLAS_PSI_*_TILE knobs. Every tile divides ROW_ALIGN, so the
solver's padding is that of the other engines. Every precision name of the
JAX package is accepted and computes exact fp32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from nsfnet_tpu_torch.models.mlp import param_count, unflatten_params
from nsfnet_tpu_torch.ops import _build, mlp_streams
from nsfnet_tpu_torch.ops.derivatives import (N_PSI_STREAMS, Derivs, assemble_psi_bundle,
                                              mlp_psi_streams)
from nsfnet_tpu_torch.ops.fused_residual import (_MAX_SMEM, _TILES, PARTIAL_BLOCKS, PRECISIONS,
                                                 _raise_on)
from nsfnet_tpu_torch.ops.mlp_streams import _check_inputs, _launch_args

# Launches of each kernel since the last reset; the wrappers add one per launch.
launch_counts = {"psi_streams_fwd": 0, "psi_streams_bwd": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def smem_bytes(tile: int, h: int, k: int = 2) -> int:
    """Shared memory of one block (two [13][T][H] carries, the staged weight,
    the [13][T][K] head block), for choosing the tile without the library;
    the source's nsf_psi_streams_smem_bytes owns the layout and must agree
    (tests/test_torch_gpu.py checks every tile)."""
    return 4 * (2 * N_PSI_STREAMS * tile * h + h * (h + 1) + N_PSI_STREAMS * tile * k)


def pick_tile(h: int, k: int = 2) -> int:
    """Largest tile (at most 16 points) whose block fits in shared memory:
    16 points up to H = 109 (161 KB at H = 80: one block per SM), 8 from
    H = 110 (159 KB at H = 120)."""
    for t in _TILES:
        if smem_bytes(t, h, k) <= _MAX_SMEM:
            return t
    raise ValueError(f"hidden width {h} does not fit the kernel's shared memory")


def flop_counts(sizes: Sequence[int], n: int) -> Tuple[int, int]:
    """Matrix-product FLOPs of kernel 5 and kernel 6 on n points: the
    five-stream engine's count with thirteen streams (the elementwise tanh
    algebra is left out, so these give lower bounds on the time)."""
    return mlp_streams.flop_counts(sizes, n, N_PSI_STREAMS)


def byte_counts(sizes: Sequence[int], n: int) -> Tuple[int, int]:
    """Bytes kernel 5 and kernel 6 must move: each input read once, each
    output written once."""
    return mlp_streams.byte_counts(sizes, n, N_PSI_STREAMS)


def plain_psi_streams(flat: torch.Tensor, sizes: Sequence[int],
                      x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The plain PyTorch version of kernel 5: the thirteen raw streams by the
    closed form on the unflattened weights."""
    return mlp_psi_streams(unflatten_params(flat, sizes), x)


def plain_psi_streams_bwd(flat: torch.Tensor, sizes: Sequence[int], x: torch.Tensor,
                          cts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The plain PyTorch version of kernel 6: autograd's gradient of
    sum_q <cts[q], stream_q> wrt the flat weights."""
    flat = flat.detach().requires_grad_(True)
    with torch.enable_grad():
        streams = plain_psi_streams(flat, sizes, x)
    return torch.autograd.grad(streams, [flat], list(cts))[0]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("psi_streams")
    p, i = ctypes.c_void_p, ctypes.c_int
    common = [p, p, i, i, i, i, i, i]
    lib.nsf_psi_streams_fwd.argtypes = common + [ctypes.POINTER(p), p]
    lib.nsf_psi_streams_fwd.restype = i
    lib.nsf_psi_streams_bwd.argtypes = common + [ctypes.POINTER(p), p, p, p, p]
    lib.nsf_psi_streams_bwd.restype = i
    lib.nsf_psi_streams_smem_bytes.argtypes = [i, i, i]
    lib.nsf_psi_streams_smem_bytes.restype = i
    lib.nsf_psi_streams_scratch_floats.argtypes = [i, i, i]
    lib.nsf_psi_streams_scratch_floats.restype = ctypes.c_long
    return lib


def _pointers(tensors):
    return (ctypes.c_void_p * N_PSI_STREAMS)(*(t.data_ptr() for t in tensors))


def psi_fwd(flat: torch.Tensor, sizes: Sequence[int],
            x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Kernel 5: the thirteen raw [N,K] streams."""
    n, tile = _check_inputs(flat, sizes, x, pick_tile=pick_tile)
    out = tuple(torch.empty((n, sizes[-1]), dtype=torch.float32, device=x.device)
                for _ in range(N_PSI_STREAMS))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = _lib().nsf_psi_streams_fwd(*_launch_args(flat, sizes, x, tile),
                                          _pointers(out), stream)
    _raise_on(code, "psi streams forward")
    launch_counts["psi_streams_fwd"] += 1
    return out


def psi_bwd(flat: torch.Tensor, sizes: Sequence[int], x: torch.Tensor,
            cts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Kernel 6: the gradient wrt the flat weights from thirteen [N,K] cotangents."""
    if len(cts) != N_PSI_STREAMS:
        raise ValueError(f"need the {N_PSI_STREAMS} streams' cotangents, got {len(cts)}")
    n, tile = _check_inputs(flat, sizes, x, cts, pick_tile)
    p, dev = param_count(sizes), x.device
    block_floats = _lib().nsf_psi_streams_scratch_floats(tile, sizes[1], len(sizes) - 2)
    scratch = torch.empty(PARTIAL_BLOCKS * block_floats, dtype=torch.float32, device=dev)
    dpart = torch.empty(PARTIAL_BLOCKS * p, dtype=torch.float32, device=dev)
    dflat = torch.empty(p, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = _lib().nsf_psi_streams_bwd(*_launch_args(flat, sizes, x, tile), _pointers(cts),
                                          scratch.data_ptr(), dpart.data_ptr(),
                                          dflat.data_ptr(), stream)
    _raise_on(code, "psi streams backward")
    launch_counts["psi_streams_bwd"] += 1
    return dflat


class _PsiStreams(torch.autograd.Function):
    """Kernel 5 forward, kernel 6 backward (the custom_vjp of
    pallas_psi.py:360-371). Gradients flow to flat only. The bundle never
    reads a_p and a_m, and p has no second or third derivatives, so several
    cotangents arrive as zeros (autograd materialises them) or scattered
    from column slices: each is made contiguous fp32 before the kernel
    reads it."""

    @staticmethod
    def forward(ctx, flat, x, sizes):
        ctx.save_for_backward(flat, x)
        ctx.sizes = sizes
        return psi_fwd(flat, sizes, x)

    @staticmethod
    def backward(ctx, *cts):
        flat, x = ctx.saved_tensors
        cts = [c.to(torch.float32).contiguous() for c in cts]
        return psi_bwd(flat, ctx.sizes, x, cts), None, None


def psi_streams(flat: torch.Tensor, sizes: Sequence[int], x: torch.Tensor,
                uv_scale: float = 1.0, precision: str = "high") -> Derivs:
    """The (u, v, p) bundle (out, d/dx, d/dy, d2/dx2, d2/dy2), each [N,3], of
    the (psi, p) MLP whose flat weights are `flat` (models/mlp.py layout,
    `sizes` its layer sizes, K = 2): the contract of mlp_psi_derivatives_2d.
    Differentiable wrt `flat` only. On a card the batch must be padded to
    ROW_ALIGN rows."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; one of {PRECISIONS}")
    if sizes[-1] != 2:
        raise ValueError(f"the streamfunction bundle needs a (psi, p) head, got K = {sizes[-1]}")
    if x.device.type == "cpu":
        raw = plain_psi_streams(flat, sizes, x.detach())
    else:
        raw = _PsiStreams.apply(flat, x, tuple(sizes))
    return assemble_psi_bundle(raw, uv_scale)
