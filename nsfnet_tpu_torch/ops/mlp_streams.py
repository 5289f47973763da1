"""Five-stream derivative engine: the hand-written CUDA kernel pair and its
plain PyTorch version.

The port of nsfnet_tpu/ops/pallas_mlp.py. One call computes, for a tanh MLP
2 -> H (x L) -> K and points x[N,2], the five [N,K] streams
(out, d/dx, d/dy, d2/dx2, d2/dy2) of every output, and its backward turns
five [N,K] cotangents into the gradient wrt the flat weights:

  * kernel 3, `streams_fwd`: csrc/mlp_streams.cu streams_fwd_kernel, which
    replaces `_fwd_kernel` (pallas_mlp.py:183);
  * kernel 4, `streams_bwd`: streams_bwd_kernel, which replaces
    `_bwd_kernel` (pallas_mlp.py:313).

The solver's equation loss runs engine -> residuals -> masked sums through
this engine whenever the fused residual loss (ops/fused_residual.py) is
off: every `loss_mode: L2` run, and MSE runs with NSFNET_FUSED_LOSS=0.

`mlp_streams` is the entry point. On a CPU tensor it runs
`plain_mlp_streams` (the closed-form engine, differentiated by autograd);
on a CUDA tensor it launches the kernel pair through `_MlpStreams`, or
raises. x gets no gradient: collocation points are optimization constants
(pallas_mlp.py:415-431).

The tile and the batch padding come from this card's shared memory
(`pick_tile` here, `ROW_ALIGN`), not from the TPU kernel's
TILE = 512. The TPU engine's `lane_pad` option (pallas_mlp.py:371-413)
zero-pads hidden widths to the MXU's 128 lanes and changes no result; CUDA
cores have no such granule, so it is not carried over. Every precision name
of the JAX package is accepted and computes exact fp32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from nsfnet_tpu_torch.models.mlp import param_count, unflatten_params
from nsfnet_tpu_torch.ops import _build
from nsfnet_tpu_torch.ops.derivatives import Derivs, mlp_derivatives_2d
from nsfnet_tpu_torch.ops.fused_residual import (_MAX_SMEM, _TILES, PARTIAL_BLOCKS, PRECISIONS,
                                                 ROW_ALIGN, _raise_on)

# Launches of each kernel since the last reset; the wrappers add one per launch.
launch_counts = {"mlp_streams_fwd": 0, "mlp_streams_bwd": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def smem_bytes(tile: int, h: int, k: int = 3) -> int:
    """Shared memory of one block (two [5][T][H] carries, the staged weight,
    the loss terms, the [5][T][K] head block), for choosing the tile without
    the library; the source's nsf_mlp_streams_smem_bytes owns the layout and
    must agree (tests/test_torch_gpu.py checks every tile)."""
    return 4 * (10 * tile * h + h * (h + 1) + 4 * tile + 5 * tile * k)


def pick_tile(h: int, k: int = 3) -> int:
    """Largest tile (at most 16 points) whose block fits in shared memory.
    At the flagship width 16 points take 78 KB: two blocks per SM."""
    for t in _TILES:
        if smem_bytes(t, h, k) <= _MAX_SMEM:
            return t
    raise ValueError(f"hidden width {h} does not fit the kernel's shared memory")


def flop_counts(sizes: Sequence[int], n: int, n_streams: int = 5) -> Tuple[int, int]:
    """Matrix-product FLOPs of kernel 3 and kernel 4 on n points (the
    elementwise tanh algebra, a few percent, is left out, so these give
    lower bounds on the time). The backward recomputes the hidden products
    and runs two more per layer (dW and the carry cotangent); the head has
    those two only. `n_streams` is the height of the packed carry: 5 here,
    13 in the order-3 engine (ops/psi_streams.py), which has the same shape
    of work."""
    n_hidden, h, k = len(sizes) - 2, sizes[1], sizes[-1]
    hidden = (n_hidden - 1) * n_streams * 2 * h * h
    head = n_streams * 2 * h * k
    return n * (hidden + head), n * (3 * hidden + 2 * head)


def byte_counts(sizes: Sequence[int], n: int, n_streams: int = 5) -> Tuple[int, int]:
    """Bytes kernel 3 and kernel 4 must move: each input read once, each
    output written once."""
    p, k = param_count(sizes), sizes[-1]
    fwd = n * 8 + 4 * p + n_streams * 4 * n * k
    bwd = n * 8 + 4 * p + n_streams * 4 * n * k + 4 * p
    return fwd, bwd


def plain_mlp_streams(flat: torch.Tensor, sizes: Sequence[int], x: torch.Tensor) -> Derivs:
    """The plain PyTorch version of kernel 3: the closed-form engine on the
    unflattened weights."""
    return mlp_derivatives_2d(unflatten_params(flat, sizes), x)


def plain_mlp_streams_bwd(flat: torch.Tensor, sizes: Sequence[int], x: torch.Tensor,
                          cts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The plain PyTorch version of kernel 4: autograd's gradient of
    sum_q <cts[q], stream_q> wrt the flat weights."""
    flat = flat.detach().requires_grad_(True)
    with torch.enable_grad():
        streams = plain_mlp_streams(flat, sizes, x)
    return torch.autograd.grad(streams, [flat], list(cts))[0]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("mlp_streams")
    p, i = ctypes.c_void_p, ctypes.c_int
    common = [p, p, i, i, i, i, i, i]
    lib.nsf_mlp_streams_fwd.argtypes = common + [p] * 6
    lib.nsf_mlp_streams_fwd.restype = i
    lib.nsf_mlp_streams_bwd.argtypes = common + [p] * 9
    lib.nsf_mlp_streams_bwd.restype = i
    lib.nsf_mlp_streams_smem_bytes.argtypes = [i, i, i]
    lib.nsf_mlp_streams_smem_bytes.restype = i
    lib.nsf_mlp_streams_scratch_floats.argtypes = [i, i, i]
    lib.nsf_mlp_streams_scratch_floats.restype = ctypes.c_long
    return lib


def _check_inputs(flat, sizes, x, cts=(), pick_tile=pick_tile):
    """Raises on what the kernels do not take; returns the batch size and
    the tile `pick_tile` chooses for the width."""
    n, k = x.shape[0], sizes[-1]
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {x.device}")
    if len(sizes) < 3 or sizes[0] != 2 or k < 1 or len(set(sizes[1:-1])) != 1:
        raise ValueError(f"the kernel takes a 2 -> H x L -> K MLP, got {tuple(sizes)}")
    for name, t, shape in [("flat", flat, (param_count(sizes),)), ("x", x, (n, 2))] + [
            ("cotangent", c, (n, k)) for c in cts]:
        if t is None or t.dtype != torch.float32 or t.device != x.device \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: need contiguous float32 {shape} on {x.device}")
    tile = pick_tile(sizes[1], k)
    if n % tile != 0:
        raise ValueError(f"batch {n} must be padded to a multiple of {ROW_ALIGN}")
    return n, tile


def _launch_args(flat, sizes, x, tile):
    return [x.data_ptr(), flat.data_ptr(), x.shape[0], len(sizes) - 2, sizes[1], sizes[-1],
            tile, PARTIAL_BLOCKS]


def streams_fwd(flat: torch.Tensor, sizes: Sequence[int], x: torch.Tensor) -> Derivs:
    """Kernel 3: the five [N,K] streams."""
    n, tile = _check_inputs(flat, sizes, x)
    out = tuple(torch.empty((n, sizes[-1]), dtype=torch.float32, device=x.device)
                for _ in range(5))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = _lib().nsf_mlp_streams_fwd(*_launch_args(flat, sizes, x, tile),
                                          *(o.data_ptr() for o in out), stream)
    _raise_on(code, "mlp streams forward")
    launch_counts["mlp_streams_fwd"] += 1
    return out


def streams_bwd(flat: torch.Tensor, sizes: Sequence[int], x: torch.Tensor,
                cts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Kernel 4: the gradient wrt the flat weights from five [N,K] cotangents."""
    if len(cts) != 5:
        raise ValueError(f"need the five streams' cotangents, got {len(cts)}")
    n, tile = _check_inputs(flat, sizes, x, cts)
    p, dev = param_count(sizes), x.device
    block_floats = _lib().nsf_mlp_streams_scratch_floats(tile, sizes[1], len(sizes) - 2)
    scratch = torch.empty(PARTIAL_BLOCKS * block_floats, dtype=torch.float32, device=dev)
    dpart = torch.empty(PARTIAL_BLOCKS * p, dtype=torch.float32, device=dev)
    dflat = torch.empty(p, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = _lib().nsf_mlp_streams_bwd(*_launch_args(flat, sizes, x, tile),
                                          *(c.data_ptr() for c in cts), scratch.data_ptr(),
                                          dpart.data_ptr(), dflat.data_ptr(), stream)
    _raise_on(code, "mlp streams backward")
    launch_counts["mlp_streams_bwd"] += 1
    return dflat


class _MlpStreams(torch.autograd.Function):
    """Kernel 3 forward, kernel 4 backward (the custom_vjp of
    pallas_mlp.py:415-431). Gradients flow to flat only. A stream the loss
    does not use arrives as zeros (autograd materialises it), and a
    cotangent scattered from column slices may be strided: each is made
    contiguous fp32 before the kernel reads it."""

    @staticmethod
    def forward(ctx, flat, x, sizes):
        ctx.save_for_backward(flat, x)
        ctx.sizes = sizes
        return streams_fwd(flat, sizes, x)

    @staticmethod
    def backward(ctx, *cts):
        flat, x = ctx.saved_tensors
        cts = [c.to(torch.float32).contiguous() for c in cts]
        return streams_bwd(flat, ctx.sizes, x, cts), None, None


def mlp_streams(flat: torch.Tensor, sizes: Sequence[int], x: torch.Tensor,
                precision: str = "high") -> Derivs:
    """(out, d/dx, d/dy, d2/dx2, d2/dy2), each [N,K], of the MLP whose flat
    weights are `flat` (models/mlp.py layout, `sizes` its layer sizes).
    Differentiable wrt `flat` only. On a card the batch must be padded to
    ROW_ALIGN rows."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; one of {PRECISIONS}")
    if x.device.type == "cpu":
        return plain_mlp_streams(flat, sizes, x.detach())
    return _MlpStreams.apply(flat, x, tuple(sizes))
