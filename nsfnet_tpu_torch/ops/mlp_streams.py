"""Five-stream derivative engine: the hand-written CUDA kernel pair and its
plain PyTorch version.

The port of nsfnet_tpu/ops/pallas_mlp.py. One call computes, for a tanh MLP
2 -> H (x L) -> K and points x[N,2], the five [N,K] streams
(out, d/dx, d/dy, d2/dx2, d2/dy2) of every output, and its backward turns
five [N,K] cotangents into the gradient wrt the flat weights:

  * kernel 3, `streams_fwd`: csrc/mlp_streams.cu streams_fwd_kernel<NP, K>,
    which replaces `_fwd_kernel` (pallas_mlp.py:183);
  * kernel 4, `streams_bwd`: streams_bwd_kernel<NP, K>, which replaces
    `_bwd_kernel` (pallas_mlp.py:313).

The solver's equation loss runs engine -> residuals -> masked sums through
this engine whenever the fused residual loss (ops/fused_residual.py) is
off: every `loss_mode: L2` run, and MSE runs with NSFNET_FUSED_LOSS=0.

`mlp_streams` is the entry point. On a CPU tensor it runs
`plain_mlp_streams` (the closed-form engine, differentiated by autograd) in
exact fp32 at every name; on a CUDA tensor it launches the kernel pair at
the name through `_MlpStreams`, or raises. x gets no gradient: collocation points
are optimization constants (pallas_mlp.py:415-431).

Precision. Both kernels run every hidden-layer and head product on bf16
parts of their operands at the name's passes, as the JAX kernels do:
"default" one pass, "high" three (JAX's bf16x3, pallas_mlp.py:111-129),
"highest" six; the name reaches the kernels as the number of parts
(`fused_residual.PARTS`). `plain_mlp_streams(..., precision=name)` and
`plain_mlp_streams_bwd(..., precision=name)` apply the same passes
(`fused_residual.emulated_derivatives`); `precision=None` is exact fp32.

Tiles come from this card's shared memory, not from the TPU kernel's
TILE = 512: both kernels take the plan of the tensor-core sweep's count
(`fused_residual.loss_plan`, the rule of kernels 1+2): the resident plan where it fits
(`pick_bwd_tile`), else the streamed plan, so every width runs. The TPU engine's
`lane_pad` option (pallas_mlp.py:371-413) zero-pads hidden widths to the
MXU's 128 lanes and changes no result; the kernels pad to their own
granule, so it is not carried over.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from nsfnet_tpu_torch.models.mlp import param_count, unflatten_params
from nsfnet_tpu_torch.ops import _build
from nsfnet_tpu_torch.ops import fused_residual as fr
from nsfnet_tpu_torch.ops.derivatives import Derivs, mlp_derivatives_2d
from nsfnet_tpu_torch.ops.fused_residual import (LOSS_BLOCKS, PARTS, PRECISIONS, ROW_ALIGN,
                                                 _raise_on)
from nsfnet_tpu_torch.utils import profiling

# Launches of each kernel since the last reset; the wrappers add one per launch.
launch_counts = {"mlp_streams_fwd": 0, "mlp_streams_bwd": 0}
# Floats the backward's plan reduces into its gradient partials, as
# fused_residual.partial_reduce counts them; the K-slots of hidden weights
# staged and prefetched, as fused_residual.weight_slots / weight_prefetch.
partial_reduce = {"mlp_streams_bwd": 0}
weight_slots = dict.fromkeys(launch_counts, 0)
weight_prefetch = dict.fromkeys(launch_counts, 0)
profiling.register("launches", launch_counts)
profiling.register("partial_reduce", partial_reduce)
profiling.register("weight_slots", weight_slots)
profiling.register("weight_prefetch", weight_prefetch)
# the launchers' spans (utils/profiling.py): checks, scratch, the ctypes call
_SPAN_FWD, _SPAN_BWD = profiling.span("kernel.streams_fwd"), profiling.span("kernel.streams_bwd")


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0
    for name in partial_reduce:
        partial_reduce[name] = 0
    for name in weight_slots:
        weight_slots[name] = weight_prefetch[name] = 0


def pick_bwd_tile(h: int, precision: str = "high", k: int = 3) -> Tuple[int, int]:
    """(tile, panel) of the resident plan of kernels 3+4: the rule of
    kernels 1+2 (the same tensor-core sweep and shared-memory count,
    tc_smem), at the net's head width; the source's
    nsf_mlp_streams_smem_bytes must agree (tests/test_torch_gpu.py checks).
    32 points with the whole weight at 4x120 and 6x80 at "high"."""
    return fr.pick_loss_tile(h, precision, k)


def flop_counts(sizes: Sequence[int], n: int, n_streams: int = 5) -> Tuple[int, int]:
    """Matrix-product FLOPs of kernel 3 and kernel 4 on n points (the
    elementwise tanh algebra, a few percent, is left out, so these give
    lower bounds on the time). The backward recomputes the hidden products
    and runs two more per layer (dW and the carry cotangent); the head has
    those two only. `n_streams` is the height of the packed carry: 5 here,
    13 in the order-3 engine (ops/psi_streams.py), which has the same shape
    of work. One fp32 product each: the kernels run `fused_residual.passes`
    bf16 products per fp32 product."""
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


def plain_mlp_streams(flat: torch.Tensor, sizes: Sequence[int], x: torch.Tensor,
                      precision: Optional[str] = None) -> Derivs:
    """The plain PyTorch version of kernel 3. precision None: the closed-form
    engine on the unflattened weights, exact fp32; a name: the kernel's bf16
    passes on every hidden and head product (`emulated_derivatives`)."""
    params = unflatten_params(flat, sizes)
    if precision is None:
        return mlp_derivatives_2d(params, x)
    return fr.emulated_derivatives(params, x, PARTS[precision])


def plain_mlp_streams_bwd(flat: torch.Tensor, sizes: Sequence[int], x: torch.Tensor,
                          cts: Sequence[torch.Tensor],
                          precision: Optional[str] = None) -> torch.Tensor:
    """The plain PyTorch version of kernel 4: autograd's gradient of
    sum_q <cts[q], stream_q> wrt the flat weights. precision None: exact
    fp32; a name: the kernel's bf16 passes on every hidden and head product,
    forward and backward (`emulated_derivatives`, whose `pass_dot` splits
    the cotangent too, as JAX's _dot_tn / _dot_nt do)."""
    flat = flat.detach().requires_grad_(True)
    with torch.enable_grad():
        streams = plain_mlp_streams(flat, sizes, x, precision)
    return torch.autograd.grad(streams, [flat], list(cts))[0]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("mlp_streams")
    p, i = ctypes.c_void_p, ctypes.c_int
    common = [p, p, i, i, i, i]
    lib.nsf_mlp_streams_fwd.argtypes = common + [i, i, i, i] + [p] * 7 + [i, p]
    lib.nsf_mlp_streams_fwd.restype = i
    lib.nsf_mlp_streams_bwd.argtypes = common + [i, i, i, i] + [p] * 10 + [i, p]
    lib.nsf_mlp_streams_bwd.restype = i
    lib.nsf_mlp_streams_smem_bytes.argtypes = [i, i, i, i, i, i]
    lib.nsf_mlp_streams_smem_bytes.restype = i
    lib.nsf_mlp_streams_tape_floats.argtypes = [i, i, i]
    lib.nsf_mlp_streams_tape_floats.restype = ctypes.c_long
    lib.nsf_mlp_streams_carry_floats.argtypes = [i, i, i, i]
    lib.nsf_mlp_streams_carry_floats.restype = ctypes.c_long
    lib.nsf_mlp_streams_weight_bytes.argtypes = [i, i, i]
    lib.nsf_mlp_streams_weight_bytes.restype = ctypes.c_long
    return lib


def _check_inputs(flat, sizes, x, cts=()):
    """Raises on what the kernels do not take; returns the batch size."""
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
    if n % ROW_ALIGN != 0:
        raise ValueError(f"batch {n} must be padded to a multiple of {ROW_ALIGN}")
    return n


def _check_precision(precision):
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; one of {PRECISIONS}")


def _launch_args(flat, sizes, x):
    return [x.data_ptr(), flat.data_ptr(), x.shape[0], len(sizes) - 2, sizes[1], sizes[-1]]


def _weight_split(lib, sizes, parts, dev) -> torch.Tensor:
    """Workspace for the launch's split copy of the hidden weights."""
    nbytes = lib.nsf_mlp_streams_weight_bytes(len(sizes) - 2, sizes[1], parts)
    return torch.empty(nbytes, dtype=torch.uint8, device=dev)


def _carries(lib, sizes, plan, parts, dev) -> Optional[torch.Tensor]:
    """The streamed plan's global regions, LOSS_BLOCKS blocks of them; None
    on the resident plan."""
    if not plan.streamed:
        return None
    floats = lib.nsf_mlp_streams_carry_floats(plan.tile, sizes[1], sizes[-1], parts)
    return torch.empty(LOSS_BLOCKS * floats, dtype=torch.float32, device=dev)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def streams_fwd(flat: torch.Tensor, sizes: Sequence[int], x: torch.Tensor,
                precision: str = "high", plan: Optional[fr.Plan] = None) -> Derivs:
    """Kernel 3: the five [N,K] streams, at the name's bf16 passes, on
    `plan` (by default `fused_residual.loss_plan`'s)."""
    with _SPAN_FWD:
        _check_precision(precision)
        n = _check_inputs(flat, sizes, x)
        plan = plan or fr.loss_plan(sizes[1], precision, sizes[-1])
        parts, dev, lib = PARTS[precision], x.device, _lib()
        wsplit = _weight_split(lib, sizes, parts, dev)
        carries = _carries(lib, sizes, plan, parts, dev)
        out = tuple(torch.empty((n, sizes[-1]), dtype=torch.float32, device=dev) for _ in range(5))
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = lib.nsf_mlp_streams_fwd(*_launch_args(flat, sizes, x), plan.tile, plan.panel,
                                           LOSS_BLOCKS, parts, wsplit.data_ptr(),
                                           *(o.data_ptr() for o in out), stream, plan.kpanel,
                                           _ptr(carries))
        _raise_on(code, "mlp streams forward")
        launch_counts["mlp_streams_fwd"] += 1
        fr.count_weight_stream(weight_slots, weight_prefetch, "mlp_streams_fwd", sizes, n, plan,
                               precision, False)
        return out


def streams_bwd(flat: torch.Tensor, sizes: Sequence[int], x: torch.Tensor,
                cts: Sequence[torch.Tensor], precision: str = "high",
                plan: Optional[fr.Plan] = None) -> torch.Tensor:
    """Kernel 4: the gradient wrt the flat weights from five [N,K]
    cotangents, at the name's bf16 passes, on `plan` (by default
    `fused_residual.loss_plan`'s)."""
    with _SPAN_BWD:
        if len(cts) != 5:
            raise ValueError(f"need the five streams' cotangents, got {len(cts)}")
        _check_precision(precision)
        n = _check_inputs(flat, sizes, x, cts)
        n_hidden, h, k = len(sizes) - 2, sizes[1], sizes[-1]
        plan = plan or fr.loss_plan(h, precision, k)
        parts, p, dev, lib = PARTS[precision], param_count(sizes), x.device, _lib()
        tape = torch.empty(LOSS_BLOCKS * lib.nsf_mlp_streams_tape_floats(plan.tile, h, n_hidden),
                           dtype=torch.float32, device=dev)
        wsplit = _weight_split(lib, sizes, parts, dev)
        carries = _carries(lib, sizes, plan, parts, dev)
        dpart = torch.empty(LOSS_BLOCKS * p, dtype=torch.float32, device=dev)
        dflat = torch.empty(p, dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = lib.nsf_mlp_streams_bwd(*_launch_args(flat, sizes, x), plan.tile, plan.panel,
                                           LOSS_BLOCKS, parts, wsplit.data_ptr(),
                                           *(c.data_ptr() for c in cts), tape.data_ptr(),
                                           dpart.data_ptr(), dflat.data_ptr(), stream, plan.kpanel,
                                           _ptr(carries))
        _raise_on(code, "mlp streams backward")
        launch_counts["mlp_streams_bwd"] += 1
        partial_reduce["mlp_streams_bwd"] += -(-n // plan.tile) * p
        fr.count_weight_stream(weight_slots, weight_prefetch, "mlp_streams_bwd", sizes, n, plan,
                               precision, True)
        return dflat


class _MlpStreams(torch.autograd.Function):
    """Kernel 3 forward, kernel 4 backward, both at the precision name (the
    custom_vjp of pallas_mlp.py:415-431). Gradients flow to flat only. A
    stream the loss does not use arrives as zeros (autograd materialises
    it), and a cotangent scattered from column slices may be strided: each
    is made contiguous fp32 before the kernel reads it."""

    @staticmethod
    def forward(ctx, flat, x, sizes, precision):
        ctx.save_for_backward(flat, x)
        ctx.meta = (sizes, precision)
        return streams_fwd(flat, sizes, x, precision)

    @staticmethod
    def backward(ctx, *cts):
        flat, x = ctx.saved_tensors
        sizes, precision = ctx.meta
        cts = [c.to(torch.float32).contiguous() for c in cts]
        return streams_bwd(flat, sizes, x, cts, precision), None, None, None


def mlp_streams(flat: torch.Tensor, sizes: Sequence[int], x: torch.Tensor,
                precision: str = "high") -> Derivs:
    """(out, d/dx, d/dy, d2/dx2, d2/dy2), each [N,K], of the MLP whose flat
    weights are `flat` (models/mlp.py layout, `sizes` its layer sizes).
    Differentiable wrt `flat` only. On a card the batch must be padded to
    ROW_ALIGN rows and both kernels run the bf16 passes of `precision`; on
    the CPU the plain version computes exact fp32."""
    _check_precision(precision)
    if x.device.type == "cpu":
        return plain_mlp_streams(flat, sizes, x.detach())
    return _MlpStreams.apply(flat, x, tuple(sizes), precision)
