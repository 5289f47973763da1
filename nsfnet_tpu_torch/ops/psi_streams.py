"""Order-3 streamfunction derivative engine: the hand-written CUDA kernel
pair and its plain PyTorch version.

The port of nsfnet_tpu/ops/pallas_psi.py. For a tanh MLP 2 -> H (x L) -> K
and points x[N,2], one call computes the thirteen raw [N,K] Taylor streams

    [o | a_x a_y a_p a_m | b_x b_y b_p b_m | c_x c_y c_p c_m]

(the value and the order-1/2/3 directional derivatives along e_x, e_y,
(1,1), (1,-1)), and its backward turns thirteen [N,K] cotangents into the
gradient wrt the flat weights:

  * kernel 5, `psi_fwd`: csrc/psi_streams.cu psi_fwd_kernel<NP, T, K>,
    which replaces `_fwd_kernel` (pallas_psi.py:176);
  * kernel 6, `psi_bwd`: psi_bwd_kernel<NP, T, K>, which replaces
    `_bwd_kernel` (pallas_psi.py:223); both over csrc/tc_psi.cuh.

`psi_streams` is the entry point of the streamfunction formulation (the net
outputs (psi, p); u = psi_y, v = -psi_x, continuity exact): it returns the
(u, v, p) `Derivs` bundle, assembled from the raw streams in plain PyTorch
outside the kernel, as the JAX package does (pallas_psi.py:373-380). On a
CPU tensor it runs `plain_psi_streams` (the closed-form engine,
differentiated by autograd) in exact fp32 at every name; on anything else it
launches the kernel pair at the name through `_PsiStreams`, or raises. x gets
no gradient: collocation points are optimization constants
(pallas_psi.py:367-369).

Precision. Both kernels run every hidden-layer and head product on bf16
parts of their operands at the name's passes, as the JAX kernels do:
"default" one pass, "high" three (JAX's bf16x3), "highest" six; the name
reaches the kernels as the number of parts (`fused_residual.PARTS`).
`plain_psi_streams(..., precision=name)` and
`plain_psi_streams_bwd(..., precision=name)` apply the same passes
(`emulated_psi_streams`); `precision=None` is exact fp32.

Tiles come from this card's shared memory, not from the TPU kernels' VMEM
budgets (`fwd_tile_for_psi` / `bwd_tile_for_psi`) or their
NSFNET_PALLAS_PSI_*_TILE knobs: both kernels take kernel 6's plan
(`psi_plan`): the resident plan where it fits (16 or 8 points and a weight
panel, `pick_bwd_tile`), else the streamed plan (tc_mlp.cuh), so every
width runs, as the JAX kernels' smallest tiles do. Every tile divides
ROW_ALIGN, so the solver's padding is that of the other engines.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Sequence, Tuple

import torch

from nsfnet_tpu_torch.models.mlp import Params, param_count, unflatten_params
from nsfnet_tpu_torch.ops import _build, mlp_streams
from nsfnet_tpu_torch.ops.derivatives import (N_PSI_STREAMS, Derivs, assemble_psi_bundle,
                                              mlp_psi_streams, tanh_chain)
from nsfnet_tpu_torch.ops.fused_residual import (_MAX_SMEM, LOSS_BLOCKS, PARTS, STREAM_KPANELS,
                                                 TC_WARPS, Plan, _pad16, _raise_on, _round16,
                                                 pass_dot, streamed_panel)
from nsfnet_tpu_torch.ops.mlp_streams import _check_inputs, _check_precision, _launch_args
from nsfnet_tpu_torch.utils import profiling

# Kernels 5+6: 16-point tiles where they fit, else 8 (the 13 streams padded to
# 14); the streamed plan takes 16-point tiles
PSI_BWD_TILES = (16, 8)
PSI_STREAM_TILE = 16

# Launches of each kernel since the last reset; the wrappers add one per launch.
launch_counts = {"psi_streams_fwd": 0, "psi_streams_bwd": 0}
# Floats the backward's plan reduces into its gradient partials, as
# fused_residual.partial_reduce counts them.
partial_reduce = {"psi_streams_bwd": 0}
profiling.register("launches", launch_counts)
profiling.register("partial_reduce", partial_reduce)
# the launchers' spans (utils/profiling.py): checks, scratch, the ctypes call
_SPAN_FWD, _SPAN_BWD = profiling.span("kernel.psi_fwd"), profiling.span("kernel.psi_bwd")


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0
    for name in partial_reduce:
        partial_reduce[name] = 0


def bwd_smem_bytes(tile: int, panel: int, h: int, parts: int, k: int = 2,
                   kpanel: int = 0) -> int:
    """Shared memory of one block of kernel 5 or 6 on the plan (tile, panel,
    kpanel), for choosing the plan without the library; the source's
    psi_smem (nsf_psi_streams_smem_bytes) owns the layout and must agree
    (tests/test_torch_gpu.py checks)."""
    hp = _pad16(h)
    rows = (N_PSI_STREAMS if tile == 16 else N_PSI_STREAMS + 1) * tile
    common = (_round16(N_PSI_STREAMS * tile * k * 4)
              + _round16(parts * N_PSI_STREAMS * tile * k * 4))
    if kpanel:
        a = rows * (kpanel + 8)
        w = max(kpanel * (panel + 8), panel * (kpanel + 8), a)
        return _round16(parts * a * 2) + _round16(parts * w * 2) + common
    carry = _round16(parts * rows * (hp + 8) * 2)
    wbuf = _round16(parts * max(hp * (panel + 8), panel * (hp + 8)) * 2)
    return (2 * carry + wbuf + _round16(parts * hp * k * 2) + common
            + _round16((tile // 8) * 3 * hp * 4))


def carry_floats(tile: int, h: int, k: int, parts: int) -> int:
    """Floats of the streamed plan's global regions of one block of kernels
    5+6 (the two carries, the head weight parts, the column sums): the
    library's psi_carry_floats (nsf_psi_streams_carry_floats)."""
    hp = _pad16(h)
    rows = (N_PSI_STREAMS if tile == 16 else N_PSI_STREAMS + 1) * tile
    return (2 * _round16(parts * rows * (hp + 8) * 2) + _round16(parts * hp * k * 2)
            + _round16((tile // 8) * 3 * hp * 4)) // 4


def pick_bwd_tile(h: int, precision: str = "high", k: int = 2) -> Tuple[int, int]:
    """(tile, panel) of the resident plan of kernels 5 and 6: the largest
    tile of PSI_BWD_TILES, then the widest weight panel (a multiple of 16
    dividing the padded width), whose block fits in shared memory with both
    carries. 16 points and the whole weight at 4x40 and at 6x80 up to
    "high"; 8 points at 6x80 "highest" and at 4x120 "high" / "highest";
    none from H = 433 on at "default", 209 at "high", 145 at "highest"
    (`psi_plan` then streams the carries)."""
    hp = _pad16(h)
    panels = [p for p in range(hp, 0, -16) if hp % p == 0]
    for tile in PSI_BWD_TILES:
        for panel in panels:
            if bwd_smem_bytes(tile, panel, h, PARTS[precision], k) <= _MAX_SMEM:
                return tile, panel
    raise ValueError(f"hidden width {h} at precision {precision!r}: no resident plan fits "
                     f"kernels 5+6's shared memory")


def psi_plan(h: int, precision: str = "high", k: int = 2) -> Plan:
    """The plan of kernels 5+6: the resident plan (`pick_bwd_tile`) where one
    fits, else the streamed plan: PSI_STREAM_TILE points (13 streams), an
    N-panel of at most one 8-column unit per warp (`streamed_panel`), the
    widest K-panel of STREAM_KPANELS whose block fits. Every width plans."""
    try:
        return Plan(*pick_bwd_tile(h, precision, k))
    except ValueError:
        pass
    hp, parts = _pad16(h), PARTS[precision]
    panel = streamed_panel(h, 8 * TC_WARPS)
    for kpanel in STREAM_KPANELS:
        kpanel = min(kpanel, hp)
        if bwd_smem_bytes(PSI_STREAM_TILE, panel, h, parts, k, kpanel) <= _MAX_SMEM:
            return Plan(PSI_STREAM_TILE, panel, kpanel)
    raise ValueError(f"a head of {k} outputs at precision {precision!r} does not fit the "
                     f"streamed plan's shared memory")


def flop_counts(sizes: Sequence[int], n: int) -> Tuple[int, int]:
    """Matrix-product FLOPs of kernel 5 and kernel 6 on n points: the
    five-stream engine's count with thirteen streams (the elementwise tanh
    algebra is left out, so these give lower bounds on the time). One fp32
    product each: the kernels run `fused_residual.passes` bf16 products per
    fp32 product."""
    return mlp_streams.flop_counts(sizes, n, N_PSI_STREAMS)


def byte_counts(sizes: Sequence[int], n: int) -> Tuple[int, int]:
    """Bytes kernel 5 and kernel 6 must move: each input read once, each
    output written once."""
    return mlp_streams.byte_counts(sizes, n, N_PSI_STREAMS)


def bwd_traffic(sizes: Sequence[int], n: int, precision: str = "high") -> Dict[str, int]:
    """Bytes per launch of kernel 6's own traffic beyond its inputs: the
    tape (written once by the recompute, read by the carry rebuild and by
    the epilogues) and the block's gradient partial, added to once per tile
    (read and written by the L2's reductions, never loaded by the SM);
    beside them, the scratch the CUDA-core design it replaced stored (every
    layer's 13-row carry and 12 tangent rows, written once and read once)."""
    n_hidden, h, k = len(sizes) - 2, sizes[1], sizes[-1]
    p = param_count(sizes)
    tile = psi_plan(h, precision, k).tile
    tiles, hp = -(-n // tile), _pad16(h)
    layer = tile * hp * 4
    written = tiles * layer * (1 + 13 * (n_hidden - 1))
    rebuilt = tiles * layer * (1 + 13 * (n_hidden - 2)) if n_hidden > 1 else 0
    old = n * (25 * n_hidden - 12) * h * 4
    return {"tape_written": written, "tape_read": written + rebuilt,
            "partial_rmw": tiles * p * 4 * 2,
            "cuda_core_scratch_written": old, "cuda_core_scratch_read": old}


def plain_psi_streams(flat: torch.Tensor, sizes: Sequence[int], x: torch.Tensor,
                      precision: Optional[str] = None) -> Tuple[torch.Tensor, ...]:
    """The plain PyTorch version of kernel 5: the thirteen raw streams.
    precision None: the closed form on the unflattened weights, exact fp32;
    a name: the kernel's bf16 passes on every hidden and head product
    (`emulated_psi_streams`)."""
    params = unflatten_params(flat, sizes)
    if precision is None:
        return mlp_psi_streams(params, x)
    return emulated_psi_streams(params, x, PARTS[precision])


def emulated_psi_streams(params: Params, x: torch.Tensor, parts: int) -> Tuple[torch.Tensor, ...]:
    """mlp_psi_streams with every hidden and head product run as kernels 5
    and 6 run it: on the 13-row packed carry [13N, H] (_layer_packed,
    pallas_psi.py:152-171, and the head at :186), through `pass_dot` with
    `parts` bf16 parts of each operand. At 3 parts it is about exact fp32."""
    w0, b0 = params[0]
    n = x.shape[0]
    t = torch.tanh(x @ w0 + b0)
    d1, d2, d3, _ = tanh_chain(t)
    wx, wy = w0[0], w0[1]
    rows = (wx, wy, wx + wy, wx - wy)
    packed = torch.cat([t] + [d1 * r for r in rows] + [d2 * (r * r) for r in rows]
                       + [d3 * (r * r * r) for r in rows])
    for w, b in params[1:-1]:
        z = pass_dot(packed, w, parts).split(n)
        t = torch.tanh(z[0] + b)
        d1, d2, d3, _ = tanh_chain(t)
        z1, z2, z3 = z[1:5], z[5:9], z[9:13]
        packed = torch.cat([t] + [d1 * a for a in z1]
                           + [d2 * a * a + d1 * c for a, c in zip(z1, z2)]
                           + [d3 * a * a * a + 3.0 * d2 * a * c + d1 * e
                              for a, c, e in zip(z1, z2, z3)])
    w, b = params[-1]
    out = pass_dot(packed, w, parts).split(n)
    return (out[0] + b, *out[1:])


def plain_psi_streams_bwd(flat: torch.Tensor, sizes: Sequence[int], x: torch.Tensor,
                          cts: Sequence[torch.Tensor],
                          precision: Optional[str] = None) -> torch.Tensor:
    """The plain PyTorch version of kernel 6: autograd's gradient of
    sum_q <cts[q], stream_q> wrt the flat weights. precision None: exact
    fp32 (the closed form); a name: the kernel's bf16 passes on every hidden
    and head product, forward and backward (`emulated_psi_streams`)."""
    flat = flat.detach().requires_grad_(True)
    with torch.enable_grad():
        streams = plain_psi_streams(flat, sizes, x, precision)
    return torch.autograd.grad(streams, [flat], list(cts))[0]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("psi_streams")
    p, i = ctypes.c_void_p, ctypes.c_int
    common = [p, p, i, i, i, i]
    lib.nsf_psi_streams_fwd.argtypes = common + [i, i, i, i, p, ctypes.POINTER(p), p, i, p]
    lib.nsf_psi_streams_fwd.restype = i
    lib.nsf_psi_streams_bwd.argtypes = common + [i, i, i, i, p, ctypes.POINTER(p), p, p, p, p,
                                                 i, p]
    lib.nsf_psi_streams_bwd.restype = i
    lib.nsf_psi_streams_smem_bytes.argtypes = [i, i, i, i, i, i]
    lib.nsf_psi_streams_smem_bytes.restype = i
    lib.nsf_psi_streams_tape_floats.argtypes = [i, i, i]
    lib.nsf_psi_streams_tape_floats.restype = ctypes.c_long
    lib.nsf_psi_streams_carry_floats.argtypes = [i, i, i, i]
    lib.nsf_psi_streams_carry_floats.restype = ctypes.c_long
    lib.nsf_psi_streams_weight_bytes.argtypes = [i, i, i]
    lib.nsf_psi_streams_weight_bytes.restype = ctypes.c_long
    return lib


def _pointers(tensors):
    return (ctypes.c_void_p * N_PSI_STREAMS)(*(t.data_ptr() for t in tensors))


def _weight_split(lib, sizes, parts, dev) -> torch.Tensor:
    """Workspace for the launch's split copy of the hidden weights."""
    nbytes = lib.nsf_psi_streams_weight_bytes(len(sizes) - 2, sizes[1], parts)
    return torch.empty(nbytes, dtype=torch.uint8, device=dev)


def _carries(lib, sizes, plan, parts, dev) -> Optional[torch.Tensor]:
    """The streamed plan's global regions, LOSS_BLOCKS blocks of them; None
    on the resident plan."""
    if not plan.streamed:
        return None
    floats = lib.nsf_psi_streams_carry_floats(plan.tile, sizes[1], sizes[-1], parts)
    return torch.empty(LOSS_BLOCKS * floats, dtype=torch.float32, device=dev)


def psi_fwd(flat: torch.Tensor, sizes: Sequence[int], x: torch.Tensor,
            precision: str = "high", plan: Optional[Plan] = None) -> Tuple[torch.Tensor, ...]:
    """Kernel 5: the thirteen raw [N,K] streams, at the name's bf16 passes,
    on `plan` (by default `psi_plan`'s)."""
    with _SPAN_FWD:
        _check_precision(precision)
        n = _check_inputs(flat, sizes, x)
        plan = plan or psi_plan(sizes[1], precision, sizes[-1])
        parts, dev, lib = PARTS[precision], x.device, _lib()
        wsplit = _weight_split(lib, sizes, parts, dev)
        carries = _carries(lib, sizes, plan, parts, dev)
        out = tuple(torch.empty((n, sizes[-1]), dtype=torch.float32, device=dev)
                    for _ in range(N_PSI_STREAMS))
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = lib.nsf_psi_streams_fwd(*_launch_args(flat, sizes, x), plan.tile, plan.panel,
                                           LOSS_BLOCKS, parts, wsplit.data_ptr(), _pointers(out),
                                           stream, plan.kpanel,
                                           None if carries is None else carries.data_ptr())
        _raise_on(code, "psi streams forward")
        launch_counts["psi_streams_fwd"] += 1
        return out


def psi_bwd(flat: torch.Tensor, sizes: Sequence[int], x: torch.Tensor,
            cts: Sequence[torch.Tensor], precision: str = "high",
            plan: Optional[Plan] = None) -> torch.Tensor:
    """Kernel 6: the gradient wrt the flat weights from thirteen [N,K]
    cotangents, at the name's bf16 passes, on `plan` (by default
    `psi_plan`'s)."""
    with _SPAN_BWD:
        if len(cts) != N_PSI_STREAMS:
            raise ValueError(f"need the {N_PSI_STREAMS} streams' cotangents, got {len(cts)}")
        _check_precision(precision)
        n = _check_inputs(flat, sizes, x, cts)
        n_hidden, h, k = len(sizes) - 2, sizes[1], sizes[-1]
        plan = plan or psi_plan(h, precision, k)
        parts, p, dev, lib = PARTS[precision], param_count(sizes), x.device, _lib()
        tape = torch.empty(LOSS_BLOCKS * lib.nsf_psi_streams_tape_floats(plan.tile, h, n_hidden),
                           dtype=torch.float32, device=dev)
        wsplit = _weight_split(lib, sizes, parts, dev)
        carries = _carries(lib, sizes, plan, parts, dev)
        dpart = torch.empty(LOSS_BLOCKS * p, dtype=torch.float32, device=dev)
        dflat = torch.empty(p, dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = lib.nsf_psi_streams_bwd(*_launch_args(flat, sizes, x), plan.tile, plan.panel,
                                           LOSS_BLOCKS, parts, wsplit.data_ptr(), _pointers(cts),
                                           tape.data_ptr(), dpart.data_ptr(), dflat.data_ptr(),
                                           stream, plan.kpanel,
                                           None if carries is None else carries.data_ptr())
        _raise_on(code, "psi streams backward")
        launch_counts["psi_streams_bwd"] += 1
        partial_reduce["psi_streams_bwd"] += -(-n // plan.tile) * p
        return dflat


class _PsiStreams(torch.autograd.Function):
    """Kernel 5 forward, kernel 6 backward, both at the precision name (the
    custom_vjp of pallas_psi.py:360-371). Gradients flow to flat only. The
    bundle never reads a_p and a_m, and p has no second or third
    derivatives, so several cotangents arrive as zeros (autograd
    materialises them) or scattered from column slices: each is made
    contiguous fp32 before the kernel reads it."""

    @staticmethod
    def forward(ctx, flat, x, sizes, precision):
        ctx.save_for_backward(flat, x)
        ctx.meta = (sizes, precision)
        return psi_fwd(flat, sizes, x, precision)

    @staticmethod
    def backward(ctx, *cts):
        flat, x = ctx.saved_tensors
        sizes, precision = ctx.meta
        cts = [c.to(torch.float32).contiguous() for c in cts]
        return psi_bwd(flat, sizes, x, cts, precision), None, None, None


def psi_streams(flat: torch.Tensor, sizes: Sequence[int], x: torch.Tensor,
                uv_scale: float = 1.0, precision: str = "high") -> Derivs:
    """The (u, v, p) bundle (out, d/dx, d/dy, d2/dx2, d2/dy2), each [N,3], of
    the (psi, p) MLP whose flat weights are `flat` (models/mlp.py layout,
    `sizes` its layer sizes, K = 2): the contract of mlp_psi_derivatives_2d.
    Differentiable wrt `flat` only. On a card the batch must be padded to
    ROW_ALIGN rows and both kernels run the bf16 passes of `precision`; on
    the CPU the plain version computes exact fp32."""
    _check_precision(precision)
    if sizes[-1] != 2:
        raise ValueError(f"the streamfunction bundle needs a (psi, p) head, got K = {sizes[-1]}")
    if x.device.type == "cpu":
        raw = plain_psi_streams(flat, sizes, x.detach())
    else:
        raw = _PsiStreams.apply(flat, x, tuple(sizes), precision)
    return assemble_psi_bundle(raw, uv_scale)
