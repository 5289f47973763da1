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

The CUDA sources (fused_residual.cu, tc_mlp.cuh) say what bounds them
(operations) and how the design deals with the TPU kernels' sequential-grid
accumulation (a fixed grid of persistent blocks, per-block partials, an
ordered second pass: bitwise deterministic). Every width runs: `loss_plan`
takes the resident plan (both packed carries of a tile in shared memory,
`pick_loss_tile`) where it fits, else the streamed plan (the carries in a
block-private global scratch, `carry_floats`, staged through shared memory
a K-panel at a time), as the JAX kernels drop to smaller tiles.

Precision. Every hidden-layer and head product of the pair runs on bf16
parts of its operands, as the JAX kernels do: "default" one pass, "high"
three (JAX's bf16x3, pallas_mlp.py:111-129), "highest" six (Mosaic's
HIGHEST). The name reaches the kernel as the number of parts (`PARTS`).
`plain_residual_sums(..., precision=name)` applies the same passes with
bf16 casts (`pass_dot`, `emulated_derivatives`); `precision=None` is exact
fp32.

`fused_residual_loss` is the entry point. On a CPU tensor it runs
`plain_residual_sums` in exact fp32 (closed-form derivative engine ->
residuals -> masked sums, differentiated by autograd); on a CUDA tensor it
launches the kernel pair at the precision name through `_FusedResidualLoss`,
or raises. x, vis_t, eq_w and Re get no gradient: they are optimization
constants (collocation points, the lagged eddy viscosity, the SDF weights,
the stage Reynolds number).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from nsfnet_tpu_torch.models.mlp import Params, param_count, unflatten_params
from nsfnet_tpu_torch.ops import _build
from nsfnet_tpu_torch.ops import losses as L
from nsfnet_tpu_torch.ops import residuals as R
from nsfnet_tpu_torch.ops.derivatives import Derivs, mlp_derivatives_2d
from nsfnet_tpu_torch.utils import profiling

PRECISIONS = ("highest", "high", "default")
PARTS = {"highest": 3, "high": 2, "default": 1}  # bf16 parts of each operand
ROW_ALIGN = 16         # batches are padded to this; every tile size divides it
_MAX_SMEM = 232_448    # bytes of shared memory a block may use on sm_90

# Every kernel: one persistent block per SM of an H100 (a constant, not read
# from the card: the number of partials fixes the summation order); kernels
# 1-4 take 32-point tiles where they fit, else 16 (kernels 5+6: 16 or 8).
LOSS_BLOCKS = 132
LOSS_TILES = (32, 16)
# The streamed plan (tc_mlp.cuh): 16-point tiles, the widest K-panel of these
# that fits, N-panels of at most one 16 x 16 unit per warp (10 warps).
STREAM_TILE = 16
STREAM_KPANELS = (128, 64, 32, 16)
TC_WARPS = 10


class Plan(NamedTuple):
    """How a tensor-core sweep lays out one block (tc_mlp.cuh, tc_psi.cuh):
    the points per tile, the weight panel (resident: a divisor of the padded
    width; streamed: the N-panel) and the K-panel, 0 for the resident plan
    (both carries in shared memory), else the streamed plan (the carries in
    a block-private global scratch, staged K-panel by K-panel)."""
    tile: int
    panel: int
    kpanel: int = 0

    @property
    def streamed(self) -> bool:
        return self.kpanel > 0


# Launches of each kernel since the last reset; the wrappers add one per
# launch, and the launch's rows to `launch_rows` (a data-parallel rank or a
# microbatch slice launches on its own block of the batch).
launch_counts = {"fused_residual_fwd": 0, "fused_residual_bwd": 0}
launch_rows = dict.fromkeys(launch_counts, 0)
# Floats the backward's plan reduces into its blocks' gradient partials
# (tc_mlp.cuh red_add) since the last reset, counted by the launcher from the
# plan: every tile adds to every parameter once, so a launch adds its tiles x
# parameters. It says how much a run sent through the reductions, not that
# the kernel body made them (the library's SASS and compare_sources do).
partial_reduce = {"fused_residual_bwd": 0}
# K-slots of hidden weights the launches staged into shared memory since the
# last reset (`weight_stream`), and those among them that the weight ring
# (tc_mlp.cuh) loaded while the product on an earlier slot ran: counted by
# the launcher from the plan and the rows, as partial_reduce is.
weight_slots = dict.fromkeys(launch_counts, 0)
weight_prefetch = dict.fromkeys(launch_counts, 0)
profiling.register("launches", launch_counts)
profiling.register("launch_rows", launch_rows)
profiling.register("partial_reduce", partial_reduce)
profiling.register("weight_slots", weight_slots)
profiling.register("weight_prefetch", weight_prefetch)
# the launchers' spans (utils/profiling.py): checks, scratch, the ctypes call
_SPAN_FWD, _SPAN_BWD = profiling.span("kernel.loss_fwd"), profiling.span("kernel.loss_bwd")


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0
        launch_rows[name] = 0
    for name in partial_reduce:
        partial_reduce[name] = 0
    for name in weight_slots:
        weight_slots[name] = weight_prefetch[name] = 0


def passes(precision: str) -> int:
    """bf16 products per fp32 product: the pairs of parts i + j < PARTS."""
    n = PARTS[precision]
    return n * (n + 1) // 2


def _pad16(h: int) -> int:
    return -(-h // 16) * 16


def _round16(b: int) -> int:
    return -(-b // 16) * 16


def _common_bytes(tile: int, parts: int, k: int) -> int:
    # the head streams, the head cotangent parts, the loss terms
    return (_round16(5 * tile * k * 4) + _round16(parts * 5 * tile * k * 4)
            + _round16(4 * tile * 4))


def _resident_rest(tile: int, h: int, parts: int, k: int) -> int:
    """Bytes of a resident block's regions beside its weight ring: the two
    carries, the head weight parts, the common regions, the column sums."""
    hp = _pad16(h)
    return (2 * _round16(parts * 5 * tile * (hp + 8) * 2) + _round16(parts * hp * k * 2)
            + _common_bytes(tile, parts, k) + _round16((tile // 8) * 3 * hp * 4))


def _slot_bytes(panel: int, kx: int, parts: int) -> int:
    """One K-slot of the weight ring: kx rows of a forward panel or kx
    columns of a backward panel, row padding 8."""
    return _round16(parts * max(kx * (panel + 8), panel * (kx + 8)) * 2)


@functools.lru_cache(maxsize=None)
def ring_plan(tile: int, panel: int, h: int, parts: int, k: int = 3) -> Tuple[int, int]:
    """(depth, K-extent) of the weight ring of the resident plan (tile,
    panel) of kernels 1-4 (tc_mlp.cuh tc_ring; the library's
    nsf_fused_loss_ring must agree): two slots of the widest K-extent, a
    multiple of 16 dividing the padded width, that fit beside the block's
    other regions, cut below the whole panel only where each warp has at
    most one 16 x 16 unit of it; else one slot of the whole panel, the
    synchronous staging. 2 x 80 at 6x80 (tile 32, panel 80) and at 6x160
    (tile 16, panel 160)."""
    hp = _pad16(h)
    rest = _resident_rest(tile, h, parts, k)
    cut = (tile // 16) * (panel // 16) <= TC_WARPS
    for kx in range(hp, 0, -16):
        if hp % kx == 0 and (kx == hp or cut) and rest + 2 * _slot_bytes(panel, kx, parts) \
                <= _MAX_SMEM:
            return 2, kx
    return 1, hp


def loss_smem_bytes(tile: int, panel: int, h: int, parts: int, k: int = 3,
                    kpanel: int = 0) -> int:
    """Shared memory of one block of kernels 1-4 on the plan (tile, panel,
    kpanel), for choosing the plan without the library; the source's
    tc_smem (nsf_fused_loss_smem_bytes) owns the layout and must agree
    (tests/test_torch_gpu.py checks). The resident plan's weight ring
    (`ring_plan`) takes two slots only where they fit, else the one slot
    of a whole panel: a plan `pick_loss_tile` takes always fits."""
    if kpanel:
        a = 5 * tile * (kpanel + 8)
        w = max(kpanel * (panel + 8), panel * (kpanel + 8), a)
        return _round16(parts * a * 2) + _round16(parts * w * 2) + _common_bytes(tile, parts, k)
    depth, kx = ring_plan(tile, panel, h, parts, k)
    return _resident_rest(tile, h, parts, k) + depth * _slot_bytes(panel, kx, parts)


def carry_floats(tile: int, h: int, k: int, parts: int) -> int:
    """Floats of the streamed plan's global regions of one block of kernels
    1-4 (the two carries, the head weight parts, the column sums): the
    library's tc_carry_floats (nsf_fused_loss_carry_floats)."""
    hp = _pad16(h)
    return (2 * _round16(parts * 5 * tile * (hp + 8) * 2) + _round16(parts * hp * k * 2)
            + _round16((tile // 8) * 3 * hp * 4)) // 4


def pick_loss_tile(h: int, precision: str = "high", k: int = 3) -> Tuple[int, int]:
    """(tile, panel) of the resident plan of kernels 1-4: the largest tile of
    LOSS_TILES, then the widest weight panel (a multiple of 16 dividing the
    padded width), whose block fits in shared memory with both carries and
    one whole panel; the weight ring (`ring_plan`) then takes the room it
    finds, and the plans stay those of whole-panel staging. At the flagship
    width 80 the whole weight and 32 points fit at every name; none fits
    from H = 561 on at "default", 289 at "high", 193 at "highest"
    (`loss_plan` then streams the carries)."""
    hp, parts = _pad16(h), PARTS[precision]
    panels = [p for p in range(hp, 0, -16) if hp % p == 0]
    for tile in LOSS_TILES:
        for panel in panels:
            if _resident_rest(tile, h, parts, k) + _slot_bytes(panel, hp, parts) <= _MAX_SMEM:
                return tile, panel
    raise ValueError(f"hidden width {h} at precision {precision!r}: no resident plan fits the "
                     f"kernel's shared memory")


def streamed_panel(h: int, max_panel: int) -> int:
    """The streamed plan's N-panel: the padded width cut into the fewest
    panels of at most `max_panel` units, as even as multiples of 16 allow."""
    hp = _pad16(h)
    n_panels = -(-hp // max_panel)
    return _round16(-(-hp // n_panels))


def loss_plan(h: int, precision: str = "high", k: int = 3) -> Plan:
    """The plan of kernels 1-4: the resident plan (`pick_loss_tile`) where
    one fits, else the streamed plan: STREAM_TILE points, the N-panel of
    `streamed_panel`, the widest K-panel of STREAM_KPANELS whose block fits.
    Its shared memory does not grow with H, so every width plans."""
    try:
        return Plan(*pick_loss_tile(h, precision, k))
    except ValueError:
        pass
    hp, parts = _pad16(h), PARTS[precision]
    panel = streamed_panel(h, 16 * TC_WARPS * 16 // STREAM_TILE)
    for kpanel in STREAM_KPANELS:
        kpanel = min(kpanel, hp)
        if loss_smem_bytes(STREAM_TILE, panel, h, parts, k, kpanel) <= _MAX_SMEM:
            return Plan(STREAM_TILE, panel, kpanel)
    raise ValueError(f"a head of {k} outputs at precision {precision!r} does not fit the "
                     f"streamed plan's shared memory")


def weight_stream(sizes: Sequence[int], rows: int, plan: Plan, precision: str = "high",
                  reverse: bool = False) -> Tuple[int, int]:
    """(slots, prefetched) of one launch of kernels 1-4 on `rows` points:
    the K-slots of hidden weights its blocks stage into shared memory (each
    tile's forward products and, with `reverse` (the backwards), the
    reverse sweep's: N-panels x K-slots each), and those among them the
    weight ring loads while the product on an earlier slot runs: all but
    each block's first at depth 2, none at depth 1 or on the streamed plan,
    which stages its K-panels synchronously."""
    n_hidden, h, k = len(sizes) - 2, sizes[1], sizes[-1]
    hp, tiles = _pad16(h), -(-rows // plan.tile)
    products = max(n_hidden - 1, 0) * (2 if reverse else 1) * -(-hp // plan.panel)
    if plan.streamed:
        return tiles * products * -(-hp // plan.kpanel), 0
    depth, kx = ring_plan(plan.tile, plan.panel, h, PARTS[precision], k)
    slots = tiles * products * (hp // kx)
    return slots, (slots - min(tiles, LOSS_BLOCKS) if depth == 2 and slots else 0)


def count_weight_stream(slots: Dict[str, int], prefetch: Dict[str, int], name: str,
                        sizes: Sequence[int], rows: int, plan: Plan, precision: str,
                        reverse: bool) -> None:
    """Adds one launch's `weight_stream` to the counters `slots[name]`,
    `prefetch[name]`."""
    n_slots, n_pre = weight_stream(sizes, rows, plan, precision, reverse)
    slots[name] += n_slots
    prefetch[name] += n_pre


def flop_counts(sizes: Sequence[int], n: int) -> Tuple[int, int]:
    """Matrix-product FLOPs of kernel 1 and kernel 2 on n points, one pass
    (multiply by `passes` for the bf16 products the kernels run; the
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


def bwd_traffic(sizes: Sequence[int], n: int, precision: str = "high") -> Dict[str, int]:
    """Bytes per launch of kernel 2's own traffic beyond its inputs: the
    backward tape (written once, read by the carry rebuild and by the
    epilogues); the block's gradient partial, added to once per tile
    (`partial_rmw`: read and written by the L2's reductions, never loaded by
    the SM); the split hidden weights, staged into shared memory once per
    product layer per tile by the recompute and once by the reverse sweep
    (`weights_staged`, mostly L2 hits: one copy serves every block; the
    weight ring loads them while the products run, the same bytes); beside
    them, the same counts for the earlier CUDA-core design (16-point tiles
    storing every carry and tangent)."""
    n_hidden, h = len(sizes) - 2, sizes[1]
    p = param_count(sizes)
    tile = loss_plan(h, precision).tile
    tiles, hp = -(-n // tile), _pad16(h)
    layer = tile * hp * 4
    written = tiles * layer * (1 + 5 * (n_hidden - 1))
    rebuilt = tiles * layer * (1 + 5 * (n_hidden - 2)) if n_hidden > 1 else 0
    return {"tape_written": written, "tape_read": written + rebuilt,
            "partial_rmw": tiles * p * 4 * 2,
            "weights_staged": tiles * 2 * (n_hidden - 1) * PARTS[precision] * hp * hp * 2,
            "cuda_core_scratch_written": n * (9 * n_hidden - 4) * h * 4,
            "cuda_core_scratch_read": n * (9 * n_hidden - 4) * h * 4,
            "cuda_core_partial_rmw": (n // 16) * p * 4 * 2}


# ------------------------------------------------------------ plain version

def bf16_split(a: torch.Tensor, parts: int) -> Tuple[torch.Tensor, ...]:
    """a = a_0 + a_1 + ... + remainder, each a_i a bf16 value (round to
    nearest, as astype(bfloat16)) held in fp32: JAX's _bf16_split
    (pallas_mlp.py:111) for two parts, continued for three."""
    out, r = [], a
    for _ in range(parts):
        p = r.to(torch.bfloat16).to(a.dtype)
        out.append(p)
        r = r - p
    return tuple(out)


# Set by `sums_rounded_once`: the plain passes sum in fp64, a witness of the
# order of their fp32 sums.
_round_sums_once = False


def _passes_mm(a: torch.Tensor, b: torch.Tensor, parts: int) -> torch.Tensor:
    sa, sb = bf16_split(a, parts), bf16_split(b, parts)
    # a bf16 x bf16 product is exact in fp32: the fp32 matmul only sums
    acc = torch.float64 if _round_sums_once else a.dtype
    return sum(sa[i].to(acc) @ sb[j].to(acc)
               for i in range(parts) for j in range(parts - i)).to(a.dtype)


@contextlib.contextmanager
def sums_rounded_once():
    """The plain versions with every pass product summed in fp64 and rounded
    to fp32 once: the same bf16 products as `pass_dot`, another rounding of
    their sums (ops/pass_checks.py uses it as a witness)."""
    global _round_sums_once
    _round_sums_once = True
    try:
        yield
    finally:
        _round_sums_once = False


class _PassDot(torch.autograd.Function):
    """a @ b as the sum of the bf16 passes, with the backward products split
    the same way (the cotangent too), as JAX's _general dots are inside the
    custom_vjp kernels (_dot_tn, _dot_nt, pallas_mlp.py:132-134)."""

    @staticmethod
    def forward(ctx, a, b, parts):
        ctx.save_for_backward(a, b)
        ctx.parts = parts
        return _passes_mm(a, b, parts)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return _passes_mm(g, b.t(), ctx.parts), _passes_mm(a.t(), g, ctx.parts), None


def pass_dot(a: torch.Tensor, b: torch.Tensor, parts: int) -> torch.Tensor:
    return _PassDot.apply(a, b, parts)


def emulated_derivatives(params: Params, x: torch.Tensor, parts: int) -> Derivs:
    """mlp_derivatives_2d with every hidden and head product run as the
    kernels run it: on the packed carry [5N, H] (_layer_packed,
    pallas_mlp.py:149), through pass_dot."""
    w0, b0 = params[0]
    n = x.shape[0]
    t = torch.tanh(x @ w0 + b0)
    s = 1.0 - t * t
    curv = -2.0 * t * s
    wx, wy = w0[0], w0[1]
    packed = torch.cat([t, s * wx, s * wy, curv * (wx * wx), curv * (wy * wy)])
    for w, b in params[1:-1]:
        zx_all = pass_dot(packed, w, parts)
        z, zx, zy, zxx, zyy = zx_all.split(n)
        t = torch.tanh(z + b)
        s = 1.0 - t * t
        curv = -2.0 * t * s
        packed = torch.cat([t, s * zx, s * zy, curv * zx * zx + s * zxx,
                            curv * zy * zy + s * zyy])
    w, b = params[-1]
    out, ox, oy, oxx, oyy = pass_dot(packed, w, parts).split(n)
    return (out + b, ox, oy, oxx, oyy)


def plain_residual_sums(params: Params, x: torch.Tensor, e: Optional[torch.Tensor],
                        vis_t: Optional[torch.Tensor], eq_w: torch.Tensor, re: float,
                        coord_scale: float = 1.0, evm: bool = True,
                        precision: Optional[str] = None) -> torch.Tensor:
    """The plain PyTorch version of the kernel pair: S_i = sum(eq_w * eq_i^2),
    [4] (EVM) or [3] (vanilla). Its gradient is autograd's. precision None:
    exact fp32; a name: the kernels' bf16 passes on every product."""
    if precision is None:
        derivs = mlp_derivatives_2d(params, x)
    else:
        derivs = emulated_derivatives(params, x, PARTS[precision])
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
    common = [p, p, p, p, p, i, i, i, i, i, i, i, i, f, f, i]
    lib.nsf_fused_loss_fwd.argtypes = common + [p, p, p, p, i, p]
    lib.nsf_fused_loss_fwd.restype = i
    lib.nsf_fused_loss_bwd.argtypes = common + [p, p, p, p, p, p, p, i, p]
    lib.nsf_fused_loss_bwd.restype = i
    lib.nsf_fused_loss_smem_bytes.argtypes = [i, i, i, i, i, i]
    lib.nsf_fused_loss_smem_bytes.restype = i
    lib.nsf_fused_loss_scratch_floats.argtypes = [i, i, i]
    lib.nsf_fused_loss_scratch_floats.restype = ctypes.c_long
    lib.nsf_fused_loss_carry_floats.argtypes = [i, i, i, i]
    lib.nsf_fused_loss_carry_floats.restype = ctypes.c_long
    lib.nsf_fused_loss_weight_bytes.argtypes = [i, i, i]
    lib.nsf_fused_loss_weight_bytes.restype = ctypes.c_long
    return lib


def _weight_split(sizes, precision, dev) -> torch.Tensor:
    """Workspace for the launch's split copy of the hidden weights."""
    nbytes = _lib().nsf_fused_loss_weight_bytes(len(sizes) - 2, sizes[1], PARTS[precision])
    return torch.empty(nbytes, dtype=torch.uint8, device=dev)


def _carries(sizes, plan, precision, dev) -> Optional[torch.Tensor]:
    """The streamed plan's global regions, LOSS_BLOCKS blocks of them; None
    on the resident plan."""
    if not plan.streamed:
        return None
    floats = _lib().nsf_fused_loss_carry_floats(plan.tile, sizes[1], sizes[-1], PARTS[precision])
    return torch.empty(LOSS_BLOCKS * floats, dtype=torch.float32, device=dev)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_inputs(flat, sizes, x, e, vis_t, eq_w, evm, precision, plan):
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
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; one of {PRECISIONS}")
    if n % ROW_ALIGN != 0:
        raise ValueError(f"batch {n} must be padded to a multiple of {ROW_ALIGN}")
    return n, plan or loss_plan(sizes[1], precision, sizes[-1])


def _launch_args(flat, sizes, x, e, vis_t, eq_w, re, scale, evm, plan, precision):
    n_hidden = len(sizes) - 2
    return [_ptr(x), _ptr(flat), _ptr(e) if evm else None, _ptr(vis_t) if evm else None,
            _ptr(eq_w), x.shape[0], n_hidden, sizes[1], sizes[-1], plan.tile, plan.panel,
            LOSS_BLOCKS, PARTS[precision], float(re), float(scale), int(evm)]


class KernelLaunchError(RuntimeError):
    """A kernel's C interface returned a CUDA error code."""


def _raise_on(code: int, what: str):
    if code != 0:
        raise KernelLaunchError(f"{what}: CUDA error {code} at launch")


def fused_fwd(flat: torch.Tensor, sizes: Sequence[int], x: torch.Tensor,
              e: Optional[torch.Tensor], vis_t: Optional[torch.Tensor],
              eq_w: torch.Tensor, re: float, scale: float, evm: bool,
              precision: str = "high", plan: Optional[Plan] = None) -> torch.Tensor:
    """Kernel 1: the [3|4] weighted sums of squares, on `plan` (by default
    `loss_plan`'s)."""
    with _SPAN_FWD:
        e = e.contiguous() if evm else None
        n, plan = _check_inputs(flat, sizes, x, e, vis_t, eq_w, evm, precision, plan)
        partial = torch.empty(LOSS_BLOCKS * 4, dtype=torch.float32, device=x.device)
        out = torch.empty(4 if evm else 3, dtype=torch.float32, device=x.device)
        wsplit = _weight_split(sizes, precision, x.device)
        carries = _carries(sizes, plan, precision, x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            code = _lib().nsf_fused_loss_fwd(
                *_launch_args(flat, sizes, x, e, vis_t, eq_w, re, scale, evm, plan, precision),
                _ptr(wsplit), _ptr(partial), _ptr(out), stream, plan.kpanel, _ptr(carries))
        _raise_on(code, "fused residual loss forward")
        launch_counts["fused_residual_fwd"] += 1
        launch_rows["fused_residual_fwd"] += n
        count_weight_stream(weight_slots, weight_prefetch, "fused_residual_fwd", sizes, n, plan,
                            precision, False)
        return out


def fused_bwd(flat: torch.Tensor, sizes: Sequence[int], x: torch.Tensor,
              e: Optional[torch.Tensor], vis_t: Optional[torch.Tensor],
              eq_w: torch.Tensor, re: float, ct: torch.Tensor, scale: float,
              evm: bool, precision: str = "high",
              plan: Optional[Plan] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Kernel 2: (d(ct . S)/dflat, d(ct . S)/de) — the latter None if
    vanilla — on `plan` (by default `loss_plan`'s)."""
    with _SPAN_BWD:
        e = e.contiguous() if evm else None
        n, plan = _check_inputs(flat, sizes, x, e, vis_t, eq_w, evm, precision, plan)
        n_out = 4 if evm else 3
        ct = ct.to(device=x.device, dtype=torch.float32).contiguous().reshape(-1)
        if ct.numel() != n_out:
            raise ValueError(f"ct: need {n_out} cotangents, got {ct.numel()}")
        p = param_count(sizes)
        dev = x.device
        block_floats = _lib().nsf_fused_loss_scratch_floats(plan.tile, sizes[1], len(sizes) - 2)
        scratch = torch.empty(LOSS_BLOCKS * block_floats, dtype=torch.float32, device=dev)
        dpart = torch.empty(LOSS_BLOCKS * p, dtype=torch.float32, device=dev)
        dflat = torch.empty(p, dtype=torch.float32, device=dev)
        g_e = torch.empty((n, 1), dtype=torch.float32, device=dev) if evm else None
        wsplit = _weight_split(sizes, precision, dev)
        carries = _carries(sizes, plan, precision, dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = _lib().nsf_fused_loss_bwd(
                *_launch_args(flat, sizes, x, e, vis_t, eq_w, re, scale, evm, plan, precision),
                _ptr(wsplit), _ptr(ct), _ptr(scratch), _ptr(dpart), _ptr(dflat), _ptr(g_e), stream,
                plan.kpanel, _ptr(carries))
        _raise_on(code, "fused residual loss backward")
        launch_counts["fused_residual_bwd"] += 1
        launch_rows["fused_residual_bwd"] += n
        partial_reduce["fused_residual_bwd"] += -(-n // plan.tile) * p
        count_weight_stream(weight_slots, weight_prefetch, "fused_residual_bwd", sizes, n, plan,
                            precision, True)
        return dflat, g_e


class _FusedResidualLoss(torch.autograd.Function):
    """Kernel 1 forward, kernel 2 backward (the custom_vjp of
    pallas_residual.py:302-310). Gradients flow to flat and e only."""

    @staticmethod
    def forward(ctx, flat, x, e, vis_t, eq_w, re, sizes, scale, evm, precision):
        ctx.save_for_backward(flat, x, e, vis_t, eq_w)
        ctx.meta = (re, sizes, scale, evm, precision)
        return fused_fwd(flat, sizes, x, e, vis_t, eq_w, re, scale, evm, precision)

    @staticmethod
    def backward(ctx, ct):
        flat, x, e, vis_t, eq_w = ctx.saved_tensors
        re, sizes, scale, evm, precision = ctx.meta
        dflat, g_e = fused_bwd(flat, sizes, x, e, vis_t, eq_w, re, ct, scale, evm, precision)
        return dflat, None, g_e, None, None, None, None, None, None, None


def fused_residual_loss(flat: torch.Tensor, sizes: Sequence[int], x: torch.Tensor,
                        e: Optional[torch.Tensor], vis_t: Optional[torch.Tensor],
                        eq_w: torch.Tensor, re: float, *, coord_scale: float = 1.0,
                        evm: bool = True, precision: str = "high",
                        formulation: str = "velocity") -> torch.Tensor:
    """S_i = sum(eq_w * eq_i^2) for the MLP whose flat weights are `flat`
    (models/mlp.py layout, `sizes` its layer sizes); [4] with EVM, [3]
    vanilla (pass e = vis_t = None). Divide by the real-point count for the
    per-equation mean losses. The batch must be padded to ROW_ALIGN rows,
    with eq_w = 0 on pad rows. On a card the kernels run the bf16 passes of
    `precision`; on the CPU the plain version computes exact fp32.
    `formulation="streamfunction"`: the same sums of a (psi, p) net, S3 = 0,
    by kernel 5, the residual-glue kernels and kernel 6
    (ops/psi_residual.py)."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; one of {PRECISIONS}")
    if formulation == "streamfunction":
        from nsfnet_tpu_torch.ops.psi_residual import psi_residual_loss  # it imports this module

        return psi_residual_loss(flat, sizes, x, e, vis_t, eq_w, re, coord_scale=coord_scale,
                                 evm=evm, precision=precision)
    if formulation != "velocity":
        raise ValueError(f"unknown formulation {formulation!r}")
    if x.device.type == "cpu":
        return plain_residual_sums(unflatten_params(flat, sizes), x, e, vis_t, eq_w,
                                   re, coord_scale, evm)
    return _FusedResidualLoss.apply(flat, x, e, vis_t, eq_w, float(re), tuple(sizes),
                                    float(coord_scale), bool(evm), precision)
