"""The streamfunction formulation's equation loss on the card: kernel 5,
the residual-glue kernel pair, kernel 6.

`psi_residual_loss` is the streamfunction counterpart of
`fused_residual.fused_residual_loss` (which dispatches here for
`formulation="streamfunction"`): the weighted sums of squares
S_i = sum(eq_w * eq_i^2) of the (psi, p) net's momentum residuals and,
with the EVM net, its entropy residual; S3 (continuity) is 0, since
u = psi_y and v = -psi_x make it exact. On a card it runs

  * kernel 5 (`psi_streams.psi_fwd`): the thirteen raw [N,2] Taylor
    streams,
  * `psi_residual_fwd` (csrc/psi_residual.cu): the (u, v, p) bundle, the
    residuals and the per-block sums from those streams, in one pass, and
    the blocks' sums in a second, one-block launch,

and backward `psi_residual_bwd` (the streams' and e's cotangents, in one
pass) then kernel 6 (`psi_streams.psi_bwd`). The unfused path does the
same with kernel 5, ~100 PyTorch operations and kernel 6, and autograd
runs twice as many backward: the host's dispatch of those ~300 launches a
step came within 0.7-1.0x of the card's step (PERF.md, sections 5 and 7).

On a CPU tensor the plain version runs: the closed-form streams, then the
bundle, residuals and sums of ops/derivatives.py, ops/residuals.py and
ops/losses.py, differentiated by autograd, in exact fp32: the same
operations as the unfused path, so a CPU run gives the same numbers either
way. `plain_psi_residual_bwd` writes the glue's chain rule out in PyTorch,
as the backward kernel computes it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from nsfnet_tpu_torch.ops import _build
from nsfnet_tpu_torch.ops import losses as L
from nsfnet_tpu_torch.ops import psi_streams as PS
from nsfnet_tpu_torch.ops import residuals as R
from nsfnet_tpu_torch.ops.derivatives import N_PSI_STREAMS, assemble_psi_bundle
from nsfnet_tpu_torch.ops.fused_residual import _raise_on
from nsfnet_tpu_torch.ops.mlp_streams import _check_precision
from nsfnet_tpu_torch.utils import profiling

# Launches of each kernel pair member since the last reset (the forward's
# second, one-block launch is counted with it).
launch_counts = {"psi_residual_fwd": 0, "psi_residual_bwd": 0}
profiling.register("launches", launch_counts)
_SPAN_FWD = profiling.span("kernel.psi_residual_fwd")
_SPAN_BWD = profiling.span("kernel.psi_residual_bwd")


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def plain_psi_residual_sums(streams: Sequence[torch.Tensor], e: Optional[torch.Tensor],
                            vis_t: Optional[torch.Tensor], eq_w: torch.Tensor, re: float,
                            coord_scale: float = 1.0, evm: bool = True) -> torch.Tensor:
    """[4] (EVM) or [3] sums S_i = sum(eq_w * eq_i^2) from the thirteen raw
    streams, by the unfused path's operations (the bundle at
    uv_scale = coord_scale, as the solver's engine builds it)."""
    derivs = assemble_psi_bundle(streams, coord_scale)
    if evm:
        res = R.ev_ns_residuals(derivs, e, vis_t, re, coord_scale)
        eqs = (res.eq1, res.eq2, res.eq3, res.eq4)
    else:
        res = R.ns_residuals(derivs, re, coord_scale)
        eqs = (res.eq1, res.eq2, res.eq3)
    return torch.stack([L.masked_sum_sq(eq, eq_w) for eq in eqs])


def plain_psi_residual_bwd(streams: Sequence[torch.Tensor], e: Optional[torch.Tensor],
                           vis_t: Optional[torch.Tensor], eq_w: torch.Tensor, ct: torch.Tensor,
                           re: float, coord_scale: float = 1.0, evm: bool = True
                           ) -> Tuple[Tuple[torch.Tensor, ...], Optional[torch.Tensor]]:
    """The backward kernel's arithmetic in PyTorch: the cotangents of the
    thirteen [N,2] streams and of e ([N,1]; None without the EVM net) of
    ct . S, S the sums of `plain_psi_residual_sums`."""
    s = c = float(coord_scale)
    c2 = c * c
    col = lambda q: streams[q][:, 0:1]
    g_x, g_y = streams[1], streams[2]
    psi_xy = (col(7) - col(8)) * 0.25
    psi_xyy = ((col(11) + col(12)) - 2.0 * col(9)) / 6.0
    psi_xxy = ((col(11) - col(12)) - 2.0 * col(10)) / 6.0
    u, v = s * g_y[:, 0:1], -s * g_x[:, 0:1]
    u_x, v_x = (s * psi_xy) * c, (-s * col(5)) * c
    u_y, v_y = (s * col(6)) * c, (-s * psi_xy) * c
    u_xx, u_yy = (s * psi_xxy) * c2, (s * col(10)) * c2
    v_xx, v_yy = (-s * col(9)) * c2, (-s * psi_xyy) * c2
    nu = 1.0 / re + vis_t if evm else 1.0 / re
    eq1 = ((u * u_x + v * u_y) + g_x[:, 1:2] * c) - nu * (u_xx + u_yy)
    eq2 = ((u * v_x + v * v_y) + g_y[:, 1:2] * c) - nu * (v_xx + v_yy)
    r1, r2 = 2.0 * eq_w * eq1 * ct[0], 2.0 * eq_w * eq2 * ct[1]
    if evm:
        eq4 = (eq1 * (u - 0.5) + eq2 * (v - 0.5)) - e
        r4 = 2.0 * eq_w * eq4 * ct[3]
        t1, t2 = r1 + r4 * (u - 0.5), r2 + r4 * (v - 0.5)
        du, dv = t1 * u_x + t2 * v_x + r4 * eq1, t1 * u_y + t2 * v_y + r4 * eq2
    else:
        r4 = None
        t1, t2 = r1, r2
        du, dv = t1 * u_x + t2 * v_x, t1 * u_y + t2 * v_y
    dlap_u, dlap_v = -t1 * nu, -t2 * nu
    dpsi_xy = (s * c) * (t1 * u - t2 * v)
    dpsi_xxy, dpsi_xyy = (s * c2) * dlap_u, -(s * c2) * dlap_v
    dpsi_yyy = (s * c2) * dlap_u - dpsi_xxy / 3.0
    dpsi_xxx = -(s * c2) * dlap_v - dpsi_xyy / 3.0
    zero = torch.zeros_like(u)
    pair = lambda a, b=zero: torch.cat([a, b], dim=1)
    cts = (pair(zero), pair(-s * dv, c * t1), pair(s * du, c * t2), pair(zero), pair(zero),
           pair(-(s * c) * (t2 * u)), pair((s * c) * (t1 * v)), pair(0.25 * dpsi_xy),
           pair(-0.25 * dpsi_xy), pair(dpsi_xxx), pair(dpsi_yyy),
           pair((dpsi_xyy + dpsi_xxy) / 6.0), pair((dpsi_xyy - dpsi_xxy) / 6.0))
    return cts, (None if r4 is None else -r4)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    # built beside kernels 5+6's library, one nvcc process each, at once
    lib = _build.build_all(("psi_streams", "psi_residual"))["psi_residual"]
    p, f, i, n = ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_long
    common = [ctypes.POINTER(p), p, p, p, n, f, f, i]
    lib.nsf_psi_residual_fwd.argtypes = common + [p, p, p]
    lib.nsf_psi_residual_fwd.restype = i
    lib.nsf_psi_residual_bwd.argtypes = common + [p, ctypes.POINTER(p), p, p]
    lib.nsf_psi_residual_bwd.restype = i
    lib.nsf_psi_residual_partial_floats.argtypes = []
    lib.nsf_psi_residual_partial_floats.restype = i
    return lib


def _pointers(tensors):
    return (ctypes.c_void_p * N_PSI_STREAMS)(*(t.data_ptr() for t in tensors))


def _check(streams, e, vis_t, eq_w, evm) -> int:
    """Raises on what the glue kernels do not take; returns the batch size."""
    n, dev = eq_w.shape[0], eq_w.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {dev}")
    if len(streams) != N_PSI_STREAMS:
        raise ValueError(f"need the {N_PSI_STREAMS} streams, got {len(streams)}")
    named = [("stream", t, (n, 2)) for t in streams] + [("eq_w", eq_w, (n, 1))]
    if evm:
        named += [("e", e, (n, 1)), ("vis_t", vis_t, (n, 1))]
    for name, t, shape in named:
        if t is None or t.dtype != torch.float32 or t.device != dev \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: need contiguous float32 {shape} on {dev}")
    return n


def _args(streams, e, vis_t, eq_w, n, re, scale, evm):
    ptr = lambda t: None if t is None or not evm else t.data_ptr()
    return [_pointers(streams), ptr(e), ptr(vis_t), eq_w.data_ptr(), n, float(scale),
            1.0 / float(re), int(evm)]


def residual_fwd(streams: Sequence[torch.Tensor], e: Optional[torch.Tensor],
                 vis_t: Optional[torch.Tensor], eq_w: torch.Tensor, re: float, scale: float,
                 evm: bool) -> torch.Tensor:
    """The forward glue kernel: [4] (EVM) or [3] sums from kernel 5's
    streams, as `plain_psi_residual_sums` computes them."""
    with _SPAN_FWD:
        n, lib = _check(streams, e, vis_t, eq_w, evm), _lib()
        dev = eq_w.device
        partial = torch.empty(lib.nsf_psi_residual_partial_floats(), dtype=torch.float32,
                              device=dev)
        out = torch.empty(4 if evm else 3, dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = lib.nsf_psi_residual_fwd(*_args(streams, e, vis_t, eq_w, n, re, scale, evm),
                                            partial.data_ptr(), out.data_ptr(), stream)
        _raise_on(code, "psi residual forward")
        launch_counts["psi_residual_fwd"] += 1
        return out


def residual_bwd(streams: Sequence[torch.Tensor], e: Optional[torch.Tensor],
                 vis_t: Optional[torch.Tensor], eq_w: torch.Tensor, ct: torch.Tensor,
                 re: float, scale: float, evm: bool, want_e: bool = True
                 ) -> Tuple[Tuple[torch.Tensor, ...], Optional[torch.Tensor]]:
    """The backward glue kernel: the thirteen streams' [N,2] cotangents
    (views of one buffer, each contiguous, as kernel 6 reads them) and e's
    (None without the EVM net or where not `want_e`), from ct = d loss /
    d sums on the device."""
    with _SPAN_BWD:
        n, lib = _check(streams, e, vis_t, eq_w, evm), _lib()
        dev = eq_w.device
        if ct.dtype != torch.float32 or tuple(ct.shape) != (4 if evm else 3,) \
                or ct.device != dev:
            raise ValueError(f"ct: need float32 ({4 if evm else 3},) on {dev}")
        ct = ct.contiguous()
        cts = torch.empty((N_PSI_STREAMS, n, 2), dtype=torch.float32, device=dev).unbind(0)
        g_e = torch.empty((n, 1), dtype=torch.float32, device=dev) if evm and want_e else None
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = lib.nsf_psi_residual_bwd(*_args(streams, e, vis_t, eq_w, n, re, scale, evm),
                                            ct.data_ptr(), _pointers(cts),
                                            None if g_e is None else g_e.data_ptr(), stream)
        _raise_on(code, "psi residual backward")
        launch_counts["psi_residual_bwd"] += 1
        return cts, g_e


class _PsiResidualLoss(torch.autograd.Function):
    """Kernel 5 and the forward glue; backward the backward glue and kernel
    6. Gradients flow to flat and e only; the streams are kept for the
    backward (13 x N x 2 floats)."""

    @staticmethod
    def forward(ctx, flat, x, e, vis_t, eq_w, re, sizes, scale, evm, precision):
        _lib()  # both libraries built together on the first call
        streams = PS.psi_fwd(flat, sizes, x, precision)
        sums = residual_fwd(streams, e, vis_t, eq_w, re, scale, evm)
        ctx.save_for_backward(flat, x, e, vis_t, eq_w, *streams)
        ctx.meta = (re, sizes, scale, evm, precision)
        return sums

    @staticmethod
    def backward(ctx, ct):
        flat, x, e, vis_t, eq_w, *streams = ctx.saved_tensors
        re, sizes, scale, evm, precision = ctx.meta
        cts, g_e = residual_bwd(streams, e, vis_t, eq_w, ct.to(torch.float32), re, scale, evm,
                                ctx.needs_input_grad[2])
        return PS.psi_bwd(flat, sizes, x, cts, precision), None, g_e, None, None, None, None, \
            None, None, None


def psi_residual_loss(flat: torch.Tensor, sizes: Sequence[int], x: torch.Tensor,
                      e: Optional[torch.Tensor], vis_t: Optional[torch.Tensor],
                      eq_w: torch.Tensor, re: float, *, coord_scale: float = 1.0,
                      evm: bool = True, precision: str = "high") -> torch.Tensor:
    """S_i = sum(eq_w * eq_i^2), [4] with EVM (pass e, vis_t [N,1]) or [3]
    vanilla (None, None), of the (psi, p) MLP whose flat weights are `flat`
    (`sizes` its layer sizes, a head of 2), with u = s psi_y, v = -s psi_x
    at s = coord_scale. The batch must be padded to ROW_ALIGN rows, with
    eq_w = 0 on pad rows. On a card kernels 5+6 run the bf16 passes of
    `precision` and the glue fp32; on the CPU the plain version computes
    exact fp32."""
    _check_precision(precision)
    if sizes[-1] != 2:
        raise ValueError(f"the streamfunction loss needs a (psi, p) head, got K = {sizes[-1]}")
    if x.device.type == "cpu":
        return plain_psi_residual_sums(PS.plain_psi_streams(flat, sizes, x.detach()), e, vis_t,
                                       eq_w, re, coord_scale, evm)
    return _PsiResidualLoss.apply(flat, x, e.contiguous() if evm else None,
                                  vis_t.contiguous() if evm else None, eq_w, float(re),
                                  tuple(sizes), float(coord_scale), bool(evm), precision)
