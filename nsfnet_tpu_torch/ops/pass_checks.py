"""The bars at which the forward kernels 3 and 5 are held against their
plain versions' passes, and the witness that argues them.

Kernels 3 and 5 and their plain versions (`plain_mlp_streams`,
`plain_psi_streams` at a name) run the same bf16 products; only the order in
which their fp32 sums round differs. Per stream, norm-wise
(`norm_rels`: ||a - b|| / ||b||):

  * "high" (three passes). Where a carry's fp32 value lies on a rounding
    edge of its low bf16 part, a last-bit difference flips that part and
    moves the point by ~2^-16 of a term, about as far as bf16x3 itself sits
    from exact fp32, so a point-wise bar cannot tell three passes from
    fp32. `separation` can: the distance of an output from the plain "high"
    passes over exact fp32's distance from them. Exact fp32 gives 1 by
    construction and the six passes of "highest" about 1; an output of the
    same three passes shares their truncation and gives less. HIGH_SEP is
    the bar.
  * "default" (one pass): the same flips on the carry's only part move the
    point by ~2^-8 of a term, so the kernels are held norm-wise at
    DEFAULT_NORM_TOL, which the plain "high" passes miss against the plain
    one pass.

`carry_flips` is the witness: the plain version against itself with its
sums rounded once (`fused_residual.sums_rounded_once`), counting the carries
whose bf16 parts differ between the two and the share of the distance that
lies on their points.

The separation bar tells the names apart only while the kernel's own fp32
accumulation (mma.sync adds a product chunk of 16 into the fp32 accumulator
per step, K / 16 steps per pass) moves an output less than bf16x3's
truncation does. Both grow with the product depth K, the accumulation
faster: on the H100 the kernels read 0.49-0.68 up to K = 352 and 1.03
(five streams) / 1.21 (order 3) at K = 1024, where the witness still reads
0.33 / 0.37 and the plain "highest" passes 0.99 (PERF.md, section 6).
HIGH_SEP_MAX_K is the deepest K at which the bar is gated; deeper, the
figure is reported and the name is held by the streamed plan's bitwise
equality with the resident plan at a resident tile (the same passes) and by
the point-wise bars against the plain passes and exact fp32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Sequence

import torch

from nsfnet_tpu_torch.ops import fused_residual as fr

HIGH_SEP = 0.8
HIGH_SEP_MAX_K = 352
DEFAULT_NORM_TOL = 2e-3


def norm_rels(got: Sequence[torch.Tensor], ref: Sequence[torch.Tensor]) -> List[float]:
    """||got - ref|| / ||ref|| of each stream."""
    return [((g - r).norm() / r.norm().clamp_min(1e-30)).item() for g, r in zip(got, ref)]


def _rms(v: Sequence[float]) -> float:
    return math.sqrt(sum(e * e for e in v) / len(v))


def separation(got: Sequence[torch.Tensor], plain_high: Sequence[torch.Tensor],
               exact: Sequence[torch.Tensor]) -> float:
    """How far `got` sits from the plain "high" passes, over how far exact
    fp32 sits from them, each the root mean square of the streams'
    norm-wise distances."""
    return _rms(norm_rels(got, plain_high)) / _rms(norm_rels(exact, plain_high))


def carry_flips(plain: Callable[[], Sequence[torch.Tensor]], n: int) -> Dict:
    """Runs `plain` (a plain version at a name on n points) with fp32 sums
    and with its sums rounded once. Returns both outputs ("fp32",
    "rounded_once"), the carries whose bf16 parts differ between the runs
    at each product ("flips"; rows of the packed carry are stream-major,
    row q*n + point), the points that hold one ("points"), the share of the
    squared distance between the outputs on those points ("share") and the
    largest norm-wise distance of a stream ("norm_rel")."""
    carries: List[List[torch.Tensor]] = []
    passes_mm = fr._passes_mm

    def recording(a, b, parts):
        carries[-1].append(torch.stack(fr.bf16_split(a, parts)).to(torch.bfloat16))
        return passes_mm(a, b, parts)

    outs = []
    fr._passes_mm = recording
    try:
        for rounded in (False, True):
            carries.append([])
            with fr.sums_rounded_once() if rounded else contextlib.nullcontext():
                outs.append(plain())
    finally:
        fr._passes_mm = passes_mm
    flips, points = [], None
    for a, b in zip(*carries):
        differ = (a != b).any(0)
        flips.append(int(differ.sum()))
        at = differ.any(1).view(-1, n).any(0)
        points = at if points is None else points | at
    sq = sum(((w - p) ** 2).sum(1) for w, p in zip(outs[1], outs[0]))
    total = sq.sum().item()
    return {"fp32": outs[0], "rounded_once": outs[1], "flips": flips,
            "points": int(points.sum()), "n": n,
            "share": sq[points].sum().item() / total if total > 0 else 1.0,
            "norm_rel": max(norm_rels(outs[1], outs[0]))}
