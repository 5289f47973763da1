"""The comparison that decides `correct` for a training cell.

An Adam cell's three numbers, each against the reference's three steps
from the same inputs:
  * loss_gap: the first step's loss, the largest relative gap over its terms
    (those the configuration's reference names in its `TERMS`, in order:
    the boundary term is most of the total at the start, so the equation
    terms, which the loss kernels sum, are compared apart; a term that is 0
    by construction, as continuity in the streamfunction formulation, is
    left out there, since it has no relative gap);
  * grad_gap: the first gradient as the optimizer got it (Adam's first
    moment after one step, over 1 - b1), by the worst leaf: the gap between
    the program's norm of the leaf and the reference's, over the larger of
    the reference's norm of that leaf and of the median leaf;
  * delta_gap: the change of the weights over the steps, by the median
    leaf: the median over the leaves of that gap. A leaf whose reference
    gradient is under a thousandth of the median leaf's moves by round-off
    alone and is left out.
The later steps' losses and the worst leaf's change are not compared: Adam
scales each weight's step by its own gradient's size, so the pressure head's
weights, whose gradients at the start are near Adam's epsilon, move by an
amount that magnifies the kernels' rounding (PERF.md gives the readings).
A polish cell adds its stage's numbers (drivers/lbfgs.py). Each cell's
limits sit in limits/<cell>.json; PERF.md gives the readings they were set
from.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence

import torch

ROUND_OFF_LEAF = 1e-3


def _worst(gaps) -> float:
    """The largest gap; NaN reads as infinitely far."""
    return max(g if g == g else math.inf for g in gaps)


def _norms(leaves: Sequence[torch.Tensor]) -> List[float]:
    return [float(t.double().norm()) for t in leaves]


def leaf_gaps(prog: Sequence[torch.Tensor], ref: Sequence[torch.Tensor],
              keep: Sequence[bool] = None) -> List[float]:
    """Each kept leaf's gap of norms, over the larger of its reference norm
    and the median leaf's; NaN reads as infinitely far."""
    p, r = _norms(prog), _norms(ref)
    floor = statistics.median(r)
    keep = keep or [True] * len(r)
    gaps = [abs(a - b) / max(b, floor) if max(b, floor) > 0 else math.inf
            for a, b, k in zip(p, r, keep) if k]
    return [g if g == g else math.inf for g in gaps]


def worst_leaf_gap(prog, ref, keep=None) -> float:
    return _worst(leaf_gaps(prog, ref, keep))


def median_leaf_gap(prog, ref, keep=None) -> float:
    return statistics.median(leaf_gaps(prog, ref, keep))


def term_gaps(prog: dict, ref: dict, terms: Sequence[str]) -> Dict[str, float]:
    """Each loss term's relative gap at the first step, by the names
    `terms` of the losses' entries (for the record of what sets
    loss_gap)."""
    return {t: relative_gap([p], [r])
            for t, p, r in zip(terms, prog["losses"][0], ref["losses"][0])}


def relative_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    """The largest relative gap of a list of values."""
    gaps = [abs(a - b) / abs(b) if b != 0 else math.inf for a, b in zip(prog, ref)]
    return _worst(gaps + ([math.inf] if len(prog) != len(ref) else []))


def moved_leaves(first_grad: Sequence[torch.Tensor]) -> List[bool]:
    """The leaves whose reference gradient is not nought to round-off."""
    g = _norms(first_grad)
    med = statistics.median(g)
    return [x >= ROUND_OFF_LEAF * med for x in g]


def readings(prog: dict, ref: dict, start: Sequence[torch.Tensor]) -> Dict[str, float]:
    """prog / ref: {"losses": [[a step's loss terms], ...], "first_grad": [leaves],
    "params": [leaves after the steps]}; `start`: the weights both began
    from, as leaves."""
    keep = moved_leaves(ref["first_grad"])
    delta = lambda d: [a - s for a, s in zip(d["params"], start)]
    return {
        "loss_gap": relative_gap(prog["losses"][0], ref["losses"][0]),
        "grad_gap": worst_leaf_gap(prog["first_grad"], ref["first_grad"]),
        "delta_gap": median_leaf_gap(delta(prog), delta(ref), keep),
    }


def not_compared(prog: dict, ref: dict, start: Sequence[torch.Tensor]) -> Dict[str, float]:
    """The readings left out of the check, for the record: the loss over all
    the steps and the worst leaf's change."""
    delta = lambda d: [a - s for a, s in zip(d["params"], start)]
    return {"loss_gap_all_steps": _worst(relative_gap(p, r) for p, r in
                                         zip(prog["losses"], ref["losses"])),
            "delta_gap_worst_leaf": worst_leaf_gap(delta(prog), delta(ref),
                                                   moved_leaves(ref["first_grad"]))}


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """{name: {"value", "limit", "ok"}} for each limit; a number that is not
    finite fails."""
    out = {}
    for name in limits:
        v, lim = float(values[name]), float(limits[name])
        out[name] = {"value": v, "limit": lim, "ok": math.isfinite(v) and v <= lim}
    return out
