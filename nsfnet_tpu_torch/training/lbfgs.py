"""L-BFGS with the zoom (strong-Wolfe) line search
(port of nsfnet_tpu/training/lbfgs.py).

The JAX package runs `optax.lbfgs(memory_size=10,
linesearch=optax.scale_by_zoom_linesearch(max_linesearch_steps=25))`: the
L-BFGS direction, a scale of -1 (no learning rate), then the line search.
This module copies that algorithm from optax 0.2.6 (Apache-2.0;
`alias.lbfgs`, `transform.scale_by_lbfgs`, `linesearch.zoom_linesearch` and
`linesearch.scale_by_zoom_linesearch`), with optax's settings as they are
there: memory 10 with the scaled initial preconditioner (the first step's
scale capped at 1/||g||); the line search's "keep" initial guess (a step
starts from the previous step's size), the Armijo test with slope_rtol
1e-4 or, near a minimum, Hager and Zhang's approximate-decrease test
(approx_dec_rtol 1e-6), the curvature test with curv_rtol 0.9, growth
factor 2, the cubic / quadratic / bisection interpolation with their
safeguards, the interval threshold (stepsize_precision) 1e-5, and the safe
step (the best point of sufficient decrease seen) when the search fails.

Design: the parameters are one flat tensor on the device. The L-BFGS memory
and its two-loop recursion stay there; the line search decides on the host,
in float64 (the JAX package decides on the device in the parameters'
dtype), from one read-back of (value, slope) per trial point. The call
pattern is run_lbfgs's: a fresh value-and-grad at each step, handed to the
line search; each trial point of the search is another value-and-grad of
the same loss.

The loss is the caller's: the solver hands in the closed-form loss in exact
fp32, the EVM carry frozen (the line search needs a stationary objective).
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from nsfnet_tpu_torch.logger import get_logger

MEMORY_SIZE = 10
MAX_LINESEARCH_STEPS = 25
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
INCREASE_FACTOR = 2.0
STEPSIZE_PRECISION = 1e-5  # the zoom phase's interval threshold
TOL = 0.0

ValueAndGrad = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


class LBFGSResult(NamedTuple):
    params: torch.Tensor          # the flat parameters after the last step
    history: List[float]          # the loss at the start of each step
    evaluations: List[int]        # value-and-grad evaluations of each step


class _Memory:
    """scale_by_lbfgs's state: the last params and gradient, and the ring of
    parameter / gradient differences with their weights 1 / (du . dw)."""

    def __init__(self, w: torch.Tensor, size: int):
        self.count = 0
        self.params = torch.zeros_like(w)
        self.updates = torch.zeros_like(w)
        self.dw = w.new_zeros((size, w.numel()))
        self.du = w.new_zeros((size, w.numel()))
        self.rho = w.new_zeros((size,))


def _lbfgs_direction(mem: _Memory, grad: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """P_k g: updates the memory with the fresh (params, grad) first, then
    applies the two-loop recursion (optax transform.scale_by_lbfgs; Nocedal
    and Wright, Algorithm 7.4). On the device, no host sync."""
    size = mem.rho.numel()
    idx, prev = mem.count % size, (mem.count - 1) % size
    if mem.count > 0:
        dw, du = params - mem.params, grad - mem.updates
        dot = du @ dw
        mem.dw[prev], mem.du[prev] = dw, du
        mem.rho[prev] = torch.where(dot == 0.0, torch.zeros_like(dot), 1.0 / dot)
        denom = du @ du
        gamma = torch.where(denom > 0.0, dot / denom, torch.ones_like(dot))
    else:
        # the first step: a capped reciprocal of the gradient norm
        gamma = torch.clamp(1.0 / torch.linalg.vector_norm(grad), max=1.0)
    order = [(idx + j) % size for j in range(size)]
    vec, alphas = grad, {}
    for i in reversed(order):
        alphas[i] = mem.rho[i] * (mem.dw[i] @ vec)
        vec = vec + (-alphas[i]) * mem.du[i]
    vec = gamma * vec
    for i in order:
        beta = mem.rho[i] * (mem.du[i] @ vec)
        vec = vec + (alphas[i] - beta) * mem.dw[i]
    mem.count += 1
    mem.params, mem.updates = params, grad
    return vec


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a; NaN where there is none (then unused)."""
    C = fpa
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    r0, r1 = fb - fa - C * db, fc - fa - C * dc
    A = (dc ** 2 * r0 + (-(db ** 2)) * r1) / denom
    B = ((-(dc ** 3)) * r0 + db ** 3 * r1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + np.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a."""
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * B)


def zoom_linesearch(value_and_grad: ValueAndGrad, params: torch.Tensor,
                    updates: torch.Tensor, value: float, grad: torch.Tensor,
                    stepsize_guess: float) -> Tuple[float, int]:
    """(stepsize, trial points evaluated) along `updates` from `params`
    (optax linesearch.zoom_linesearch: interval search, Nocedal and Wright
    Algorithm 3.5, then zoom, Algorithm 3.6)."""
    f = np.float64
    value_init = f(value)
    slope_init = f((updates @ grad).item())

    def trial(stepsize):
        v, g = value_and_grad(params + float(stepsize) * updates)
        val, slope = torch.stack([v.reshape(()), g @ updates]).tolist()
        return f(val), f(slope)

    def decrease_error(stepsize, value_step, slope_step):
        # Armijo (Nocedal and Wright 3.7a), or near a minimum the approximate
        # decrease test (Hager and Zhang eq. 23), whichever is smaller
        err = value_step - value_init - SLOPE_RTOL * stepsize * slope_init
        approx = slope_step - (2 * SLOPE_RTOL - 1.0) * slope_init
        delta = value_step - value_init - APPROX_DEC_RTOL * np.abs(value_init)
        err = np.minimum(np.maximum(approx, delta), err)
        err = np.maximum(err, f(0.0))
        return f(np.inf) if np.isnan(err) else err

    def curvature_error(slope_step):
        err = np.maximum(np.abs(slope_step) - CURV_RTOL * np.abs(slope_init), f(0.0))
        return f(np.inf) if np.isnan(err) else err

    s = dict(count=0, stepsize=f(0.0), value=value_init, slope=slope_init,
             decrease_error=f(np.inf), interval_found=False, done=False, failed=False,
             low=f(0.0), value_low=value_init, slope_low=slope_init,
             high=f(0.0), value_high=value_init, slope_high=slope_init,
             cubic_ref=f(0.0), value_cubic_ref=value_init,
             safe_stepsize=f(0.0), safe_value=value_init)

    def search_interval():
        new = f(stepsize_guess) if s["count"] == 0 else INCREASE_FACTOR * s["stepsize"]
        value_new, slope_new = trial(new)
        dec = decrease_error(new, value_new, slope_new)
        err = np.maximum(dec, curvature_error(slope_new))
        if dec <= TOL:  # kept in case the curvature test cannot be met
            s["safe_stepsize"], s["safe_value"] = new, value_new
        set_high = (dec > 0.0) or (value_new >= s["value"] and s["count"] > 0)
        set_low = slope_new >= 0.0 and not set_high
        prev = (s["stepsize"], s["value"], s["slope"])
        lo, hi = ((new, value_new, slope_new), prev) if set_low else (prev, (new, value_new, slope_new))
        s.update(low=lo[0], value_low=lo[1], slope_low=lo[2],
                 high=hi[0], value_high=hi[1], slope_high=hi[2],
                 cubic_ref=lo[0], value_cubic_ref=lo[1])
        s["interval_found"] = set_high or set_low or err <= TOL
        s["done"] = err <= TOL
        s["failed"] = s["count"] + 1 >= MAX_LINESEARCH_STEPS and not s["done"]
        s.update(count=s["count"] + 1, stepsize=new, value=value_new, slope=slope_new,
                 decrease_error=dec)

    def zoom():
        low, high = s["low"], s["high"]
        delta = np.abs(high - low)
        left, right = np.minimum(high, low), np.maximum(high, low)
        too_small = delta <= STEPSIZE_PRECISION
        middle_cubic = _cubicmin(low, s["value_low"], s["slope_low"], high, s["value_high"],
                                 s["cubic_ref"], s["value_cubic_ref"])
        middle_quad = _quadmin(low, s["value_low"], s["slope_low"], high, s["value_high"])
        if left + 0.2 * delta < middle_cubic < right - 0.2 * delta:
            middle = middle_cubic
        elif left + 0.1 * delta < middle_quad < right - 0.1 * delta:
            middle = middle_quad
        else:
            middle = (low + high) / 2.0
        value_mid, slope_mid = trial(middle)
        dec = decrease_error(middle, value_mid, slope_mid)
        err = np.maximum(dec, curvature_error(slope_mid))
        if dec <= TOL and value_mid < s["safe_value"]:  # the best safe point so far
            s["safe_stepsize"], s["safe_value"] = middle, value_mid
        done = err <= TOL
        set_high_to_mid = dec > 0.0 or value_mid >= s["value_low"]
        set_high_to_low = slope_mid * (high - low) >= 0.0 and not set_high_to_mid
        old_low = (low, s["value_low"], s["slope_low"])
        old_high = (high, s["value_high"], s["slope_high"])
        mid = (middle, value_mid, slope_mid)
        new_high = old_low if set_high_to_low else (mid if set_high_to_mid else old_high)
        new_low = old_low if set_high_to_mid else mid
        ref = old_high if (set_high_to_mid or set_high_to_low) else old_low
        s.update(low=new_low[0], value_low=new_low[1], slope_low=new_low[2],
                 high=new_high[0], value_high=new_high[1], slope_high=new_high[2],
                 cubic_ref=ref[0], value_cubic_ref=ref[1])
        presumably_failed = (s["count"] + 1 >= MAX_LINESEARCH_STEPS) or (too_small and s["safe_stepsize"] > 0.0)
        s["done"], s["failed"] = done, presumably_failed and not done
        s.update(count=s["count"] + 1, stepsize=middle, value=value_mid, slope=slope_mid,
                 decrease_error=dec)

    with np.errstate(all="ignore"):
        while not (s["done"] or s["failed"]):
            zoom() if s["interval_found"] else search_interval()
            if s["failed"] and (s["safe_stepsize"] > 0.0 or np.isinf(s["decrease_error"])):
                # the safe step: sufficient decrease without the curvature test
                s["stepsize"], s["value"] = s["safe_stepsize"], s["safe_value"]
    return float(s["stepsize"]), s["count"]


def chunking(n_steps: int, max_chunk: int) -> Tuple[int, int]:
    """(chunk, chunks): n_steps rounded up to whole chunks of at most
    max_chunk steps, as the JAX package's fixed-length device dispatches
    round them (its log line kept); a polish stage counts every step run."""
    chunk = max(1, min(int(max_chunk), int(n_steps)))
    n_chunks = -(-int(n_steps) // chunk)
    overshoot = n_chunks * chunk - int(n_steps)
    if overshoot:
        get_logger().info(f"lbfgs/lm: running {n_chunks * chunk} steps ({overshoot} over the "
                          f"requested {int(n_steps)}: fixed {chunk}-step chunks compile once)")
    return chunk, n_chunks


def run_lbfgs(value_and_grad: ValueAndGrad, params: torch.Tensor, n_steps: int,
              max_chunk: int = 50,
              progress: Optional[Callable[[int, float], None]] = None,
              guard: Callable = contextlib.nullcontext) -> LBFGSResult:
    """Minimize a loss of the flat vector `params` for n_steps L-BFGS steps,
    rounded up to whole chunks of `max_chunk` steps as the JAX package's are
    (its chunks are single device dispatches; here they are the points at
    which `progress(steps_done, last_loss)` runs and `guard()`, a context
    manager entered around each chunk, may deliver a deferred signal).
    `value_and_grad(w) -> (loss, d loss / dw)`."""
    chunk, n_chunks = chunking(n_steps, max_chunk)
    w = params.detach().clone()
    mem = _Memory(w, MEMORY_SIZE)
    learning_rate = 1.0  # the "keep" strategy's first guess
    history, evaluations = [], []
    for i in range(n_chunks):
        with guard():
            for _ in range(chunk):
                value, grad = value_and_grad(w)
                value = value.item()
                updates = -_lbfgs_direction(mem, grad, w)
                learning_rate, trials = zoom_linesearch(value_and_grad, w, updates, value,
                                                        grad, learning_rate)
                w = w + learning_rate * updates
                history.append(value)
                evaluations.append(1 + trials)
        if progress is not None:
            progress((i + 1) * chunk, history[-1])
    return LBFGSResult(w, history, evaluations)
