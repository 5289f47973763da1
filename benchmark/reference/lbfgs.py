"""Plain reference of L-BFGS with the zoom line search, as optax 0.2.6 runs it
with the settings the configurations' polish stages state:
`optax.lbfgs(memory_size=10, linesearch=optax.scale_by_zoom_linesearch(
max_linesearch_steps=25))`.

A step: the gradient g at w, the direction d = -H g by the two-loop
recursion over the last 10 pairs (s, y) (Nocedal and Wright, Algorithm 7.4),
H's initial scale s.y / y.y of the newest pair, or min(1, 1/|g|) at the first
step; then a step size along d by the zoom line search (Nocedal and Wright,
Algorithms 3.5 and 3.6, in optax's form): the first trial is the previous
step's size (1 at the first step), doubled while the interval is not found;
a trial is accepted when the decrease error (Armijo with c1 1e-4, or near a
minimum Hager and Zhang's approximate decrease with 1e-6 |f|, whichever is
smaller) and the curvature error (|slope| against 0.9 |slope_0|) are both 0;
inside an interval the trial is the cubic minimiser where it lies in the
middle 60% of the interval, else the quadratic one in the middle 80%, else
the midpoint; after 25 trials, or an interval under 1e-5 with a point of
sufficient decrease seen, the search stops at the best such point. Values
and slopes are read back to the host and decided on in float64; the
vectors stay in float32 on the device.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch

MEMORY = 10
MAX_TRIALS = 25
C1, C2, APPROX_DECREASE = 1e-4, 0.9, 1e-6
GROWTH = 2.0
MIN_INTERVAL = 1e-5

F = np.float64


def _direction(g: torch.Tensor, pairs: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
               gamma: torch.Tensor) -> torch.Tensor:
    """H g by the two-loop recursion; `pairs` (s, y, rho) oldest first."""
    q, alphas = g, []
    for s, y, rho in reversed(pairs):
        a = rho * (s @ q)
        alphas.append(a)
        q = q - a * y
    r = gamma * q
    for (s, y, rho), a in zip(pairs, reversed(alphas)):
        r = r + (a - rho * (y @ r)) * s
    return r


def _cubic_min(a, fa, fpa, b, fb, c, fc):
    """The minimiser of the cubic through (a, fa) with slope fpa, (b, fb) and
    (c, fc); NaN where it has none."""
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    r0, r1 = fb - fa - fpa * db, fc - fa - fpa * dc
    A = (dc ** 2 * r0 - db ** 2 * r1) / denom
    B = (-(dc ** 3) * r0 + db ** 3 * r1) / denom
    return a + (-B + np.sqrt(B * B - 3.0 * A * fpa)) / (3.0 * A)


def _quad_min(a, fa, fpa, b, fb):
    db = b - a
    return a - fpa / (2.0 * (fb - fa - fpa * db) / db ** 2)


def line_search(f: Callable, w: torch.Tensor, d: torch.Tensor, f0: float, g0: torch.Tensor,
                guess: float) -> Tuple[float, int]:
    """(step size, trials) of the zoom line search along d from w."""
    f0, s0 = F(f0), F((d @ g0).item())

    def trial(t):
        v, g = f(w + float(t) * d)
        return F(v), F((g @ d).item())

    def dec_err(t, v, s):
        armijo = v - f0 - C1 * t * s0
        approx = np.maximum(s - (2 * C1 - 1.0) * s0, v - f0 - APPROX_DECREASE * np.abs(f0))
        e = np.maximum(np.minimum(approx, armijo), F(0.0))
        return F(np.inf) if np.isnan(e) else e

    def curv_err(s):
        e = np.maximum(np.abs(s) - C2 * np.abs(s0), F(0.0))
        return F(np.inf) if np.isnan(e) else e

    n, cur = 0, (F(0.0), f0, s0)       # the last trial: (t, f, slope)
    lo = hi = (F(0.0), f0, s0)
    ref = (F(0.0), f0)                 # the cubic's third point
    safe = (F(0.0), f0)                # the best point of sufficient decrease
    found = done = failed = False
    last_dec = F(np.inf)
    while not (done or failed):
        if not found:
            t = F(guess) if n == 0 else GROWTH * cur[0]
            v, s = trial(t)
            dec = dec_err(t, v, s)
            if dec <= 0.0:
                safe = (t, v)
            up = dec > 0.0 or (v >= cur[1] and n > 0)
            down = s >= 0.0 and not up
            lo, hi = ((t, v, s), cur) if down else (cur, (t, v, s))
            ref = (lo[0], lo[1])
            done = np.maximum(dec, curv_err(s)) <= 0.0
            found = up or down or done
            failed = n + 1 >= MAX_TRIALS and not done
        else:
            width = np.abs(hi[0] - lo[0])
            left, right = np.minimum(hi[0], lo[0]), np.maximum(hi[0], lo[0])
            cubic = _cubic_min(lo[0], lo[1], lo[2], hi[0], hi[1], ref[0], ref[1])
            quad = _quad_min(lo[0], lo[1], lo[2], hi[0], hi[1])
            if left + 0.2 * width < cubic < right - 0.2 * width:
                t = cubic
            elif left + 0.1 * width < quad < right - 0.1 * width:
                t = quad
            else:
                t = (lo[0] + hi[0]) / 2.0
            v, s = trial(t)
            dec = dec_err(t, v, s)
            if dec <= 0.0 and v < safe[1]:
                safe = (t, v)
            done = np.maximum(dec, curv_err(s)) <= 0.0
            mid_is_high = dec > 0.0 or v >= lo[1]
            low_is_high = s * (hi[0] - lo[0]) >= 0.0 and not mid_is_high
            ref = (hi[0], hi[1]) if (mid_is_high or low_is_high) else (lo[0], lo[1])
            lo, hi = (lo, (t, v, s)) if mid_is_high else \
                ((t, v, s), lo if low_is_high else hi)
            failed = not done and (n + 1 >= MAX_TRIALS or (width <= MIN_INTERVAL and safe[0] > 0.0))
        n += 1
        cur, last_dec = (t, v, s), dec
        if failed and (safe[0] > 0.0 or np.isinf(last_dec)):
            cur = (safe[0], safe[1], cur[2])
    return float(cur[0]), n


def minimize(f: Callable, w0: torch.Tensor, n_steps: int):
    """`n_steps` L-BFGS steps of f(w) -> (value, gradient) from w0. Returns
    (w, the value at the start of each step, the evaluations of each step)."""
    w, pairs = w0.detach().clone(), []
    prev = None
    step_size = 1.0
    history, evaluations = [], []
    with np.errstate(all="ignore"):
        for _ in range(n_steps):
            v, g = f(w)
            v = float(v)
            if prev is None:
                gamma = torch.clamp(1.0 / torch.linalg.vector_norm(g), max=1.0)
            else:
                s, y = w - prev[0], g - prev[1]
                sy, yy = y @ s, y @ y
                pairs = (pairs + [(s, y, torch.where(sy == 0.0, torch.zeros_like(sy),
                                                     1.0 / sy))])[-MEMORY:]
                gamma = torch.where(yy > 0.0, sy / yy, torch.ones_like(sy))
            prev = (w, g)
            d = -_direction(g, pairs, gamma)
            step_size, trials = line_search(f, w, d, v, g, step_size)
            w = w + step_size * d
            history.append(v)
            evaluations.append(1 + trials)
    return w, history, evaluations
