"""Collocation-point sampling utilities.

Capability parity with the reference's tools.py (LHSample, sort_pts) but
vectorized: the reference builds Latin-Hypercube samples with a double
Python loop (tools.py:30-57) and sorts points with an O(N_f * N_b)
pure-Python nearest-distance scan (tools.py:59-83). Both are one-time setup
costs, but at N_f=120k the reference's sort takes minutes; these are
numpy-vectorized and run in milliseconds.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def latin_hypercube(
    n: int,
    bounds: Sequence[Sequence[float]],
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Latin-Hypercube sample of n points in a D-dim box.

    Per dimension: one uniform draw inside each of n equal strata, then a
    random permutation of the strata (the same scheme as tools.py:30-57).
    Returns [n, D] float64.
    """
    rng = rng or np.random.default_rng()
    bounds_arr = np.asarray(bounds, dtype=np.float64)
    d = bounds_arr.shape[0]
    u = (np.arange(n)[:, None] + rng.random((n, d))) / n  # stratified in [0,1)
    for j in range(d):
        u[:, j] = u[rng.permutation(n), j]
    lo, hi = bounds_arr[:, 0], bounds_arr[:, 1]
    return u * (hi - lo) + lo


def boundary_distance_box(pts: np.ndarray, lo=0.0, hi=1.0) -> np.ndarray:
    """Closed-form distance to the boundary of an axis-aligned square box.

    Equals the reference's KD-tree query against the 2052 discrete boundary
    points (ev-NSFnet/cavity_data.py:118-126) up to half the boundary-point
    spacing (~1e-3); exact, O(N), no tree needed.
    """
    x, y = pts[:, 0], pts[:, 1]
    return np.minimum.reduce([x - lo, hi - x, y - lo, hi - y]).clip(min=0.0)


def min_distance_to_points(pts: np.ndarray, ref_pts: np.ndarray,
                           chunk: int = 8192) -> np.ndarray:
    """Vectorized min Euclidean distance from each pt to a reference set
    (the general form of tools.py:63-66, for non-box domains)."""
    out = np.empty(pts.shape[0], dtype=np.float64)
    for s in range(0, pts.shape[0], chunk):
        block = pts[s:s + chunk]
        d2 = ((block[:, None, :] - ref_pts[None, :, :]) ** 2).sum(-1)
        out[s:s + chunk] = np.sqrt(d2.min(axis=1))
    return out


def sort_by_boundary_distance(pts: np.ndarray, boundary_pts: np.ndarray,
                              reverse: bool = False) -> np.ndarray:
    """Sort points by distance to the nearest boundary point
    (tools.py:68-83), vectorized."""
    dists = min_distance_to_points(pts, boundary_pts)
    order = np.argsort(dists)
    if reverse:
        order = order[::-1]
    return pts[order]
