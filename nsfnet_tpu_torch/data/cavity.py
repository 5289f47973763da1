"""Lid-driven cavity dataset generation and DNS evaluation data.

The port's copy of nsfnet_tpu/data/cavity.py on its numpy sampling path
(capability parity with the reference DataLoader, ev-NSFnet/cavity_data.py):

  * Boundary set: 513 points per edge (2052 total); lid profile
    u = 1 - cosh(r(x-0.5))/cosh(r/2) with r=10 (regularized corners);
    no-slip elsewhere (cavity_data.py:47-94).
  * Interior set: Latin-Hypercube N_f points, optionally sorted by
    distance-to-boundary (cavity_data.py:96-116).
  * SDF weights: w = min_w + (1-min_w)*exp(-decay*d), mean-normalized
    (cavity_data.py:118-130), with the closed-form distance to the square.
  * Coordinate transform [0,1] -> [-1,1] with chain-rule scale 2
    (cavity_data.py:135-142).
  * DNS eval fields from .mat (X/Y/U/V/P_ref) (cavity_data.py:144-160).

For the same seed it draws the same points as the JAX package's
`CavityData(use_native=False)`. The native sampler, residual-aware
resampling and sampler-state checkpointing come in a later slice.

All outputs are float32 numpy arrays shaped [N, 1] per channel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from nsfnet_tpu_torch.data.sampling import (
    boundary_distance_box,
    latin_hypercube,
    sort_by_boundary_distance,
)

LID_REG_CONST = 10.0   # cosh regularization constant r (cavity_data.py:52)
POINTS_PER_EDGE = 513  # Nx = Ny = 513 (cavity_data.py:49-50)


def lid_velocity(x: np.ndarray, r: float = LID_REG_CONST) -> np.ndarray:
    """Regularized lid profile: 1 - cosh(r(x-1/2))/cosh(r/2)
    (cavity_data.py:55). Zero at the corners; ~1 mid-lid."""
    return 1.0 - np.cosh(r * (x - 0.5)) / np.cosh(r * 0.5)


@dataclasses.dataclass
class CavityData:
    """Dataset factory for the unit-square cavity (constructor knobs of the
    reference DataLoader, cavity_data.py:26)."""

    N_f: int = 20000
    sort_training_points: bool = True
    sdf_enabled: bool = False
    sdf_min_weight: float = 0.2
    sdf_decay: float = 5.0
    coord_transform: bool = False
    seed: Optional[int] = None

    def __post_init__(self):
        # domain bounds in the TRAINING frame; generation is on the unit square
        lo, hi = (-1.0, 1.0) if self.coord_transform else (0.0, 1.0)
        self.x_min, self.x_max = lo, hi
        self.y_min, self.y_max = lo, hi
        self._rng = np.random.default_rng(self.seed)
        self.pts_bc: Optional[np.ndarray] = None
        self.sdf_weights: Optional[np.ndarray] = None

    @property
    def coord_scale(self) -> float:
        """Chain-rule factor for the [0,1] -> [-1,1] transform
        (cavity_data.py:45)."""
        return 2.0 if self.coord_transform else 1.0

    def _to_centered(self, a: np.ndarray) -> np.ndarray:
        return a * 2.0 - 1.0

    def boundary_data(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(x_b, y_b, u_b, v_b), each [4*513, 1] float32; order: bottom,
        top(lid), left, right (cavity_data.py:56-72)."""
        n = POINTS_PER_EDGE
        line = np.linspace(0.0, 1.0, n)
        x_b = np.concatenate([line, line, np.zeros(n), np.ones(n)])
        y_b = np.concatenate([np.zeros(n), np.ones(n), line, line])
        u_b = np.concatenate([np.zeros(n), lid_velocity(line), np.zeros(n), np.zeros(n)])
        v_b = np.zeros_like(x_b)

        pts = np.stack([x_b, y_b], axis=1)
        if self.coord_transform:
            pts = self._to_centered(pts)
            x_b, y_b = pts[:, 0], pts[:, 1]
        self.pts_bc = pts
        col = lambda a: a.reshape(-1, 1).astype(np.float32)
        return col(x_b), col(y_b), col(u_b), col(v_b)

    def training_data(self) -> Tuple[np.ndarray, np.ndarray]:
        """(x_f, y_f) interior Latin-Hypercube collocation points
        (cavity_data.py:96-116). Requires boundary_data() first (to fix the
        coordinate frame), like the reference. Each call draws fresh points."""
        if self.pts_bc is None:
            raise RuntimeError("load boundary data first (fixes the coordinate frame)")
        xye = latin_hypercube(self.N_f, [[0.0, 1.0], [0.0, 1.0]], rng=self._rng)
        if self.coord_transform:
            xye = self._to_centered(xye)
        if self.sort_training_points:
            xye = sort_by_boundary_distance(xye, self.pts_bc)
        self.sdf_weights = (self._compute_sdf_weights(xye) if self.sdf_enabled
                            else None)
        col = lambda a: a.reshape(-1, 1).astype(np.float32)
        return col(xye[:, 0]), col(xye[:, 1])

    def _compute_sdf_weights(self, pts: np.ndarray) -> np.ndarray:
        """w = min_w + (1-min_w)*exp(-decay*d), mean-normalized
        (cavity_data.py:118-130)."""
        d = boundary_distance_box(pts, lo=self.x_min, hi=self.x_max)
        min_w = float(np.clip(self.sdf_min_weight, 1e-6, 1.0))
        decay = max(0.0, float(self.sdf_decay))
        w = min_w + (1.0 - min_w) * np.exp(-decay * d)
        mean_w = w.mean()
        if mean_w > 0:
            w = w / mean_w
        return w.astype(np.float32)

    def evaluate_data(self, filename: str):
        """Load DNS reference fields X/Y/U/V/P_ref from a .mat file
        (cavity_data.py:144-160). Returns 5 columns [M, 1] float32 (P may
        contain NaN, masked downstream)."""
        import scipy.io

        data = scipy.io.loadmat(filename)
        x, y = data["X_ref"], data["Y_ref"]
        u, v, p = data["U_ref"], data["V_ref"], data["P_ref"]
        if self.coord_transform:
            x, y = self._to_centered(x), self._to_centered(y)
        col = lambda a: np.asarray(a).reshape(-1, 1).astype(np.float32)
        return col(x), col(y), col(u), col(v), col(p)
