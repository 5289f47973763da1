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

Two sampling paths, as in the JAX package (nsfnet_tpu/data/cavity.py):
numpy (the default here: `use_native=False`) and the native sampler
(`use_native=True`: native/pointgen.cpp through data/native.py, which the
port builds itself). For the same seed and path it draws the same points as
the JAX package, and the two exchange sampler states: a state written by
either replays bit for bit in the other (`get_state` / `set_state`,
residual-aware draws included). A state names the path that wrote it, and
`set_state` switches the dataset to that path.

All outputs are float32 numpy arrays shaped [N, 1] per channel.
"""

from __future__ import annotations

import base64
import dataclasses
from typing import Optional, Tuple

import numpy as np

from nsfnet_tpu_torch.data import native
from nsfnet_tpu_torch.logger import get_logger
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
    use_native: bool = False  # the native sampler (data/native.py) instead of numpy

    def __post_init__(self):
        # domain bounds in the TRAINING frame; generation is on the unit square
        lo, hi = (-1.0, 1.0) if self.coord_transform else (0.0, 1.0)
        self.x_min, self.x_max = lo, hi
        self.y_min, self.y_max = lo, hi
        self._rng = np.random.default_rng(self.seed)
        # the native sampler keys its draws on it; drawn from the stream when
        # no seed is given, as in the JAX package
        self._native_seed = (self.seed if self.seed is not None
                             else int(self._rng.integers(2**63)))
        self._draws = 0  # logical draws so far (the native path's draws differ by it)
        self.pts_bc: Optional[np.ndarray] = None
        self.sdf_weights: Optional[np.ndarray] = None
        self._pre_draw_rng_state = self._rng.bit_generator.state
        self._state_is_pre_draw = True  # no draw has consumed the state yet
        self._last_rar: Optional[dict] = None    # the latest draw's RAR spec
        self._rar_replay: Optional[dict] = None  # set_state's spec, replayed next

    # ------------------------------------------------ sampler checkpointing

    def get_state(self) -> dict:
        """Sampler state as of the most recent draw, in the JAX package's
        format (JSON-safe): after `set_state(s)` the next `training_data()`
        reproduces that draw bit for bit and the stream continues as it
        did. A residual-aware draw records its kept pool indices (base64
        little-endian uint32), so it replays without scores."""
        if self._state_is_pre_draw:
            # between set_state() and the next draw: the counter and the rng
            # already point AT the next draw
            draws_next, rng_state = self._draws, self._rng.bit_generator.state
            rar = self._rar_replay
        else:
            draws_next = max(self._draws - 1, 0)
            rng_state = self._pre_draw_rng_state
            rar = self._last_rar
        s = {"draws_next": draws_next, "native_seed": int(self._native_seed),
             "rng_state": rng_state, "native": bool(self.use_native)}
        if rar is not None:
            s["rar"] = {
                "pool_mult": int(rar["pool_mult"]),
                "top_frac": float(rar["top_frac"]),
                "keep_idx": base64.b64encode(
                    np.asarray(rar["keep_idx"], dtype="<u4").tobytes()).decode("ascii"),
            }
        return s

    def set_state(self, s: dict) -> None:
        """Install a state from `get_state` (this package's or the JAX
        package's); the next draw replays the state's draw. The dataset takes
        the writer's sampling path (nsfnet_tpu/data/cavity.py:128-158): a
        native-path state builds the native library, a numpy-path state on a
        native dataset replays on numpy, so the points match the checkpointed
        carry."""
        if "native" in s and bool(s["native"]) != self.use_native:
            if s["native"]:
                native.load()  # raises where the library cannot be built
            get_logger().warning(
                f"sampler state was recorded on the {'native' if s['native'] else 'numpy'} "
                f"sampling path; this dataset follows it (use_native={bool(s['native'])}) "
                f"so the replayed points match the checkpointed carry")
            self.use_native = bool(s["native"])
        self._draws = int(s["draws_next"])
        self._native_seed = int(s["native_seed"])
        if s.get("rng_state") is not None:
            st = dict(s["rng_state"])
            if isinstance(st.get("state"), dict):  # JSON gives ints back as ints
                st["state"] = {k: int(v) if isinstance(v, (int, float)) else v
                               for k, v in st["state"].items()}
            self._rng.bit_generator.state = st
            self._pre_draw_rng_state = st
        self._state_is_pre_draw = True
        r = s.get("rar")
        self._rar_replay = None
        if r is not None:
            idx = r["keep_idx"]
            if isinstance(idx, str):
                idx = np.frombuffer(base64.b64decode(idx), dtype="<u4")
            self._rar_replay = {"pool_mult": int(r["pool_mult"]),
                                "top_frac": float(r["top_frac"]),
                                "keep_idx": np.asarray(idx, dtype=np.int64)}
        self._last_rar = None

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
        coordinate frame), like the reference. Each call is a fresh draw;
        right after set_state() of a residual-aware draw it rebuilds that
        draw's mixed set from the stored indices, without scores."""
        if self.pts_bc is None:
            raise RuntimeError("load boundary data first (fixes the coordinate frame)")
        self._pre_draw_rng_state = self._rng.bit_generator.state
        self._state_is_pre_draw = False
        if self._rar_replay is not None:
            # the raw draws in rar_training_data's order (pool, then fill)
            spec, self._rar_replay = self._rar_replay, None
            keep_idx = np.asarray(spec["keep_idx"], dtype=np.int64)
            pool = self._raw_draw(int(spec["pool_mult"]) * self.N_f)
            fill = self._raw_draw(self.N_f - keep_idx.shape[0], salt=3571)
            xye = np.concatenate([pool[keep_idx], fill], axis=0)
            self._last_rar = spec
        else:
            xye = self._raw_draw(self.N_f)
            self._last_rar = None
        self._draws += 1
        return self._finalize(xye)

    def rar_training_data(self, score_fn, pool_mult: int = 4,
                          top_frac: float = 0.5) -> Tuple[np.ndarray, np.ndarray]:
        """Residual-aware resample (RAR; nsfnet_tpu/data/cavity.py:236-286):
        draw a pool_mult x N_f candidate pool, keep the top_frac x N_f points
        with the largest `score_fn(x, y)` (solver.residuals_at), fill the
        rest with a fresh uniform draw. One logical draw: the kept indices
        ride in get_state().

        The bookkeeping moves only after score_fn returns: a stop (SIGTERM)
        while scoring leaves get_state() describing the previous draw."""
        if self.pts_bc is None:
            raise RuntimeError("load boundary data first (fixes the coordinate frame)")
        pool_mult = int(pool_mult)
        if pool_mult < 1:
            raise ValueError(f"rar pool_mult must be >= 1, got {pool_mult}")
        if not 0.0 < float(top_frac) <= 1.0:
            raise ValueError(f"rar top_frac must be in (0, 1], got {top_frac}")
        pre_state = self._rng.bit_generator.state
        pool = self._raw_draw(pool_mult * self.N_f)
        pts = self._to_centered(pool) if self.coord_transform else pool
        scores = np.asarray(score_fn(pts[:, 0:1].astype(np.float32),
                                     pts[:, 1:2].astype(np.float32))).reshape(-1)
        if scores.shape[0] != pool.shape[0]:
            raise ValueError(f"score_fn returned {scores.shape[0]} scores for "
                             f"{pool.shape[0]} pool points")
        keep_n = min(self.N_f, max(1, int(round(float(top_frac) * self.N_f))))
        keep_idx = np.sort(np.argpartition(-scores, keep_n - 1)[:keep_n]).astype(np.int64)
        fill = self._raw_draw(self.N_f - keep_n, salt=3571)
        xye = np.concatenate([pool[keep_idx], fill], axis=0)
        self._pre_draw_rng_state = pre_state
        self._state_is_pre_draw = False
        self._last_rar = {"pool_mult": pool_mult, "top_frac": float(top_frac),
                          "keep_idx": keep_idx}
        self._rar_replay = None
        self._draws += 1
        return self._finalize(xye)

    def _raw_draw(self, n: int, salt: int = 0) -> np.ndarray:
        """One raw Latin-Hypercube draw of n points on the unit square (the
        generation frame); leaves the logical-draw bookkeeping to the caller.
        On the native path it is seeded native_seed + 7919 * draws + salt:
        `salt` (< 7919) keys a second raw draw within one logical draw (the
        RAR fill); the numpy stream ignores it."""
        if n <= 0:
            return np.zeros((0, 2), dtype=np.float64)
        bounds = [[0.0, 1.0], [0.0, 1.0]]
        if self.use_native:
            return native.lh_sample(n, bounds, self._native_seed + 7919 * self._draws + salt)
        return latin_hypercube(n, bounds, rng=self._rng)

    def _finalize(self, xye: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Generation-frame points -> training-frame columns: coordinate
        transform, optional boundary-distance sort, SDF weights."""
        if self.coord_transform:
            xye = self._to_centered(xye)
        if self.sort_training_points:
            xye = (native.sort_by_distance(xye, self.pts_bc) if self.use_native
                   else sort_by_boundary_distance(xye, self.pts_bc))
        if not self.sdf_enabled:
            self.sdf_weights = None
        elif self.use_native:
            self.sdf_weights = native.sdf_weights(
                xye, self.x_min, self.x_max, float(np.clip(self.sdf_min_weight, 1e-6, 1.0)),
                max(0.0, float(self.sdf_decay)))
        else:
            self.sdf_weights = self._compute_sdf_weights(xye)
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
