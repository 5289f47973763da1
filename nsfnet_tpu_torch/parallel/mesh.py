"""Row padding for fixed-shape batches (nsfnet_tpu/parallel/mesh.py:95-109).

Point batches are padded with zero-weight rows to a multiple of a row
granule so kernels see whole tiles; masks and real-point counts keep every
loss an exact mean over the real points. Multi-GPU data parallelism comes
in a later slice.
"""

from __future__ import annotations

import math

import numpy as np


def padded_size(n: int, mesh_size: int, lane: int = 8) -> int:
    """Pad row counts to a multiple of mesh_size*lane."""
    m = mesh_size * lane
    return int(math.ceil(max(n, 1) / m) * m)


def pad_rows(arr: np.ndarray, target_rows: int, fill: float = 0.0) -> np.ndarray:
    """Pad a [N, ...] array with `fill` rows up to target_rows."""
    n = arr.shape[0]
    if n == target_rows:
        return arr
    pad_shape = (target_rows - n,) + arr.shape[1:]
    return np.concatenate([arr, np.full(pad_shape, fill, dtype=arr.dtype)], axis=0)
