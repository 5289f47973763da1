"""Weights carried across frameworks.

Both packages keep the same (W[fan_in, fan_out], b[fan_out]) layout, so a
conversion is a copy: numpy arrays (for example, JAX-initialised weights
fetched with `np.asarray`) become port tensors and back. The tests use it
to run the two packages on the same weights.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from nsfnet_tpu_torch.models.mlp import Params

NumpyParams = Tuple[Tuple[np.ndarray, np.ndarray], ...]


def params_from_numpy(params: Sequence, device: torch.device | str = "cpu",
                      dtype=torch.float32) -> Params:
    """((W, b), ...) array-likes -> ((W, b), ...) tensors on `device`."""
    return tuple(
        (torch.as_tensor(np.array(w), dtype=dtype, device=device),
         torch.as_tensor(np.array(b), dtype=dtype, device=device))
        for w, b in params)


def params_to_numpy(params: Params) -> NumpyParams:
    """((W, b), ...) tensors -> ((W, b), ...) numpy arrays on the host
    (copies: later in-place updates of the tensors do not reach them)."""
    return tuple((w.detach().cpu().numpy().copy(), b.detach().cpu().numpy().copy())
                 for w, b in params)
