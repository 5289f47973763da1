"""Train state, batch and step metrics (port of nsfnet_tpu/training/state.py).

The full training state is one object — params, both optimizers' moments,
the lagged EVM viscosity carry and the step counters — so saving it gives
an exact resume (the reference loses moments and vis_t on restart,
ev-NSFnet/pinn_solver.py:108-120). Network weights are flat vectors in the
models/mlp.py layout; the optimizer updates them in place. Step counters
are host integers, so the EVM gate never waits for the device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch


class Batch(NamedTuple):
    """Device-resident, padded training data. eq_w / b_mask are zero on pad
    rows; n_* are the real counts, so padded means are exact means."""

    x_f: torch.Tensor    # [Nf_pad, 1] collocation x
    y_f: torch.Tensor    # [Nf_pad, 1]
    eq_w: torch.Tensor   # [Nf_pad, 1] SDF weight x pad mask (1 on real rows when SDF off)
    n_f: float           # real collocation count
    x_b: torch.Tensor    # [Nb_pad, 1] boundary
    y_b: torch.Tensor
    u_b: torch.Tensor
    v_b: torch.Tensor
    b_mask: torch.Tensor  # [Nb_pad, 1]
    n_b: float
    # supervised DNS samples (None when supervision is off)
    x_s: Optional[torch.Tensor] = None   # [Ns, 1]
    y_s: Optional[torch.Tensor] = None
    u_s: Optional[torch.Tensor] = None
    v_s: Optional[torch.Tensor] = None
    p_s: Optional[torch.Tensor] = None   # NaN targets zeroed; p_mask marks the finite ones
    s_mask: Optional[torch.Tensor] = None
    p_mask: Optional[torch.Tensor] = None
    n_s: float = 0.0
    n_p: float = 0.0


@dataclasses.dataclass
class AdamState:
    """optax.scale_by_adam state: first/second moments and the update count."""

    mu: torch.Tensor
    nu: torch.Tensor
    count: int = 0

    @classmethod
    def zeros_like(cls, p: torch.Tensor) -> "AdamState":
        return cls(torch.zeros_like(p), torch.zeros_like(p), 0)


@dataclasses.dataclass
class TrainState:
    params: torch.Tensor                  # main net, flat
    params_evm: Optional[torch.Tensor]    # EVM net, flat (None in vanilla mode)
    opt_main: AdamState
    opt_evm: Optional[AdamState]
    vis_t_minus: Optional[torch.Tensor]   # [Nf_pad, 1] lagged alpha*|e| carry
    step: int = 0                         # global step (spans stages)
    epoch_in_stage: int = 0               # 0-based step within the current stage


class StepMetrics(NamedTuple):
    total: torch.Tensor
    boundary: torch.Tensor
    equation: torch.Tensor
    supervised: torch.Tensor
    eq1: torch.Tensor
    eq2: torch.Tensor
    eq3: torch.Tensor
    eq4: torch.Tensor
    vis_t_mean: torch.Tensor

    def to_host(self) -> "StepMetrics":
        """Python floats (one device sync for all of them)."""
        return StepMetrics(*torch.stack(list(self)).tolist())
