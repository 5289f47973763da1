"""Steady incompressible Navier-Stokes residuals for the cavity PINN.

The port of nsfnet_tpu/ops/residuals.py. Physics parity with the reference:
  * vanilla momentum/continuity residuals — NSFnet/pinn_solver.py:155-160
  * entropy-viscosity (EVM) regularized residuals + entropy residual eq4
    — ev-NSFnet/pinn_solver.py:326-342
  * coordinate-transform chain-rule scaling — ev-NSFnet/pinn_solver.py:311-324
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from nsfnet_tpu_torch.ops.derivatives import Derivs


class Residuals(NamedTuple):
    eq1: torch.Tensor  # x-momentum
    eq2: torch.Tensor  # y-momentum
    eq3: torch.Tensor  # continuity
    eq4: Optional[torch.Tensor]  # entropy residual (EVM only)


def _unpack(derivs: Derivs, scale: float, scale_sq: float):
    out, dx, dy, dxx, dyy = derivs
    u, v, p = out[:, 0:1], out[:, 1:2], out[:, 2:3]
    u_x, v_x, p_x = dx[:, 0:1] * scale, dx[:, 1:2] * scale, dx[:, 2:3] * scale
    u_y, v_y, p_y = dy[:, 0:1] * scale, dy[:, 1:2] * scale, dy[:, 2:3] * scale
    u_xx, v_xx = dxx[:, 0:1] * scale_sq, dxx[:, 1:2] * scale_sq
    u_yy, v_yy = dyy[:, 0:1] * scale_sq, dyy[:, 1:2] * scale_sq
    return u, v, p, u_x, u_y, v_x, v_y, p_x, p_y, u_xx, u_yy, v_xx, v_yy


def ns_residuals(derivs: Derivs, re: float, coord_scale: float = 1.0) -> Residuals:
    """Vanilla residuals: eq1/eq2 momentum with molecular viscosity 1/Re,
    eq3 continuity (NSFnet/pinn_solver.py:155-160)."""
    scale_sq = coord_scale * coord_scale
    u, v, _, u_x, u_y, v_x, v_y, p_x, p_y, u_xx, u_yy, v_xx, v_yy = _unpack(
        derivs, coord_scale, scale_sq)
    nu = 1.0 / re
    eq1 = (u * u_x + v * u_y) + p_x - nu * (u_xx + u_yy)
    eq2 = (u * v_x + v * v_y) + p_y - nu * (v_xx + v_yy)
    eq3 = u_x + v_y
    return Residuals(eq1, eq2, eq3, None)


def ev_ns_residuals(derivs: Derivs, e: torch.Tensor, vis_t: torch.Tensor,
                    re: float, coord_scale: float = 1.0) -> Residuals:
    """EVM-regularized residuals (ev-NSFnet/pinn_solver.py:337-342).

    vis_t is the *lagged* eddy-viscosity field (previous step's
    min(20/Re, alpha_evm*|e|)), already detached by the caller: it enters
    the momentum equations as a constant per-point coefficient. eq4 trains
    e to predict the convective energy residual."""
    scale_sq = coord_scale * coord_scale
    u, v, _, u_x, u_y, v_x, v_y, p_x, p_y, u_xx, u_yy, v_xx, v_yy = _unpack(
        derivs, coord_scale, scale_sq)
    nu_eff = 1.0 / re + vis_t
    eq1 = (u * u_x + v * u_y) + p_x - nu_eff * (u_xx + u_yy)
    eq2 = (u * v_x + v * v_y) + p_y - nu_eff * (v_xx + v_yy)
    eq3 = u_x + v_y
    eq4 = (eq1 * (u - 0.5) + eq2 * (v - 0.5)) - e
    return Residuals(eq1, eq2, eq3, eq4)


def next_vis_t(vis_t_minus: torch.Tensor, vis_t0: float) -> torch.Tensor:
    """vis_t used THIS step: min(20/Re, previous alpha_evm*|e|)
    (ev-NSFnet/pinn_solver.py:327-331), on the device."""
    return torch.clamp(vis_t_minus, max=vis_t0)


def update_vis_t_minus(e: torch.Tensor, alpha_evm: float) -> torch.Tensor:
    """Carry for the NEXT step: alpha_evm*|e|, detached
    (ev-NSFnet/pinn_solver.py:334)."""
    return (alpha_evm * e.detach().abs())
