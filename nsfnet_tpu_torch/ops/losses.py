"""Loss assembly for the cavity PINN (port of nsfnet_tpu/ops/losses.py).

  * BC loss: mean((u_b - u_pred)^2) + mean((v_b - v_pred)^2)
    (ev-NSFnet/pinn_solver.py:378-379).
  * Equation loss: per-equation weighted MSE, weight applied as
    res*sqrt(w) before squaring (ev-NSFnet/pinn_solver.py:387-397);
    loss_e = eq1 + eq2 + eq3 + 0.1*eq4 in the EVM variant, eq1+eq2+eq3 in
    the vanilla one (NSFnet/pinn_solver.py:218-221).
  * L2 mode (the reference v1's): un-normalised norms sqrt(sum(w * r^2)) in
    place of the means (NSFnet/pinn_solver.py:201-218).
  * Supervised loss: MSE against sampled DNS values of u, v and, where
    finite, p (ev-NSFnet/pinn_solver.py:400-411).

Every mean is sum(w * r^2) / count over the padded array, with pad rows at
weight 0 and `count` the number of REAL points, so padding never biases it.
"""

from __future__ import annotations

from typing import Optional

import torch


def masked_sum_sq(residual: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """sum(w * r^2)."""
    r = residual.reshape(-1)
    w = weights.reshape(-1)
    return torch.sum(w * r * r)


def masked_mean_sq(residual: torch.Tensor, weights: torch.Tensor, count) -> torch.Tensor:
    """sum(w * r^2) / count. `weights` is 0 on pad rows; for the unweighted
    case it is the 0/1 validity mask. `count` = number of real points."""
    return masked_sum_sq(residual, weights) / count


def masked_l2_norm(residual: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """sqrt(sum(w * r^2)) — the reference's 'L2' loss mode
    (NSFnet/pinn_solver.py:201-204, 215-218: torch.norm(res, p=2)). The
    1e-30 under the root keeps the gradient finite at a zero residual."""
    return torch.sqrt(masked_sum_sq(residual, weights) + 1e-30)


def boundary_loss(u_pred, v_pred, u_b, v_b, mask, count) -> torch.Tensor:
    return (masked_mean_sq(u_pred - u_b, mask, count)
            + masked_mean_sq(v_pred - v_b, mask, count))


def equation_loss(res, eq_weights, count, evm_entropy_weight: float = 0.1):
    """Per-equation weighted MSEs. `eq_weights` already folds together the
    SDF weights (mean-normalized) and the pad mask."""
    l1 = masked_mean_sq(res.eq1, eq_weights, count)
    l2 = masked_mean_sq(res.eq2, eq_weights, count)
    l3 = masked_mean_sq(res.eq3, eq_weights, count)
    if res.eq4 is not None:
        l4 = masked_mean_sq(res.eq4, eq_weights, count)
        total = l1 + l2 + l3 + evm_entropy_weight * l4
    else:
        l4 = torch.zeros((), dtype=res.eq1.dtype, device=res.eq1.device)
        total = l1 + l2 + l3
    return total, (l1, l2, l3, l4)


def supervised_loss(u_pred, v_pred, p_pred, u_s, v_s, p_s, mask, count,
                    p_mask: Optional[torch.Tensor], p_count) -> torch.Tensor:
    """MSE of u and v over the supervised points, plus that of p over the
    points whose DNS p is finite (nsfnet_tpu/ops/losses.py:88-99). NaN p
    targets (the reference masks them by isfinite,
    ev-NSFnet/pinn_solver.py:405-410) are zeroed under the mask, so no NaN
    reaches the arithmetic or its gradient."""
    loss = (masked_mean_sq(u_pred - u_s, mask, count)
            + masked_mean_sq(v_pred - v_s, mask, count))
    if p_s is not None and p_mask is not None:
        keep = p_mask > 0
        p_t = torch.where(keep, p_s, torch.zeros_like(p_s))
        p_p = torch.where(keep, p_pred, torch.zeros_like(p_pred))
        loss = loss + masked_mean_sq(p_p - p_t, p_mask, max(float(p_count), 1.0))
    return loss
