"""Faults planted in the port's timed path, each a context manager, to show
that the check decides `correct` false on them: the calibration on the card
(calibrate.py) and the CPU tests plant them the same way. The cells run on
one card, so no fault of an exchange between cards applies."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def state_unchanged():
    """A step that returns its state unchanged: Adam's update does nothing,
    and a polish stage installs nothing."""
    from nsfnet_tpu_torch.training import step
    from nsfnet_tpu_torch.training.solver import PINNSolver

    with _patched(step, "adam_update_", lambda p, g, opt, lr: None), \
            _patched(PINNSolver, "_install_flat", lambda self, w: None):
        yield


def half_batch():
    """Half of the collocation rows left out, the mean taken over the rest."""
    from nsfnet_tpu_torch.training.solver import PINNSolver

    build = PINNSolver._build_batch

    def first_half(self):
        b = build(self)
        half = b.x_f.shape[0] // 32 * 16
        if self.state.vis_t_minus is not None:
            self.state.vis_t_minus = self.state.vis_t_minus[:half].contiguous()
        return b._replace(x_f=b.x_f[:half], y_f=b.y_f[:half], eq_w=b.eq_w[:half],
                          n_f=float((b.eq_w[:half] > 0).sum()))

    return _patched(PINNSolver, "_build_batch", first_half)


@contextlib.contextmanager
def equation_dropped():
    """An answer altered where it is produced: the fused loss returns the
    entropy equation's sum as 0, and so does the closed form's equation
    loss, so eq4's loss and gradient are missing."""
    from nsfnet_tpu_torch.ops import losses
    from nsfnet_tpu_torch.training import solver

    fused, closed = solver.fused_residual_loss, losses.equation_loss

    def altered(*args, **kwargs):
        sums = fused(*args, **kwargs)
        keep = torch.ones_like(sums)
        keep[-1] = 0.0
        return sums * keep

    def without_eq4(res, eq_w, count, evm_entropy_weight=0.1):
        return closed(res._replace(eq4=None), eq_w, count, evm_entropy_weight)

    with _patched(solver, "fused_residual_loss", altered), \
            _patched(losses, "equation_loss", without_eq4):
        yield


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "equation_dropped": equation_dropped}


def bf16_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One bfloat16 pass with float32 sums: the precision below the
    configurations' "high", for the reference put in the program's place."""
    return torch.matmul(a.to(torch.bfloat16), b.to(torch.bfloat16)).to(torch.float32)
