"""Derivative engine, residuals, losses and the three hand-written kernel pairs."""

from typing import Optional

from nsfnet_tpu_torch.ops import fused_residual, psi_streams


def width_refusal(hidden_size: int, precision: str, formulation: str = "velocity",
                  num_outs: int = 3) -> Optional[str]:
    """Why the kernels cannot run a plain-MLP net of this width at this
    precision name, else None: their tile rule finds no tile that fits
    shared memory. Velocity nets run kernels 1+2 or 3+4
    (`fused_residual.pick_loss_tile`), streamfunction nets kernels 5+6
    (`psi_streams.pick_bwd_tile`). The JAX kernels drop to smaller tiles
    there; these kernels do not yet, so such a run is refused."""
    if formulation == "streamfunction":
        rule, kernels, k = psi_streams.pick_bwd_tile, "kernels 5+6 (psi_streams)", 2
    else:
        rule, kernels, k = (fused_residual.pick_loss_tile,
                            "kernels 1-4 (fused_residual, mlp_streams)", num_outs)
    try:
        rule(int(hidden_size), precision, k)
    except ValueError:
        return (f"hidden width {hidden_size} at matmul_precision {precision!r}: no tile of "
                f"{kernels} fits shared memory (narrow the net or take a precision name with "
                f"fewer bf16 parts)")
    return None
