"""Derivative engine, residuals, losses, the three hand-written kernel pairs
and the streamfunction's residual-glue pair."""


def launch_counts() -> dict:
    """The hand-written kernels' launch counters, by kernel name."""
    from nsfnet_tpu_torch.ops import fused_residual, mlp_streams, psi_residual, psi_streams

    return {**fused_residual.launch_counts, **mlp_streams.launch_counts,
            **psi_streams.launch_counts, **psi_residual.launch_counts}


def reset_launch_counts() -> None:
    from nsfnet_tpu_torch.ops import fused_residual, mlp_streams, psi_residual, psi_streams

    for mod in (fused_residual, mlp_streams, psi_streams, psi_residual):
        mod.reset_launch_counts()
