"""Derivative engine, residuals, losses and the three hand-written kernel pairs."""


def launch_counts() -> dict:
    """The six kernels' launch counters, by kernel name."""
    from nsfnet_tpu_torch.ops import fused_residual, mlp_streams, psi_streams

    return {**fused_residual.launch_counts, **mlp_streams.launch_counts,
            **psi_streams.launch_counts}


def reset_launch_counts() -> None:
    from nsfnet_tpu_torch.ops import fused_residual, mlp_streams, psi_streams

    for mod in (fused_residual, mlp_streams, psi_streams):
        mod.reset_launch_counts()
