"""Shared arithmetic of the readers of kernels 1 and 2 (the fused residual
loss forward and backward): their device time in the traced chunk and the
roofline share of it."""

from __future__ import annotations

from benchmark.flops import loss_kernel_bytes, loss_kernel_flops, mlp_sizes, roofline_ms

K1 = "loss_fwd_kernel"
K2 = "loss_bwd_kernel"


def device_us(rec: dict, match: str):
    """The device time of each launch whose name contains `match`."""
    return [dur for name, _, _, dur in rec["device"] if match in name]


def roofline_pct(rec: dict, which: int):
    """The bound of one launch over its mean measured time, in %: the larger
    of its one-pass matrix-product FLOPs over the bf16 peak and its bytes
    (inputs read once, outputs written once) over HBM bandwidth."""
    times = device_us(rec, K1 if which == 1 else K2)
    if not times:
        return None
    app = rec["config"]["app_config"]
    net = app["network"]
    sizes = mlp_sizes(net["layers"], net["hidden_size"])
    flops = loss_kernel_flops(sizes, rec["n_f"])[which - 1]
    nbytes = loss_kernel_bytes(sizes, rec["n_f"], app["model_variant"] == "ev-nsfnet")[which - 1]
    return 100.0 * roofline_ms(flops, nbytes) / (sum(times) / len(times) / 1e3)
