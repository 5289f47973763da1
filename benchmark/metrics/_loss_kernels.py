"""Shared arithmetic of the readers of the port's kernels: their device
time in the traced chunk and the roofline share of it. Kernels 1 and 2 are
the fused residual loss forward and backward; kernels 3+4 (five streams)
and 5+6 (thirteen, the streamfunction's) the streams engines' pairs."""

from __future__ import annotations

from benchmark.flops import (RESIDUAL_STREAMS, has_evm, loss_kernel_bytes, loss_kernel_flops,
                             main_sizes, mlp_sizes, roofline_ms, streams_kernel_bytes,
                             streams_kernel_flops)

K1 = "loss_fwd_kernel"
K2 = "loss_bwd_kernel"
# every kernel of the port that computes the residual, by its name
PORT_KERNELS = tuple(f"{stem}_{way}_kernel" for stem in ("loss", "streams", "psi")
                     for way in ("fwd", "bwd"))


def device_us(rec: dict, match: str):
    """The device time of each launch whose name contains `match`."""
    return [dur for name, _, _, dur in rec["device"] if match in name]


def _share(times, flops: float, nbytes: float):
    """The bound over the mean measured time, in %; None without a launch."""
    if not times:
        return None
    return 100.0 * roofline_ms(flops, nbytes) / (sum(times) / len(times) / 1e3)


def roofline_pct(rec: dict, which: int):
    """Kernel 1 or 2: the bound of one launch over its mean measured time,
    in %: the larger of its one-pass matrix-product FLOPs over the bf16 peak
    and its bytes (inputs read once, outputs written once) over HBM
    bandwidth."""
    app = rec["config"]["app_config"]
    net = app["network"]
    sizes = mlp_sizes(net["layers"], net["hidden_size"])
    flops = loss_kernel_flops(sizes, rec["n_f"])[which - 1]
    nbytes = loss_kernel_bytes(sizes, rec["n_f"], has_evm(app))[which - 1]
    return _share(device_us(rec, K1 if which == 1 else K2), flops, nbytes)


def streams_roofline_pct(rec: dict, kernel: str):
    """A streams kernel (`streams_fwd_kernel` ... `psi_bwd_kernel`) as
    roofline_pct, with the configuration's head width and stream count."""
    net = rec["config"]["app_config"]["network"]
    sizes, streams = main_sizes(net), RESIDUAL_STREAMS[net["formulation"]]
    way = 0 if "_fwd_" in kernel else 1
    flops = streams_kernel_flops(sizes, rec["n_f"], streams)[way]
    nbytes = streams_kernel_bytes(sizes, rec["n_f"], streams)[way]
    return _share(device_us(rec, kernel), flops, nbytes)
