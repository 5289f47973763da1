"""The yardstick's arithmetic: peaks of the card, model FLOPs of a step, and
the operations and bytes of the port's kernels.

Frozen copies of the port's own counts (`tools/perf_matrix.model_flops_per_point`,
`ops/fused_residual.flop_counts` / `byte_counts` for kernels 1+2,
`ops/mlp_streams.flop_counts` / `byte_counts` for kernels 3-6), so that a
change to the program cannot move the yardstick. All counts follow from
shapes alone.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit
H100_BF16_FLOPS = 989.4e12
H100_HBM_BYTES_PER_S = 3.35e12

# by the configuration's `network.formulation`: the main net's outputs
# ((u, v, p) or (psi, p)) and the Taylor streams its residual carries through
# every layer (value, d/dx, d/dy, d2/dx2, d2/dy2; the streamfunction's u, v
# are derivatives of psi, so it carries up to the third: 13)
HEAD_WIDTH = {"velocity": 3, "streamfunction": 2}
RESIDUAL_STREAMS = {"velocity": 5, "streamfunction": 13}


def mlp_sizes(layers: int, hidden: int, n_in: int = 2, n_out: int = 3) -> Tuple[int, ...]:
    """Layer sizes of a tanh MLP with `layers` hidden layers of width `hidden`."""
    return tuple([n_in] + [hidden] * layers + [n_out])


def main_sizes(network: dict) -> Tuple[int, ...]:
    """The main net's layer sizes of a configuration's `network`."""
    return mlp_sizes(network["layers"], network["hidden_size"],
                     n_out=HEAD_WIDTH[network["formulation"]])


def has_evm(app: dict) -> bool:
    """Whether the configuration (`app_config`) runs the EVM net, as the
    port decides it (`train.solver_kwargs`)."""
    return app["model_variant"] == "ev-nsfnet"


def param_count(sizes: Sequence[int]) -> int:
    return sum(i * o + o for i, o in zip(sizes[:-1], sizes[1:]))


def model_flops_per_point(layers: int, hidden: int, layers_1: Optional[int] = None,
                          hidden_1: Optional[int] = None, formulation: str = "velocity") -> float:
    """Model FLOPs per collocation point per Adam step, whatever implements it.

    The residual carries RESIDUAL_STREAMS streams through every product
    after the analytic first layer: 2*2*h + (L-1)*S*(2*h*h) + S*(2*h*k) for
    the main net of head width k; the EVM net (`layers_1` x `hidden_1`; None
    where there is none) is one plain value forward. Reverse mode costs about twice the forward, so a
    step is 3x the forward. Boundary points are counted at the same rate."""

    def fwd(n_layers, h, n_out, streams):
        return (2 * 2 * h + (n_layers - 1) * streams * (2 * h * h)
                + streams * (2 * h * n_out))

    main = fwd(layers, hidden, HEAD_WIDTH[formulation], RESIDUAL_STREAMS[formulation])
    evm = fwd(layers_1, hidden_1, 1, 1) if layers_1 is not None else 0
    return 3.0 * (main + evm)


def app_flops_per_point(app: dict) -> float:
    """model_flops_per_point of a configuration's `app_config`."""
    net, evm = app["network"], has_evm(app)
    return model_flops_per_point(net["layers"], net["hidden_size"],
                                 net["layers_1"] if evm else None,
                                 net["hidden_size_1"] if evm else None, net["formulation"])


def loss_kernel_flops(sizes: Sequence[int], n: int) -> Tuple[int, int]:
    """Matrix-product FLOPs of kernel 1 (the fused loss forward) and kernel 2
    (its backward) on n rows, at one pass: the work whatever the precision
    name or the kernel's design. Elementwise work is left out."""
    n_hidden, h, k = len(sizes) - 2, sizes[1], sizes[-1]
    per_point = (n_hidden - 1) * 5 * 2 * h * h + 5 * 2 * h * k
    return n * per_point, n * 3 * per_point


def loss_kernel_bytes(sizes: Sequence[int], n: int, evm: bool) -> Tuple[int, int]:
    """Bytes kernels 1 and 2 must move: each input read once, each output
    written once (float32)."""
    p = param_count(sizes)
    n_out = 4 if evm else 3
    per_point = (2 + (3 if evm else 1)) * 4
    fwd = n * per_point + 4 * p + 4 * n_out
    bwd = fwd + 4 * p + (4 * n if evm else 0)
    return fwd, bwd


def streams_kernel_flops(sizes: Sequence[int], n: int, n_streams: int = 5) -> Tuple[int, int]:
    """Matrix-product FLOPs of a streams kernel pair on n rows, at one pass:
    kernels 3+4 with 5 streams, kernels 5+6 with 13. The backward recomputes
    the hidden products and runs two more a layer (dW and the carry's
    cotangent); the head has those two only. Elementwise work is left out."""
    n_hidden, h, k = len(sizes) - 2, sizes[1], sizes[-1]
    hidden = (n_hidden - 1) * n_streams * 2 * h * h
    head = n_streams * 2 * h * k
    return n * (hidden + head), n * (3 * hidden + 2 * head)


def streams_kernel_bytes(sizes: Sequence[int], n: int, n_streams: int = 5) -> Tuple[int, int]:
    """Bytes a streams kernel pair must move: the points and weights read
    once, each stream of the head written once (read once by the backward
    as its cotangent), the gradient written once (float32)."""
    p, k = param_count(sizes), sizes[-1]
    fwd = n * 8 + 4 * p + n_streams * 4 * n * k
    return fwd, fwd + 4 * p


def roofline_ms(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return 1e3 * max(flops / H100_BF16_FLOPS, nbytes / H100_HBM_BYTES_PER_S)
