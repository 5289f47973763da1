"""The yardstick's arithmetic: peaks of the card, model FLOPs of a step, and
the operations and bytes of kernels 1 and 2.

Frozen copies of the port's own counts (`tools/perf_matrix.model_flops_per_point`,
`ops/fused_residual.flop_counts` / `byte_counts`), so that a change to the
program cannot move the yardstick. All counts follow from shapes alone.
"""

from __future__ import annotations

from typing import Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit
H100_BF16_FLOPS = 989.4e12
H100_HBM_BYTES_PER_S = 3.35e12


def mlp_sizes(layers: int, hidden: int, n_in: int = 2, n_out: int = 3) -> Tuple[int, ...]:
    """Layer sizes of a tanh MLP with `layers` hidden layers of width `hidden`."""
    return tuple([n_in] + [hidden] * layers + [n_out])


def param_count(sizes: Sequence[int]) -> int:
    return sum(i * o + o for i, o in zip(sizes[:-1], sizes[1:]))


def model_flops_per_point(layers: int, hidden: int, layers_1: int, hidden_1: int) -> float:
    """Model FLOPs per collocation point per Adam step, whatever implements it.

    The residual carries 5 streams (value, d/dx, d/dy, d2/dx2, d2/dy2)
    through every product after the analytic first layer: 2*2*h + (L-1)*5*
    (2*h*h) + 5*(2*h*3) for the main net; the EVM net is one plain value
    forward. Reverse mode costs about twice the forward, so a step is 3x
    the forward. Boundary points are counted at the same rate."""

    def fwd(n_layers, h, n_out, streams):
        return (2 * 2 * h + (n_layers - 1) * streams * (2 * h * h)
                + streams * (2 * h * n_out))

    return 3.0 * (fwd(layers, hidden, 3, 5) + fwd(layers_1, hidden_1, 1, 1))


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


def roofline_ms(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return 1e3 * max(flops / H100_BF16_FLOPS, nbytes / H100_HBM_BYTES_PER_S)
