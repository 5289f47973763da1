"""The whole Adam step's share of the card's dense bf16 peak, in %: the
configuration's model FLOPs a point times the points/s of the window
(the run's steps outside the traced chunk)."""

from benchmark.flops import H100_BF16_FLOPS


def read(rec):
    return 100.0 * rec["points_per_s"] * rec["config"]["model_flops_per_point"] / H100_BF16_FLOPS
