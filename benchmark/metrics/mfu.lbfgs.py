"""The L-BFGS stage's share of the card's dense bf16 peak, in %: the
configuration's model FLOPs a point (an evaluation is a forward and a
reverse pass, as an Adam step is) times the window's evaluated points/s."""

from benchmark.flops import H100_BF16_FLOPS


def read(rec):
    return 100.0 * rec["points_per_s"] * rec["config"]["model_flops_per_point"] / H100_BF16_FLOPS
