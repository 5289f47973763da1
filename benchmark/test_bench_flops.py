"""The frozen counts of the yardstick."""

import pytest

from benchmark import run
from benchmark.flops import (loss_kernel_bytes, loss_kernel_flops, mlp_sizes,
                             model_flops_per_point, roofline_ms)

SPEC = run.load_json(run.ROOT, "BENCHMARK.json")


@pytest.mark.parametrize("hidden,flops", [(80, 997_680), (160, 3_885_840)])
def test_model_flops_per_point(hidden, flops):
    assert model_flops_per_point(6, hidden, 4, 40) == flops


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_each_configuration_brings_its_own_count(entry):
    config = run.load_json(run.ROOT, entry["file"])
    net = config["app_config"]["network"]
    assert config["name"] == entry["name"] and config["reduced"] == entry["reduced"]
    assert config["model_flops_per_point"] == model_flops_per_point(
        net["layers"], net["hidden_size"], net["layers_1"], net["hidden_size_1"])


def test_loss_kernel_counts_at_the_flagship_size():
    sizes = mlp_sizes(6, 80)
    f1, f2 = loss_kernel_flops(sizes, 120_000)
    assert (f1, f2) == (38_688_000_000, 116_064_000_000)
    b1, b2 = loss_kernel_bytes(sizes, 120_000, evm=True)
    assert b1 < b2 < 1e7  # a few MB: both kernels are bound by their products
    assert roofline_ms(f1, b1) == pytest.approx(0.039102, rel=1e-4)
    assert roofline_ms(0, 3.35e9) == pytest.approx(1.0)
