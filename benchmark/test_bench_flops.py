"""The frozen counts of the yardstick."""

import copy

import pytest

from benchmark import run
from benchmark.flops import (app_flops_per_point, loss_kernel_bytes, loss_kernel_flops,
                             main_sizes, mlp_sizes, model_flops_per_point, roofline_ms,
                             streams_kernel_bytes, streams_kernel_flops)

SPEC = run.load_json(run.ROOT, "BENCHMARK.json")
FLAGSHIP = run.load_config("ev-nsfnet-re2000-6x80")["app_config"]


@pytest.mark.parametrize("hidden,flops", [(80, 997_680), (160, 3_885_840)])
def test_model_flops_per_point(hidden, flops):
    assert model_flops_per_point(6, hidden, 4, 40) == flops


def _app(formulation="velocity", variant="ev-nsfnet", hidden=80):
    app = copy.deepcopy(FLAGSHIP)
    app["network"].update(formulation=formulation, hidden_size=hidden)
    app["model_variant"] = variant
    return app


@pytest.mark.parametrize("app,flops", [
    (_app(), 997_680),
    (_app(hidden=160), 3_885_840),
    # 3 x (2*2*80 + 5*13*2*80^2 + 13*2*80*2) + the EVM net's value pass
    (_app("streamfunction"), 2_538_960),
    # without the EVM net: its value pass, 3 x 9,840, left out
    (_app(variant="nsfnet"), 997_680 - 29_520),
    (_app("streamfunction", "nsfnet"), 2_538_960 - 29_520),
], ids=["ev6x80", "ev6x160", "sf-ev6x80", "v6x80", "sf6x80"])
def test_the_count_follows_the_formulation_and_the_evm_net(app, flops):
    assert app_flops_per_point(app) == flops


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_each_configuration_brings_its_own_count(entry):
    config = run.load_json(run.ROOT, entry["file"])
    assert config["name"] == entry["name"] and config["reduced"] == entry["reduced"]
    assert config["model_flops_per_point"] == app_flops_per_point(config["app_config"])


def test_loss_kernel_counts_at_the_flagship_size():
    sizes = mlp_sizes(6, 80)
    f1, f2 = loss_kernel_flops(sizes, 120_000)
    assert (f1, f2) == (38_688_000_000, 116_064_000_000)
    b1, b2 = loss_kernel_bytes(sizes, 120_000, evm=True)
    assert b1 < b2 < 1e7  # a few MB: both kernels are bound by their products
    assert roofline_ms(f1, b1) == pytest.approx(0.039102, rel=1e-4)
    assert roofline_ms(0, 3.35e9) == pytest.approx(1.0)


@pytest.mark.parametrize("formulation,sizes", [("velocity", (2, 120, 120, 120, 120, 3)),
                                               ("streamfunction", (2, 80, 80, 80, 80, 80, 80, 2))])
def test_the_head_follows_the_formulation(formulation, sizes):
    net = dict(FLAGSHIP["network"], formulation=formulation,
               layers=len(sizes) - 2, hidden_size=sizes[1])
    assert main_sizes(net) == sizes


@pytest.mark.parametrize("module,sizes,n", [
    ("mlp_streams", (2, 120, 120, 120, 120, 3), 40_000),   # kernels 3+4, the v1 path
    ("mlp_streams", (2, 80, 80, 80, 80, 80, 80, 3), 120_000),
    ("psi_streams", (2, 80, 80, 80, 80, 80, 80, 2), 120_000),  # kernels 5+6, the sf path
    ("psi_streams", (2, 40, 40, 40, 40, 2), 10_000),
])
def test_streams_kernel_counts_are_the_ports(module, sizes, n):
    """The frozen copies against the port's own counts, at the paths' shapes
    (kernels 5+6 with 13 streams)."""
    import importlib

    ops = importlib.import_module(f"nsfnet_tpu_torch.ops.{module}")
    streams = 13 if module == "psi_streams" else 5
    assert streams_kernel_flops(sizes, n, streams) == ops.flop_counts(sizes, n)
    assert streams_kernel_bytes(sizes, n, streams) == ops.byte_counts(sizes, n)
