"""PyTorch port: the bars that hold the forward kernels 3 and 5 to their
plain versions (nsfnet_tpu_torch/ops/pass_checks.py) tell the precision
names apart, shown on the CPU with the plain versions alone at the widths
and inputs of the forward tests in tests/test_torch_gpu.py.

  * "default": the plain "high" passes miss the norm-wise bar against the
    plain one pass, so a kernel running three passes at "default" fails it.
  * "high": the plain version with its sums rounded once (the same bf16
    products, another rounding of their sums, as a kernel's are) meets the
    separation bar; the six passes of "highest" miss it, as exact fp32 does
    by construction.
  * The witness: between the plain version and itself with its sums
    rounded once, carries whose bf16 parts differ hold the whole distance.
"""

import numpy as np
import pytest
import torch

from nsfnet_tpu_torch.models.mlp import flatten_params, init_mlp
from nsfnet_tpu_torch.ops import fused_residual as fr
from nsfnet_tpu_torch.ops import mlp_streams as ms
from nsfnet_tpu_torch.ops import pass_checks as pc
from nsfnet_tpu_torch.ops import psi_streams as psi

torch.set_num_threads(2)

# test_torch_gpu.py: STREAM_BWD_CASES (kernel 3) and PSI_FWD_CASES (kernel 5)
CASES = [("mlp", s, n) for s, n in (
    ((2, 16, 16, 3), 528), ((2, 24, 24, 2), 512), ((2, 40, 40, 40, 1), 272),
    ((2, 80, 80, 80, 3), 1040), ((2, 120, 120, 120, 3), 528), ((2, 16, 3), 272),
    ((2, 32, 32, 5), 512))] + [("psi", s, n) for s, n in (
        ((2, 16, 16, 2), 256), ((2, 24, 24, 24, 2), 512), ((2, 40, 40, 40, 2), 512),
        ((2, 80, 80, 80, 2), 528), ((2, 120, 120, 120, 2), 1040), ((2, 16, 2), 256),
        ((2, 32, 32, 1), 272), ((2, 32, 32, 3), 256), ((2, 24, 24, 5), 272))]
PLAIN = {"mlp": ms.plain_mlp_streams, "psi": psi.plain_psi_streams}


def _plain(engine, sizes, n, seed=6):
    """plain(name) on the gpu forward tests' inputs (their _inputs at seed 6)."""
    rng = np.random.default_rng(seed)
    flat = flatten_params(init_mlp(sizes, torch.Generator().manual_seed(seed)))
    x = torch.as_tensor(rng.uniform(-1, 1, (n, 2)), dtype=torch.float32)
    return lambda at: PLAIN[engine](flat, sizes, x, at)


@pytest.mark.parametrize("engine,sizes,n", CASES)
def test_default_bar_tells_one_pass_from_three(engine, sizes, n):
    plain = _plain(engine, sizes, n)
    with torch.no_grad():
        assert max(pc.norm_rels(plain("high"), plain("default"))) > pc.DEFAULT_NORM_TOL


@pytest.mark.parametrize("engine,sizes,n", CASES)
def test_high_separation_tells_three_passes_from_fp32(engine, sizes, n):
    plain = _plain(engine, sizes, n)
    with torch.no_grad():
        ref, exact = plain("high"), plain(None)
        with fr.sums_rounded_once():
            rounded = plain("high")
        assert pc.separation(rounded, ref, exact) <= pc.HIGH_SEP
        assert pc.separation(plain("highest"), ref, exact) > pc.HIGH_SEP
        assert pc.separation(exact, ref, exact) == pytest.approx(1.0)


@pytest.mark.parametrize("engine,sizes,n", [("psi", (2, 40, 40, 40, 40, 2), 4000),
                                            ("mlp", (2, 120, 120, 120, 120, 3), 4000)])
def test_carry_flips_hold_the_one_pass_distance(engine, sizes, n):
    """At one pass a few points hold a flipped carry, and they hold the
    distance between the two roundings of the sums; the first product's
    carries (the fp32 first layer) never differ."""
    plain = _plain(engine, sizes, n, seed=1)
    with torch.no_grad():
        wit = pc.carry_flips(lambda: plain("default"), n)
        assert all(torch.equal(a, b) for a, b in zip(wit["fp32"], plain("default")))
    assert not fr._round_sums_once  # restored
    assert len(wit["flips"]) == len(sizes) - 2 and wit["flips"][0] == 0
    assert 0 < wit["points"] < n // 4
    assert wit["share"] > 0.999
    assert 1e-6 < wit["norm_rel"] < pc.DEFAULT_NORM_TOL
