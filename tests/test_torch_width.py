"""PyTorch port: the widths the kernels take. Every width plans: where a
block with both packed carries in shared memory fits (the resident plan,
unchanged: kernels 1-4 below H = 561 at "default", 289 at "high", 193 at
"highest"; kernels 5+6 below 433 / 209 / 145), the kernels keep it; from
there they take the streamed plan (the carries in a block-private global
scratch, K-panels of them through shared memory), whose shared memory does
not grow with H, as the JAX kernels drop to their smallest tile and run any
width (nsfnet_tpu/ops/pallas_psi.py:71-125). No width is refused and none
is moved to the plain version on the card."""

import pytest
import torch

from nsfnet_tpu_torch import train as port_train
from nsfnet_tpu_torch.config import ConfigManager
from nsfnet_tpu_torch.ops import fused_residual as fr
from nsfnet_tpu_torch.ops import mlp_streams as ms
from nsfnet_tpu_torch.ops import psi_streams as ps
from nsfnet_tpu_torch.training.solver import PINNSolver

torch.set_num_threads(2)

FIRST_STREAMED = {("velocity", "default"): 561, ("velocity", "high"): 289,
                  ("velocity", "highest"): 193, ("streamfunction", "default"): 433,
                  ("streamfunction", "high"): 209, ("streamfunction", "highest"): 145}
PAIRS = sorted(FIRST_STREAMED)
MAX_SMEM = 232_448  # bytes of shared memory a block may use on an H100
WARPS = 10          # per block (csrc/tc_mlp.cuh kTcWarps)


def _plan(formulation, h, precision):
    if formulation == "streamfunction":
        return ps.psi_plan(h, precision, 2), ps.bwd_smem_bytes, 2
    return fr.loss_plan(h, precision, 3), fr.loss_smem_bytes, 3


def _r16(b):
    return -(-b // 16) * 16


def _resident_before(formulation, h, parts):
    """The resident tile rule as it stood before the streamed plan, written
    out from its layout (two carries of S T rows, the weight panel, the
    head, the column sums): (tile, panel), or None where nothing fits."""
    hp, k = _r16(h), (2 if formulation == "streamfunction" else 3)
    tiles = (16, 8) if formulation == "streamfunction" else (32, 16)
    for tile in tiles:
        streams = 5 if formulation == "velocity" else (13 if tile == 16 else 14)
        for panel in (p for p in range(hp, 0, -16) if hp % p == 0):
            carry = _r16(parts * streams * tile * (hp + 8) * 2)
            wbuf = _r16(parts * max(hp * (panel + 8), panel * (hp + 8)) * 2)
            if formulation == "velocity":
                rest = (_r16(parts * hp * k * 2) + _r16(5 * tile * k * 4)
                        + _r16(parts * 5 * tile * k * 4) + _r16(4 * tile * 4)
                        + _r16((tile // 8) * 3 * hp * 4))
            else:
                rest = (_r16(parts * hp * k * 2) + _r16(13 * tile * k * 4)
                        + _r16(parts * 13 * tile * k * 4) + _r16((tile // 8) * 3 * hp * 4))
            if 2 * carry + wbuf + rest <= MAX_SMEM:
                return tile, panel
    return None


@pytest.mark.parametrize("formulation,precision", PAIRS)
def test_every_width_plans_and_the_resident_plans_are_unchanged(formulation, precision):
    first = FIRST_STREAMED[(formulation, precision)]
    parts = fr.PARTS[precision]
    for h in range(1, 1025):
        plan, smem_of, k = _plan(formulation, h, precision)
        assert smem_of(plan.tile, plan.panel, h, parts, k, plan.kpanel) <= fr._MAX_SMEM, h
        before = _resident_before(formulation, h, parts)
        assert plan.streamed == (h >= first) == (before is None), (h, plan)
        if h < first:
            assert tuple(plan) == (*before, 0), (h, plan, before)


@pytest.mark.parametrize("formulation,precision", PAIRS)
def test_the_streamed_plan_is_one_the_kernels_take(formulation, precision):
    """The launch checks of the sources (tc_plan_ok, psi_plan_ok): N- and
    K-panels multiples of 16, at most one output unit per warp (16 x 16 of
    kernels 1-4, 8 columns of kernels 5+6), 16-point tiles for kernels 5+6;
    N-panels as even as 16 allows."""
    first = FIRST_STREAMED[(formulation, precision)]
    for h in list(range(first, first + 70)) + [1000, 1024, 2048, 4096]:
        plan, _, _ = _plan(formulation, h, precision)
        hp = _r16(h)
        assert plan.streamed and plan.panel % 16 == 0 and plan.kpanel % 16 == 0
        assert plan.kpanel <= hp and plan.panel <= hp
        if formulation == "streamfunction":
            assert plan.tile == 16 and plan.panel // 8 <= WARPS
        else:
            assert plan.tile == 16 and (plan.tile // 16) * (plan.panel // 16) <= WARPS
        n_panels = -(-hp // plan.panel)
        assert n_panels * plan.panel - hp < 16 * n_panels, (h, plan)


@pytest.mark.parametrize("formulation", ["velocity", "streamfunction"])
def test_streamed_shared_memory_does_not_grow_with_the_width(formulation):
    """Only the carries' global scratch grows with H: no width above 1024 is
    refused either."""
    for precision in fr.PRECISIONS:
        parts = fr.PARTS[precision]
        smem = set()
        for h in (1024, 2048, 4096, 8192):
            plan, smem_of, k = _plan(formulation, h, precision)
            assert plan.streamed
            smem.add((plan.kpanel, smem_of(plan.tile, 160 if formulation == "velocity" else 80,
                                           h, parts, k, plan.kpanel)))
        assert len(smem) == 1, (precision, smem)


def test_streamed_scratch_at_the_rung():
    """The streamed plan's global regions at 6x352 "high" (16-point tiles):
    two carries of 5 x 16 rows, the head weight parts and the column sums,
    132 blocks: ~32 MB, inside the card's 50 MB L2."""
    plan = fr.loss_plan(352, "high")
    assert plan == fr.Plan(16, 128, 128)
    carries = fr.LOSS_BLOCKS * 4 * fr.carry_floats(plan.tile, 352, 3, fr.PARTS["high"])
    assert carries == 132 * (2 * (2 * 80 * 360 * 2) + 2 * 352 * 3 * 2 + 2 * 3 * 352 * 4)
    assert 31e6 < carries < 33e6
    assert ps.psi_plan(224, "high") == fr.Plan(16, 80, 128)


@pytest.mark.parametrize("h", [289, 1024])
def test_kernel_wrappers_take_a_wide_net_off_the_cpu(h):
    """A tensor that is neither on the CPU nor on a card reaches the kernel
    wrapper at any width, which refuses the device, not the width: nothing
    falls back to the plain version."""
    for sizes, entry in (((2, h, h, 3), "fused"), ((2, h, h, 3), "streams"),
                         ((2, h, h, 2), "psi")):
        p = sum(i * o + o for i, o in zip(sizes[:-1], sizes[1:]))
        flat = torch.zeros(p, device="meta")
        x = torch.zeros((64, 2), device="meta")
        col = torch.zeros((64, 1), device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            if entry == "fused":
                fr.fused_residual_loss(flat, sizes, x, col, col, col, 100.0)
            elif entry == "streams":
                ms.mlp_streams(flat, sizes, x)
            else:
                ps.psi_streams(flat, sizes, x)


def _config(h, precision="high", formulation="velocity"):
    return ConfigManager.from_dict({
        "experiment_name": "wide", "model_variant": "ev-nsfnet",
        "network": {"layers": 2, "layers_1": 2, "hidden_size": h, "hidden_size_1": 8,
                    "formulation": formulation},
        "training": {"N_f": 64, "matmul_precision": precision}}).config


@pytest.mark.parametrize("formulation,precision,h", [("velocity", "high", 289),
                                                      ("streamfunction", "highest", 145),
                                                      ("velocity", "default", 1024)])
def test_solver_keeps_the_kernels_at_a_streamed_width(formulation, precision, h):
    """An explicit engine="pallas" solver (on the CPU its wrappers run their
    plain versions) keeps the kernels at a width no resident plan fits, and
    the driver refuses nothing there."""
    s = PINNSolver(layers=2, hidden_size=h, layers_1=2 if formulation == "velocity" else None,
                   hidden_size_1=8, N_f=64, engine="pallas", matmul_precision=precision,
                   formulation=formulation, device="cpu")
    assert s.engine == "pallas"
    assert port_train.unsupported(_config(h, precision, formulation)) == []


def test_train_runs_a_net_wider_than_the_resident_plans(tmp_path, capfd):
    """train.py takes a 289-wide "high" config: --dry-run lists nothing as
    not supported, and two --cpu steps finish with a checkpoint."""
    cfg = tmp_path / "wide.yaml"
    cfg.write_text(
        "experiment_name: wide\n"
        "model_variant: ev-nsfnet\n"
        "network: {layers: 2, layers_1: 2, hidden_size: 289, hidden_size_1: 8}\n"
        "training:\n"
        "  N_f: 64\n"
        "  matmul_precision: high\n"
        "  enable_tensorboard: false\n"
        f"  checkpoint_dir: {tmp_path / 'results'}\n"
        "  training_stages:\n"
        "    - {alpha: 0.0, epochs: 2, lr: 1.0e-3, name: W}\n")
    assert port_train.main(["--config", str(cfg), "--dry-run"]) == 0
    assert "not supported" not in capfd.readouterr().out
    assert port_train.main(["--config", str(cfg), "--cpu"]) == 0
    assert list((tmp_path / "results").rglob("model_final.ckpt"))
