"""PyTorch port: the widths the kernels take. The kernels' tile rules refuse
widths whose smallest tile does not fit shared memory (kernels 1-4: H >= 561
at "default", 289 at "high", 193 at "highest"; kernels 5+6: 433 / 209 / 145);
the JAX kernels drop to smaller tiles instead (nsfnet_tpu/ops/pallas_psi.py:
71-125). The port refuses such a run before any data is built (the solver
raises, train.py exits 2), and keeps the kernels at every width below; it
never moves a kernel's work to the plain version on the card."""

import pytest
import torch

from nsfnet_tpu_torch import train as port_train
from nsfnet_tpu_torch.config import ConfigManager
from nsfnet_tpu_torch.ops import fused_residual as fr
from nsfnet_tpu_torch.ops import psi_streams as ps
from nsfnet_tpu_torch.ops import width_refusal
from nsfnet_tpu_torch.training.solver import PINNSolver

torch.set_num_threads(2)

FIRST_REFUSED = {("velocity", "default"): 561, ("velocity", "high"): 289,
                 ("velocity", "highest"): 193, ("streamfunction", "default"): 433,
                 ("streamfunction", "high"): 209, ("streamfunction", "highest"): 145}


def _config(h, precision="high", formulation="velocity"):
    return ConfigManager.from_dict({
        "experiment_name": "wide", "model_variant": "ev-nsfnet",
        "network": {"layers": 2, "layers_1": 2, "hidden_size": h, "hidden_size_1": 8,
                    "formulation": formulation},
        "training": {"N_f": 64, "matmul_precision": precision}}).config


@pytest.mark.parametrize("formulation,precision", sorted(FIRST_REFUSED))
def test_width_refused_exactly_where_the_tile_rule_refuses(formulation, precision):
    first = FIRST_REFUSED[(formulation, precision)]
    rule = ps.pick_bwd_tile if formulation == "streamfunction" else fr.pick_loss_tile
    k = 2 if formulation == "streamfunction" else 3
    for h in list(range(8, first + 40, 8)) + [first - 1, first]:
        try:
            rule(h, precision, k)
            fits = True
        except ValueError:
            fits = False
        assert fits == (h < first)
        refused = width_refusal(h, precision, formulation, k)
        assert (refused is None) == fits, (h, precision)
        cfg = _config(h, precision, formulation)
        on_card = port_train.unsupported(cfg)
        assert on_card == ([] if fits else [refused])
        # on the CPU no kernel runs (the engine is xla): nothing to refuse
        assert port_train.unsupported(cfg, device_type="cpu") == []
    refused = width_refusal(first, precision, formulation, k)
    assert str(first) in refused and repr(precision) in refused
    assert ("5+6" if formulation == "streamfunction" else "1-4") in refused


def test_solver_refuses_a_width_before_any_data():
    """An explicit engine="pallas" solver (on the CPU its wrappers run their
    plain versions) 289 wide at "high" raises in its constructor, 288 wide
    keeps the kernels; a streamfunction net 145 wide is refused at
    "highest"; engine="xla", asked for by name, takes any width."""
    with pytest.raises(ValueError, match="hidden width 289 at matmul_precision 'high'"):
        PINNSolver(layers=2, hidden_size=289, layers_1=2, hidden_size_1=8, N_f=64,
                   engine="pallas", matmul_precision="high", device="cpu")
    with pytest.raises(ValueError, match="kernels 5\\+6"):
        PINNSolver(layers=2, hidden_size=145, layers_1=None, N_f=64, engine="pallas",
                   matmul_precision="highest", formulation="streamfunction", device="cpu")
    ok = PINNSolver(layers=2, hidden_size=288, layers_1=2, hidden_size_1=8, N_f=64,
                    engine="pallas", matmul_precision="high", device="cpu")
    plain = PINNSolver(layers=2, hidden_size=289, layers_1=2, hidden_size_1=8, N_f=64,
                       engine="xla", matmul_precision="high", device="cpu")
    assert ok.engine == "pallas" and plain.engine == "xla"


def test_train_exits_2_on_a_refused_width(tmp_path):
    """train.py without --cpu refuses a 289-wide "high" config with exit 2
    before it looks for a card or builds any data; --dry-run lists it."""
    cfg = tmp_path / "wide.yaml"
    cfg.write_text(
        "experiment_name: wide\n"
        "model_variant: ev-nsfnet\n"
        "network: {layers: 2, layers_1: 2, hidden_size: 289, hidden_size_1: 8}\n"
        "training:\n"
        "  N_f: 64\n"
        "  matmul_precision: high\n"
        f"  checkpoint_dir: {tmp_path / 'results'}\n")
    assert port_train.main(["--config", str(cfg)]) == 2
    assert not (tmp_path / "results").exists()
    assert port_train.main(["--config", str(cfg), "--dry-run"]) == 0
