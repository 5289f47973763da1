"""PyTorch port: the training driver's records on the CPU. With
`enable_tensorboard` (the config default) the CLI writes the scalar log under
`tb_log_dir` with the JAX solver's tags, and every checkpoint gets
`eq_losses.mat` beside it with the JAX solver's keys."""

import json
import os
import re

import numpy as np
import scipy.io
import torch

from nsfnet_tpu_torch import train as port_train

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY_YAML = """\
experiment_name: tiny_ev
model_variant: ev-nsfnet
physics: {{Re: 100, alpha_evm: 0.03, bc_weight: 10, eq_weight: 1}}
network: {{layers: 2, layers_1: 2, hidden_size: 8, hidden_size_1: 8}}
training:
  N_f: 64
  log_interval: 2
  checkpoint_freq: 2
  checkpoint_dir: {out}
  tb_log_dir: {runs}
  training_stages:
    - {{alpha: 0.03, epochs: 4, lr: 1.0e-3, name: S1}}
"""


def _jax_tags():
    """The tags the JAX solver's _print_log writes (nsfnet_tpu/training/solver.py)."""
    src = open(os.path.join(ROOT, "nsfnet_tpu", "training", "solver.py"), encoding="utf-8").read()
    return set(re.findall(r'w\.add_scalar\("([^"]+)"', src))


def test_cli_writes_scalar_log_and_loss_history(tmp_path):
    path = tmp_path / "tiny.yaml"
    path.write_text(TINY_YAML.format(out=tmp_path / "out", runs=tmp_path / "runs"))
    assert port_train.main(["--config", str(path), "--cpu"]) == 0

    logs = list((tmp_path / "runs").glob("tiny_ev_*/scalars.jsonl"))
    assert len(logs) == 1
    rows = [json.loads(line) for line in logs[0].read_text().splitlines()]
    tags = _jax_tags()
    # the port adds the host's ms a step (and on a card the card's) from its chunk records
    assert len(tags) == 14 and {r["tag"] for r in rows} == tags | {"perf/host_ms_per_step"}
    steps = sorted({r["step"] for r in rows})
    assert steps == [1, 2, 4]  # the first step, then every log_interval
    assert all(np.isfinite(r["value"]) for r in rows)

    ckpts = list((tmp_path / "out").glob("Re100/*/*.ckpt"))
    assert {p.name for p in ckpts} >= {"model_cavity_loop2.ckpt", "model_final.ckpt"}
    mat = scipy.io.loadmat(str(ckpts[0].parent / "eq_losses.mat"))
    for key in ("step", "total", "eq", "bc", "eq1", "eq2", "eq3", "eq4"):
        assert mat[key].size == 3, key
    np.testing.assert_array_equal(mat["step"].ravel(), steps)
    totals = {r["step"]: r["value"] for r in rows if r["tag"] == "loss/total"}
    np.testing.assert_allclose(mat["total"].ravel(), [totals[s] for s in steps], rtol=1e-6)
