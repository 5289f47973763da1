"""PyTorch port: the checkpoint sweep (nsfnet_tpu_torch/test.py) against
nsfnet_tpu/test.py on the same checkpoint and a synthetic DNS `.mat` (no
file of the repository holds the DNS fields): the written `.mat` values
within 1e-5, for a JAX checkpoint and for a port checkpoint of the same
weights, and the sweep's failure exits."""

import glob
import os
import sys

import jax
import numpy as np
import scipy.io
import torch

from nsfnet_tpu import test as jax_sweep
from nsfnet_tpu.config import ConfigManager as JaxConfigManager
from nsfnet_tpu.data.cavity import CavityData as JaxCavityData
from nsfnet_tpu.train import build_solver as jax_build_solver
from nsfnet_tpu_torch import test as port_sweep
from nsfnet_tpu_torch.config import ConfigManager
from nsfnet_tpu_torch.models.convert import params_from_numpy
from nsfnet_tpu_torch.train import build_data, build_solver

torch.set_num_threads(2)

CONFIG = """\
experiment_name: sweep
model_variant: ev-nsfnet
eval_data: {mat}
physics: {{Re: 100, alpha_evm: 0.03, bc_weight: 10, eq_weight: 1}}
network: {{layers: 3, layers_1: 2, hidden_size: 16, hidden_size_1: 8}}
training:
  N_f: 200
  seed: 3
  checkpoint_dir: {out}
  enable_tensorboard: false
  sdf_weighting: {{enabled: true}}
"""
KEYS = ("U_pred", "V_pred", "P_pred", "E_pred", "error_u", "error_v", "error_p",
        "error_p_gauge", "lam_bcs", "lam_equ")


def _synthetic_mat(path, n=11):
    g = np.linspace(0.0, 1.0, n)
    X, Y = np.meshgrid(g, g)
    P = np.cos(np.pi * X) * np.sin(np.pi * Y)
    P[0, 0] = np.nan  # masked in the p error
    scipy.io.savemat(path, {"X_ref": X, "Y_ref": Y, "U_ref": np.sin(np.pi * X) * Y,
                            "V_ref": -np.sin(np.pi * Y) * X, "P_ref": P})


def test_sweep_matches_jax(tmp_path, monkeypatch):
    mat = tmp_path / "dns.mat"
    _synthetic_mat(mat)
    cfg_path = tmp_path / "sweep.yaml"
    cfg_path.write_text(CONFIG.format(mat=mat, out=tmp_path / "results"))

    # a JAX checkpoint, and a port checkpoint of the same weights
    jcfg = JaxConfigManager.from_file(str(cfg_path)).config
    js = jax_build_solver(jcfg)
    jd = JaxCavityData(N_f=200, seed=3, sdf_enabled=True, use_native=False)
    js.set_boundary_data(X=jd.boundary_data())
    js.set_eq_training_data(X=jd.training_data(), weights=jd.sdf_weights)
    jpath = js.save("jax.ckpt", directory=str(tmp_path / "ckpts"))
    cfg = ConfigManager.from_file(str(cfg_path)).config
    ps = build_solver(cfg, device="cpu")
    d = build_data(cfg)
    ps.set_boundary_data(X=d.boundary_data())
    ps.set_eq_training_data(X=d.training_data(), weights=d.sdf_weights)
    ps.set_params(params_from_numpy(jax.device_get(js.state.params)),
                  params_from_numpy(jax.device_get(js.state.params_evm)))
    ps.global_step = 7  # its own result file
    ps.save("port.ckpt", directory=str(tmp_path / "ckpts"))

    monkeypatch.setattr(sys, "argv", ["test", "--config", str(cfg_path), "--checkpoints",
                                      jpath, "--out", str(tmp_path / "jax_out")])
    assert jax_sweep.main() == 0
    assert port_sweep.main(["--config", str(cfg_path), "--checkpoints",
                            str(tmp_path / "ckpts" / "*.ckpt"), "--out",
                            str(tmp_path / "port_out"), "--cpu"]) == 0
    want = scipy.io.loadmat(tmp_path / "jax_out" / "cavity_result_loop_0.mat")
    assert sorted(os.listdir(tmp_path / "port_out")) == ["cavity_result_loop_0.mat",
                                                         "cavity_result_loop_7.mat"]
    for loop in (0, 7):
        got = scipy.io.loadmat(tmp_path / "port_out" / f"cavity_result_loop_{loop}.mat")
        for k in KEYS:
            assert got[k].shape == want[k].shape, k
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_sweep_exits_1_without_eval_data_or_checkpoints(tmp_path):
    cfg_path = tmp_path / "sweep.yaml"
    cfg_path.write_text(CONFIG.format(mat=tmp_path / "missing.mat", out=tmp_path))
    args = ["--config", str(cfg_path), "--checkpoints", str(tmp_path / "*.ckpt"), "--cpu"]
    assert port_sweep.main(args) == 1
    _synthetic_mat(tmp_path / "missing.mat")
    assert port_sweep.main(args) == 1  # no checkpoint matches
    assert not glob.glob(str(tmp_path / "**" / "cavity_result_loop_*.mat"), recursive=True)
