"""PyTorch port: the serving export (utils/export.py, torch.export) mirroring
tests/test_export.py:38-150: the predict head round-trips with no model code
and reproduces solver.predict bit for bit at any batch size (the batch
dimension is symbolic), in both formulations and without the EVM net; the
residual head reproduces solver.residuals_at within 1e-5; the CLI restores
the coordinate transform and the checkpoint's alpha_evm. And against the
JAX package's exported heads on the same weights, within 1e-5."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from nsfnet_tpu.training.solver import PINNSolver as JaxSolver
from nsfnet_tpu.utils import export as jax_export
from nsfnet_tpu_torch.config import ConfigManager
from nsfnet_tpu_torch.data.cavity import CavityData
from nsfnet_tpu_torch.models.convert import params_from_numpy
from nsfnet_tpu_torch.train import build_solver
from nsfnet_tpu_torch.training.solver import PINNSolver
from nsfnet_tpu_torch.utils import export as export_mod
from nsfnet_tpu_torch.utils.export import export_predict, export_residuals, load_predict

torch.set_num_threads(2)

ARCH = dict(Re=100, layers=3, layers_1=2, hidden_size=16, hidden_size_1=8, N_f=128,
            alpha_evm=0.03, bc_weight=10, eq_weight=1, seed=7)


def _solver(**kw):
    s = PINNSolver(**{**ARCH, **kw}, device="cpu")
    data = CavityData(N_f=128, sort_training_points=False, seed=0)
    s.set_boundary_data(X=data.boundary_data())
    s.set_eq_training_data(X=data.training_data(), weights=data.sdf_weights)
    return s


def _pts(n, seed=0):
    return np.random.default_rng(seed).uniform(0.05, 0.95, (n, 2)).astype(np.float32)


def _predicted(solver, pts):
    return np.concatenate([a.numpy() for a in solver.predict((pts[:, 0:1], pts[:, 1:2]))], 1)


@pytest.mark.parametrize("formulation", ["velocity", "streamfunction"])
def test_export_roundtrip_bit_exact(tmp_path, formulation):
    solver = _solver(formulation=formulation)
    path = str(tmp_path / "predict.pt2")
    meta = export_predict(solver, path)
    served = load_predict(path, device="cpu")
    for n in (1, 17, 300):  # one artifact, any batch size
        pts = _pts(n, seed=n)
        np.testing.assert_array_equal(served(pts).numpy(), _predicted(solver, pts))
    if not torch.cuda.is_available():  # the card by default, as every entry point
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_predict(path)
    side = json.load(open(path + ".json"))
    assert side == meta and meta["outputs"] == ["u", "v", "p", "e"]
    assert meta["formulation"] == formulation and meta["evm"] is True
    assert meta["torch_version"] == torch.__version__ and "jax_version" not in meta
    assert meta["traced_on"] == "cpu" and meta["platforms"] == ["cpu", "cuda"]
    assert os.path.getsize(path) > 1000
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]


def test_export_vanilla_emits_zero_e(tmp_path):
    van = _solver(layers_1=None, hidden_size_1=None, evm=False)
    path = str(tmp_path / "vanilla.pt2")
    assert export_predict(van, path)["evm"] is False
    out = load_predict(path, device="cpu")(_pts(9)).numpy()
    np.testing.assert_array_equal(out[:, 3], np.zeros(9, np.float32))
    np.testing.assert_array_equal(out, _predicted(van, _pts(9)))


@pytest.mark.parametrize("evm", [True, False])
def test_export_residuals_matches_residuals_at(tmp_path, evm):
    solver = _solver(evm=evm, layers_1=2 if evm else None)
    solver.set_coordinate_transform(2.0)
    solver.set_alpha_evm(0.2)  # the vis_t cap binds at some points
    path = str(tmp_path / "qc.pt2")
    assert export_residuals(solver, path)["kind"] == "nsfnet_tpu.residuals"
    pts = _pts(50, seed=3)
    served = load_predict(path, device="cpu")(pts).numpy().reshape(-1)
    np.testing.assert_allclose(served, solver.residuals_at(pts[:, 0], pts[:, 1]),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("formulation", ["velocity", "streamfunction"])
def test_exported_heads_match_jax(tmp_path, formulation):
    """The JAX package's exported predict and residual heads and the port's,
    from the same weights (coordinate transform on, the EVM net included)."""
    js = JaxSolver(**ARCH, formulation=formulation, mesh_devices=1,
                   checkpoint_path=str(tmp_path))
    ps = _solver(formulation=formulation)
    ps.set_params(params_from_numpy(jax.device_get(js.state.params)),
                  params_from_numpy(jax.device_get(js.state.params_evm)))
    for s in (js, ps):
        s.set_coordinate_transform(2.0)
    pts = _pts(40, seed=4) * 2 - 1
    for kind, jfn, pfn in (("predict", jax_export.export_predict, export_predict),
                           ("qc", jax_export.export_residuals, export_residuals)):
        jfn(js, str(tmp_path / f"{kind}.hlo"), platforms=("cpu",))
        pfn(ps, str(tmp_path / f"{kind}.pt2"))
        want = np.asarray(jax_export.load_predict(str(tmp_path / f"{kind}.hlo"))(pts))
        got = load_predict(str(tmp_path / f"{kind}.pt2"), device="cpu")(pts).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=kind)


def test_export_cli_coord_transform_and_alpha_roundtrip(tmp_path):
    """The CLI wires the data as train.py does (the transform's coord_scale
    2.0 reaches the residual head), and bakes the alpha_evm the checkpoint
    trained at; --alpha-evm wins over it."""
    cfg_path = tmp_path / "ct.yaml"
    cfg_path.write_text(
        "experiment_name: ct_export\n"
        "model_variant: ev-nsfnet\n"
        "physics: {Re: 100, alpha_evm: 0.05, bc_weight: 10, eq_weight: 1}\n"
        "network: {layers: 3, layers_1: 2, hidden_size: 16, hidden_size_1: 8}\n"
        "training:\n"
        "  N_f: 128\n"
        "  coordinate_transform: true\n"
        f"  checkpoint_dir: {tmp_path / 'results'}\n")
    cfg = ConfigManager.from_file(str(cfg_path)).config
    donor = build_solver(cfg, device="cpu")
    data = CavityData(N_f=128, sort_training_points=False, coord_transform=True, seed=0)
    donor.set_boundary_data(X=data.boundary_data())
    donor.set_eq_training_data(X=data.training_data(), weights=data.sdf_weights)
    donor.set_coordinate_transform(data.coord_scale)
    donor.set_alpha_evm(0.007)  # a late-stage anneal value != the config's 0.05
    ckpt = donor.save("ct_donor.ckpt", directory=str(tmp_path))

    out = str(tmp_path / "ct.pt2")
    assert export_mod.main(["--config", str(cfg_path), "--ckpt", ckpt, "--out", out,
                            "--residuals", "--cpu"]) == 0
    side = json.load(open(out + ".json"))
    assert side["coord_scale"] == 2.0
    assert side["alpha_evm"] == pytest.approx(0.007)
    assert side["alpha_evm_source"] == "checkpoint"
    pts = _pts(40, seed=5) * 2 - 1
    served = load_predict(out + ".residuals", device="cpu")(pts).numpy().reshape(-1)
    np.testing.assert_allclose(served, donor.residuals_at(pts[:, 0], pts[:, 1]),
                               rtol=1e-5, atol=1e-7)

    out2 = str(tmp_path / "ct2.pt2")
    assert export_mod.main(["--config", str(cfg_path), "--ckpt", ckpt, "--out", out2,
                            "--alpha-evm", "0.05", "--cpu"]) == 0
    side2 = json.load(open(out2 + ".json"))
    assert side2["alpha_evm"] == pytest.approx(0.05) and side2["alpha_evm_source"] == "cli"
