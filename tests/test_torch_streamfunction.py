"""PyTorch port: the streamfunction formulation end to end on the CPU — the
port's PINNSolver against the JAX PINNSolver on the same weights and the
same collocation draw (the JAX side through its closed-form engine and
through its Pallas order-3 engine in interpret mode), the formulation stamp
on checkpoints, the engine choice, stall-advance, and the command line.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from nsfnet_tpu.data.cavity import CavityData as JaxCavityData
from nsfnet_tpu.training.solver import PINNSolver as JaxSolver
from nsfnet_tpu.training.solver import stall_gain as jax_stall_gain
from nsfnet_tpu_torch import train as port_train
from nsfnet_tpu_torch.config import ConfigManager
from nsfnet_tpu_torch.data.cavity import CavityData
from nsfnet_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from nsfnet_tpu_torch.ops import fused_residual as fr
from nsfnet_tpu_torch.ops import psi_streams as psi
from nsfnet_tpu_torch.training.checkpoint import load_metadata
from nsfnet_tpu_torch.training.solver import PINNSolver, stall_gain

torch.set_num_threads(2)

DATA = dict(N_f=500, sort_training_points=False, sdf_enabled=True, coord_transform=True,
            seed=3)
SF = dict(Re=400, layers=2, layers_1=2, hidden_size=16, hidden_size_1=8, N_f=500,
          alpha_evm=0.03, bc_weight=10, eq_weight=1, seed=7, evm_update_freq=2,
          log_interval=1, checkpoint_freq=10**9, formulation="streamfunction")


def _port_solver(tmp_path, **kw):
    s = PINNSolver(**kw, checkpoint_path=str(tmp_path), device="cpu")
    d = CavityData(**DATA)
    s.set_boundary_data(X=d.boundary_data())
    s.set_eq_training_data(X=d.training_data(), weights=d.sdf_weights)
    s.set_coordinate_transform(d.coord_scale)
    return s


@pytest.mark.parametrize("evm,jax_engine", [(True, "xla"), (True, "pallas"), (False, "pallas")],
                         ids=["evm-xla", "evm-pallas", "vanilla-pallas"])
def test_streamfunction_slice_matches_jax_solver(tmp_path, evm, jax_engine):
    """5 Adam steps of the (psi, p) formulation from the same weights and
    points: the JAX solver through its closed-form engine or its Pallas
    order-3 engine (interpret mode) against the port through `psi_streams`
    (its plain version here)."""
    kw = dict(SF) if evm else {**SF, "evm": False, "layers_1": None}
    js = JaxSolver(**kw, engine=jax_engine, mesh_devices=1, matmul_precision="highest",
                   checkpoint_path=str(tmp_path / "jax"))
    assert js.engine == jax_engine and js.formulation == "streamfunction"
    jd = JaxCavityData(**DATA, use_native=False)
    js.set_boundary_data(X=jd.boundary_data())
    js.set_eq_training_data(X=jd.training_data(), weights=jd.sdf_weights)
    js.set_coordinate_transform(jd.coord_scale)

    ps = _port_solver(tmp_path, **kw, engine="pallas")
    assert ps.net.sizes == (2, 16, 16, 2) and ps.formulation == "streamfunction"
    ps.set_params(params_from_numpy(jax.device_get(js.state.params)),
                  params_from_numpy(jax.device_get(js.state.params_evm)) if evm else None)

    fr.reset_launch_counts()
    psi.reset_launch_counts()
    js.train(num_epoch=5, lr=1e-3)
    ps.train(num_epoch=5, lr=1e-3)
    assert not any(fr.launch_counts.values()) and not any(psi.launch_counts.values())

    jh = np.asarray(js._loss_history)  # (step, total, eq, bc, eq1..eq4)
    ph = np.asarray([(s, m.total, m.equation, m.boundary, m.eq1, m.eq2, m.eq3, m.eq4)
                     for s, m in ps.loss_history])
    assert jh.shape == ph.shape == (5, 8)
    # the same bar as the velocity slices above
    np.testing.assert_allclose(ph, jh, rtol=1e-4, atol=1e-9)
    assert not ph[:, 6].any() and not jh[:, 6].any()  # eq3 == 0 exactly, every step
    assert ph[-1, 1] < ph[0, 1]
    for (gw, gb), (rw, rb) in zip(params_to_numpy(ps.params()), jax.device_get(js.state.params)):
        np.testing.assert_allclose(gw, rw, rtol=0, atol=5e-5)  # as in the MSE slice
        np.testing.assert_allclose(gb, rb, rtol=0, atol=5e-5)

    # prediction and divergence go through the same formulation on both sides
    rng = np.random.default_rng(0)
    x, y = rng.uniform(-1, 1, (2, 40, 1)).astype(np.float32)
    for got, ref in zip(ps.predict((x, y)), js.predict((x, y))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
    assert not ps.divergence(x, y).any() and not np.asarray(js.divergence(x, y)).any()


def test_streamfunction_checkpoint_stamp_and_refusal(tmp_path):
    a = _port_solver(tmp_path, **SF)
    a.train(num_epoch=3, lr=1e-3)
    path = a.save("sf.ckpt", directory=str(tmp_path))
    assert load_metadata(path)["formulation"] == "streamfunction"
    b = _port_solver(tmp_path, **{**SF, "seed": 99})
    b.load(path)
    assert b.global_step == 3 and torch.equal(a.state.params, b.state.params)
    for s in (a, b):  # an exact resume
        s.state.epoch_in_stage = 3
        s.run_steps(2, lr=1e-3)
    assert torch.equal(a.state.params, b.state.params)
    assert torch.equal(a.state.vis_t_minus, b.state.vis_t_minus)

    vel_kw = {**SF, "formulation": "velocity"}
    vel = _port_solver(tmp_path, **vel_kw)
    with pytest.raises(ValueError, match="'streamfunction'-formulation"):
        vel.load(path)
    vpath = vel.save("vel.ckpt", directory=str(tmp_path))
    assert load_metadata(vpath)["formulation"] == "velocity"
    with pytest.raises(ValueError, match="'velocity'-formulation"):
        a.load(vpath)
    # a checkpoint written before the stamp existed counts as velocity
    meta = load_metadata(vpath)
    del meta["formulation"]
    old = str(tmp_path / "old.ckpt")
    shutil.copyfile(vpath, old)
    with open(old + ".json", "w") as f:
        json.dump(meta, f)
    vel.load(old)
    with pytest.raises(ValueError, match="'velocity'-formulation"):
        a.load(old)
    with pytest.raises(ValueError, match="formulation"):
        _port_solver(tmp_path, **{**SF, "formulation": "vorticity"})


def test_streamfunction_engine_choice(tmp_path, monkeypatch):
    """`pallas` is the order-3 kernel engine, never kernels 1+2 (they read
    (u, v, p) heads); `xla` is the closed form; on the CPU the two run the
    same plain code. NSFNET_PALLAS_PSI=0 matters under
    `auto` only, where a card would pick `pallas`."""
    monkeypatch.delenv("NSFNET_PALLAS_PSI", raising=False)
    monkeypatch.delenv("NSFNET_FUSED_LOSS", raising=False)
    assert _port_solver(tmp_path, **SF).engine == "xla"  # auto on the CPU
    calls = {"fused": 0, "psi": 0}
    real_fused, real_psi = fr.plain_residual_sums, psi.plain_psi_streams
    monkeypatch.setattr(fr, "plain_residual_sums",
                        lambda *a, **k: calls.__setitem__("fused", calls["fused"] + 1)
                        or real_fused(*a, **k))
    monkeypatch.setattr(psi, "plain_psi_streams",
                        lambda *a, **k: calls.__setitem__("psi", calls["psi"] + 1)
                        or real_psi(*a, **k))
    runs = {}
    for engine in ("pallas", "xla"):
        s = _port_solver(tmp_path, **SF, engine=engine)
        calls.update(fused=0, psi=0)
        s.train(num_epoch=3, lr=1e-3)
        assert calls == {"fused": 0, "psi": 3 if engine == "pallas" else 0}
        runs[engine] = np.asarray([tuple(m) for _, m in s.loss_history])
    np.testing.assert_array_equal(runs["pallas"], runs["xla"])

    monkeypatch.setenv("NSFNET_PALLAS_PSI", "0")
    assert _port_solver(tmp_path, **SF, engine="pallas").engine == "pallas"  # explicit wins
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    kw = {**SF, "checkpoint_path": str(tmp_path)}
    assert PINNSolver(**kw, device="meta").engine == "xla"
    assert PINNSolver(**{**kw, "formulation": "velocity"}, device="meta").engine == "xla"


TRACKS = [[1.0, 0.5, 0.4, 0.399, 0.3985, 0.3984], [3.0, 2.0, 1.0, 0.5, 0.25, 0.125],
          [1.0, 1.2, 0.9, 1.1, 0.95, 1.05], [0.5, 0.4], [-1.0, -1.5, -1.2, -1.4, -1.6]]


@pytest.mark.parametrize("track", TRACKS)
@pytest.mark.parametrize("window", [0, 1, 3])
def test_stall_gain_matches_jax(track, window):
    assert stall_gain(track, window) == jax_stall_gain(track, window)


def test_stage_advances_on_stall(tmp_path):
    """lr = 0 freezes the loss: the detector fires at the first boundary
    past its floor, fast-forwards global_step and writes the stage-end
    checkpoint; without the option the stage runs to its end."""
    kw = {**SF, "log_interval": 2}
    s = _port_solver(tmp_path, **kw)
    s.current_stage = "S1"
    s.train(num_epoch=40, lr=0.0, advance_on_stall=True, stall_threshold=0.02,
            stall_window=2, stall_min_epochs=8)
    # boundaries 2, 4, 6 fill the track (3 > window); the floor holds until 8
    assert s.state.opt_main.count == 8 and s.global_step == 40
    (ckpt,) = (tmp_path / "Re400").glob("*S1/model_cavity_loop40.ckpt")
    blob = torch.load(ckpt, weights_only=True)
    assert load_metadata(str(ckpt))["global_step"] == 40 and blob["epoch_in_stage"] == 8

    t = _port_solver(tmp_path, **kw)
    t.train(num_epoch=12, lr=0.0)
    assert t.state.opt_main.count == 12 and t.global_step == 12
    # a descending loss does not stall
    u = _port_solver(tmp_path, **kw)
    u.train(num_epoch=12, lr=1e-3, advance_on_stall=True, stall_window=2, stall_min_epochs=2)
    assert u.state.opt_main.count == 12

    # the field-error track needs attached fields; without them it warns and
    # tracks the equation loss
    rng = np.random.default_rng(0)
    x, y = rng.uniform(-1, 1, (2, 30, 1)).astype(np.float32)
    v = _port_solver(tmp_path, **kw)
    u_t, v_t, p_t, _ = (a.numpy() + 0.1 for a in v.predict((x, y)))
    v.attach_eval_data((x, y, u_t, v_t, p_t))
    v.train(num_epoch=40, lr=0.0, advance_on_stall=True, stall_window=2, stall_min_epochs=0,
            stall_metric="eval_error")
    assert v.state.opt_main.count == 6 and v.global_step == 40


SF_YAML = """\
experiment_name: tiny_sf
model_variant: ev-nsfnet
physics: {{Re: 100, alpha_evm: 0.05, bc_weight: 10, eq_weight: 1}}
network: {{layers: 2, layers_1: 2, hidden_size: 16, hidden_size_1: 8, formulation: streamfunction}}
training:
  N_f: 300
  log_interval: 2
  checkpoint_freq: 1000000
  checkpoint_dir: {out}
  evm_update_freq: 2
  sort_training_points: false
  enable_tensorboard: false
  sdf_weighting: {{enabled: true}}
  stall_threshold: 0.02
  stall_window: 2
  training_stages:
    - {{alpha: 0.05, epochs: 4, lr: 1.0e-3, name: S1, advance_on_stall: true, stall_min_epochs: 2}}
    - {{alpha: 0.03, epochs: 30, lr: 1.0e-12, name: S2, advance_on_stall: true, stall_min_epochs: 4}}
"""


def test_cli_runs_the_streamfunction_formulation(tmp_path):
    path = tmp_path / "sf.yaml"
    path.write_text(SF_YAML.format(out=tmp_path))
    cfg = ConfigManager.from_file(str(path)).config
    assert port_train.unsupported(cfg) == []
    s = port_train.build_solver(cfg, device="cpu")
    assert s.formulation == "streamfunction" and s.evm and s.net.sizes[-1] == 2
    assert port_train.main(["--config", str(path), "--cpu"]) == 0
    (final,) = tmp_path.glob("Re100/*/model_final.ckpt")
    meta = load_metadata(str(final))
    # S2 stalls (an lr too small to move an fp32 weight) and is fast-forwarded to its end: 4 + 30
    assert meta["formulation"] == "streamfunction" and meta["global_step"] == 34
    assert meta["stage"] == "S2"
    other = tmp_path / "bad.yaml"
    other.write_text(SF_YAML.format(out=tmp_path).replace(
        "formulation: streamfunction", "formulation: streamfunction, backbone: kan"))
    assert port_train.main(["--config", str(other), "--cpu"]) == 2
    # a Fourier-embedded (psi, p) net is taken, on the generic engine
    fourier = tmp_path / "fourier.yaml"
    fourier.write_text(SF_YAML.format(out=tmp_path).replace(
        "formulation: streamfunction", "formulation: streamfunction, fourier_features: 16"))
    fcfg = ConfigManager.from_file(str(fourier)).config
    assert port_train.unsupported(fcfg) == []
    fs = port_train.build_solver(fcfg, device="cpu")
    assert fs.net.sizes[0] == 2 + 2 * 16 and fs.engine == "xla" and fs._generic_engine


@pytest.mark.parametrize("name", ["re2000_sf_ev", "re100_streamfunction"])
def test_repo_streamfunction_configs_are_supported(name):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = ConfigManager.from_file(os.path.join(root, "configs", f"{name}.yaml")).config
    assert cfg.network.formulation == "streamfunction"
    assert port_train.unsupported(cfg) == []
