"""PyTorch port: the slice end to end on the CPU — the port's PINNSolver
against the JAX PINNSolver on the same weights and the same collocation
draw, plus the solver's own state handling (EVM gate, save/load, predict).
"""

import jax
import numpy as np
import pytest
import torch

from nsfnet_tpu.data.cavity import CavityData as JaxCavityData
from nsfnet_tpu.training.solver import PINNSolver as JaxSolver
from nsfnet_tpu_torch.data.cavity import CavityData
from nsfnet_tpu_torch import train as port_train
from nsfnet_tpu_torch.config import ConfigManager
from nsfnet_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from nsfnet_tpu_torch.ops import fused_residual as fr
from nsfnet_tpu_torch.ops import mlp_streams as ms
from nsfnet_tpu_torch.training.solver import PINNSolver

torch.set_num_threads(2)

ARCH = dict(Re=400, layers=3, layers_1=2, hidden_size=24, hidden_size_1=12, N_f=500,
            alpha_evm=0.03, bc_weight=10, eq_weight=1, seed=7, evm_update_freq=2,
            log_interval=1, checkpoint_freq=10**9)
DATA = dict(N_f=500, sort_training_points=False, sdf_enabled=True, coord_transform=True,
            seed=3)


def _port_solver(tmp_path, **kw):
    s = PINNSolver(**{**ARCH, **kw}, checkpoint_path=str(tmp_path), device="cpu")
    d = CavityData(**DATA)
    s.set_boundary_data(X=d.boundary_data())
    s.set_eq_training_data(X=d.training_data(), weights=d.sdf_weights)
    s.set_coordinate_transform(d.coord_scale)
    return s


def test_slice_matches_jax_solver(tmp_path):
    """5 Adam steps with evm_update_freq=2 (the EVM net updates at stage
    epochs 2 and 4) from the same weights and points."""
    js = JaxSolver(**ARCH, mesh_devices=1, matmul_precision="highest",
                   checkpoint_path=str(tmp_path / "jax"))
    jd = JaxCavityData(**DATA, use_native=False)
    jbc, jxy = jd.boundary_data(), jd.training_data()
    js.set_boundary_data(X=jbc)
    js.set_eq_training_data(X=jxy, weights=jd.sdf_weights)
    js.set_coordinate_transform(jd.coord_scale)

    ps = PINNSolver(**ARCH, checkpoint_path=str(tmp_path / "port"), device="cpu")
    pd = CavityData(**DATA)
    pbc, pxy = pd.boundary_data(), pd.training_data()
    for a, b in zip(jbc + jxy, pbc + pxy):  # the same draw, bit for bit
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jd.sdf_weights, pd.sdf_weights)
    ps.set_params(params_from_numpy(jax.device_get(js.state.params)),
                  params_from_numpy(jax.device_get(js.state.params_evm)))
    ps.set_boundary_data(X=pbc)
    ps.set_eq_training_data(X=pxy, weights=pd.sdf_weights)
    ps.set_coordinate_transform(pd.coord_scale)

    evm_before = params_to_numpy(ps.params_evm())
    js.train(num_epoch=5, lr=1e-3)
    ps.train(num_epoch=5, lr=1e-3)

    jh = np.asarray(js._loss_history)  # (step, total, eq, bc, eq1..eq4)
    ph = np.asarray([(s, m.total, m.equation, m.boundary, m.eq1, m.eq2, m.eq3, m.eq4)
                     for s, m in ps.loss_history])
    assert jh.shape == ph.shape == (5, 8)
    # per-step metrics: fp32 on both sides, engines summing in other orders;
    # 5 Adam steps amplify the first-step rtol ~1e-6 difference slightly
    np.testing.assert_allclose(ph, jh, rtol=1e-4, atol=1e-9)
    assert ps.state.opt_evm.count == 2  # epochs 2 and 4 of 0..4
    assert not np.array_equal(params_to_numpy(ps.params_evm())[0][0], evm_before[0][0])

    for got, ref in ((ps.params(), js.state.params), (ps.params_evm(), js.state.params_evm)):
        for (gw, gb), (rw, rb) in zip(params_to_numpy(got), jax.device_get(ref)):
            # Adam's normalised step is lr-sized whatever the gradient's size,
            # so compare the params to a small fraction of the 5e-3 moved
            np.testing.assert_allclose(gw, rw, rtol=0, atol=5e-5)
            np.testing.assert_allclose(gb, rb, rtol=0, atol=5e-5)
    nf = 500
    np.testing.assert_allclose(ps.state.vis_t_minus[:nf].numpy(),
                               np.asarray(js.state.vis_t_minus)[:nf], rtol=1e-3, atol=1e-7)


def test_evm_gate_freezes_params_and_moments(tmp_path):
    s = _port_solver(tmp_path)
    s.train(num_epoch=2, lr=1e-3)  # stage epochs 0, 1: EVM frozen
    assert s.state.opt_evm.count == 0
    assert torch.count_nonzero(s.state.opt_evm.mu) == 0
    frozen = s.state.params_evm.detach().clone()
    s.train(num_epoch=3, lr=1e-3)  # a new stage: epochs 0, 1, 2 -> one update
    assert s.state.opt_evm.count == 1
    assert not torch.equal(frozen, s.state.params_evm)
    assert s.state.opt_main.count == 5 and s.global_step == 5


def test_vanilla_variant_trains(tmp_path):
    s = _port_solver(tmp_path, evm=False, layers_1=None)
    assert s.state.params_evm is None and s.state.vis_t_minus is None
    s.train(num_epoch=20, lr=1e-3)
    first, last = s.loss_history[0][1], s.loss_history[-1][1]
    assert last.total < first.total and first.eq4 == 0.0 and first.vis_t_mean == 0.0


def test_save_load_resumes_bit_exact(tmp_path):
    a = _port_solver(tmp_path)
    a.train(num_epoch=3, lr=1e-3)
    path = a.save("mid.ckpt", directory=str(tmp_path))
    b = _port_solver(tmp_path, seed=99)  # other weights until load
    b.load(path)
    assert b.global_step == 3 and b.state.opt_main.count == 3
    for s in (a, b):
        s.state.epoch_in_stage = 3
        s.run_steps(3, lr=1e-3)
    assert torch.equal(a.state.params, b.state.params)
    assert torch.equal(a.state.params_evm, b.state.params_evm)
    assert torch.equal(a.state.vis_t_minus, b.state.vis_t_minus)
    wrong = PINNSolver(**{**ARCH, "hidden_size": 16}, device="cpu")
    with pytest.raises(ValueError, match="architecture"):
        wrong.load(path)


def test_predict_and_evaluate(tmp_path):
    s = _port_solver(tmp_path)
    rng = np.random.default_rng(0)
    x, y = rng.uniform(-1, 1, (2, 50, 1)).astype(np.float32)
    u, v, p, e = s.predict((x, y))
    assert all(t.shape == (50, 1) and t.dtype == torch.float32 for t in (u, v, p, e))
    errs = s.evaluate(x, y, u.numpy() + 0.01, v.numpy() + 0.01,
                      np.where(x > 0, p.numpy() + 0.5, np.nan), log=False)
    assert errs["u"] > 0 and errs["v"] > 0 and np.isfinite(errs["p"])
    assert errs["p_gauge"] == pytest.approx(0.0, abs=1e-3)  # constant shift removed
    assert errs["p_shift"] == pytest.approx(0.5, rel=1e-4)


V1 = dict(Re=400, layers=3, layers_1=None, hidden_size=24, N_f=500, bc_weight=10, eq_weight=1,
          evm=False, seed=7, log_interval=1, checkpoint_freq=10**9, loss_mode="L2")


def test_v1_l2_slice_matches_jax_solver(tmp_path):
    """The vanilla NSFnet L2-loss path, 5 Adam steps from the same weights
    and points: the JAX solver through its Pallas stream engine (interpret
    mode) against the port through `mlp_streams` (its plain version here)."""
    js = JaxSolver(**V1, engine="pallas", mesh_devices=1, matmul_precision="highest",
                   checkpoint_path=str(tmp_path / "jax"))
    jd = JaxCavityData(**DATA, use_native=False)
    js.set_boundary_data(X=jd.boundary_data())
    js.set_eq_training_data(X=jd.training_data(), weights=jd.sdf_weights)
    js.set_coordinate_transform(jd.coord_scale)

    ps = _port_solver(tmp_path, **V1, engine="pallas")
    assert ps.engine == "pallas" and ps.loss_mode == "L2" and ps.state.params_evm is None
    ps.set_params(params_from_numpy(jax.device_get(js.state.params)))

    fr.reset_launch_counts()
    ms.reset_launch_counts()
    js.train(num_epoch=5, lr=1e-3)
    ps.train(num_epoch=5, lr=1e-3)
    assert not any(fr.launch_counts.values()) and not any(ms.launch_counts.values())

    jh = np.asarray(js._loss_history)  # (step, total, eq, bc, eq1..eq4)
    ph = np.asarray([(s, m.total, m.equation, m.boundary, m.eq1, m.eq2, m.eq3, m.eq4)
                     for s, m in ps.loss_history])
    assert jh.shape == ph.shape == (5, 8)
    # fp32 on both sides, engines summing in other orders, a root on top;
    # the same bar as the MSE slice above
    np.testing.assert_allclose(ph, jh, rtol=1e-4, atol=1e-9)
    assert ph[0, 3] > 1.0  # un-normalised boundary norm: far above any mean square
    for (gw, gb), (rw, rb) in zip(params_to_numpy(ps.params()), jax.device_get(js.state.params)):
        np.testing.assert_allclose(gw, rw, rtol=0, atol=5e-5)  # as in the MSE slice
        np.testing.assert_allclose(gb, rb, rtol=0, atol=5e-5)


def test_engine_choice_and_the_unfused_path(tmp_path, monkeypatch):
    """auto is xla on the CPU; on `pallas` the fused loss is used only for
    MSE with NSFNET_FUSED_LOSS unset or not 0, and the unfused chain
    (stream engine -> residuals -> masked sums) gives the same step."""
    assert _port_solver(tmp_path).engine == "xla"
    with pytest.raises(ValueError, match="engine"):
        _port_solver(tmp_path, engine="triton")
    with pytest.raises(ValueError, match="loss_mode"):
        _port_solver(tmp_path, loss_mode="L1")

    calls = []
    real = fr.plain_residual_sums
    monkeypatch.setattr(fr, "plain_residual_sums",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    runs = {}
    for name, env in (("fused", None), ("unfused", "0"), ("forced", "1")):
        if env is None:
            monkeypatch.delenv("NSFNET_FUSED_LOSS", raising=False)
        else:
            monkeypatch.setenv("NSFNET_FUSED_LOSS", env)
        s = _port_solver(tmp_path, engine="pallas")
        del calls[:]
        s.train(num_epoch=3, lr=1e-3)
        assert bool(calls) == (name != "unfused")
        runs[name] = (np.asarray([tuple(m) for _, m in s.loss_history]),
                      s.state.params.detach().numpy().copy())
    # one algebra, summed in another order (masked means vs sums / n)
    np.testing.assert_allclose(runs["unfused"][0], runs["fused"][0], rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(runs["unfused"][1], runs["fused"][1], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(runs["forced"][0], runs["fused"][0])


V1_YAML = """\
experiment_name: tiny_v1
model_variant: nsfnet
physics: {{Re: 100, bc_weight: 10, eq_weight: 1}}
network: {{layers: 2, hidden_size: 16}}
training:
  N_f: 300
  loss_mode: L2
  log_interval: 2
  checkpoint_freq: 1000000
  checkpoint_dir: {out}
  enable_tensorboard: false
  training_stages:
    - {{alpha: 0.0, epochs: 3, lr: 1.0e-3, name: S1}}
"""


def test_cli_runs_loss_mode_l2(tmp_path):
    path = tmp_path / "v1.yaml"
    path.write_text(V1_YAML.format(out=tmp_path))
    cfg = ConfigManager.from_file(str(path)).config
    assert port_train.unsupported(cfg) == []
    s = port_train.build_solver(cfg, device="cpu")
    assert s.loss_mode == "L2" and not s.evm and s.engine == "xla"
    assert port_train.main(["--config", str(path), "--cpu"]) == 0
    assert len(list(tmp_path.glob("Re100/*/model_final.ckpt"))) == 1
