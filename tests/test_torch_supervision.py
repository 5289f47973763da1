"""PyTorch port: the remaining solver options on the CPU — supervision
(NaN pressure targets masked), the adaptive boundary weight and test()'s
.mat dump against the JAX solver; and the driver's polish stages end to
end: an Adam -> lbfgs config, an lm config with supervision and the
adaptive weight, and a SIGTERM inside a polish stage with its resume.
"""

import glob
import os
import signal

import jax
import numpy as np
import pytest
import scipy.io
import torch

from nsfnet_tpu.data.cavity import CavityData as JaxCavityData
from nsfnet_tpu.training.solver import PINNSolver as JaxSolver
from nsfnet_tpu_torch import train as port_train
from nsfnet_tpu_torch.config import ConfigManager
from nsfnet_tpu_torch.data.cavity import CavityData
from nsfnet_tpu_torch.models.convert import params_from_numpy
from nsfnet_tpu_torch.training import checkpoint as ckpt
from nsfnet_tpu_torch.training import lbfgs as port_lbfgs
from nsfnet_tpu_torch.training import lm as port_lm
from nsfnet_tpu_torch.training.solver import PINNSolver
from nsfnet_tpu_torch.training.step import make_residual_fn

torch.set_num_threads(2)

ARCH = dict(Re=100, layers=2, layers_1=2, hidden_size=12, hidden_size_1=6, N_f=128,
            alpha_evm=0.03, bc_weight=10, eq_weight=1, seed=7, evm_update_freq=2,
            log_interval=2, checkpoint_freq=10**9)
DATA = dict(N_f=128, sort_training_points=False, sdf_enabled=True, coord_transform=False, seed=3)
SUP = tuple(np.asarray(a, np.float32) for a in (
    [[0.3], [0.6], [0.8]], [[0.4], [0.5], [0.2]], [[0.1], [0.2], [0.3]],
    [[0.0], [0.1], [0.2]], [[0.5], [np.nan], [0.7]]))


def _pair(tmp_path, supervised=True, **kw):
    """The JAX solver and the port on the same weights, points and
    supervised samples (one NaN p target)."""
    arch = {**ARCH, **kw}
    js = JaxSolver(**arch, mesh_devices=1, matmul_precision="highest",
                   checkpoint_path=str(tmp_path / "jax"))
    jd = JaxCavityData(**DATA, use_native=False)
    js.set_boundary_data(X=jd.boundary_data())
    js.set_eq_training_data(X=jd.training_data(), weights=jd.sdf_weights)
    ps = PINNSolver(**arch, checkpoint_path=str(tmp_path / "port"), device="cpu")
    pd = CavityData(**DATA)
    evm = js.state.params_evm is not None
    ps.set_params(params_from_numpy(jax.device_get(js.state.params)),
                  params_from_numpy(jax.device_get(js.state.params_evm)) if evm else None)
    ps.set_boundary_data(X=pd.boundary_data())
    ps.set_eq_training_data(X=pd.training_data(), weights=pd.sdf_weights)
    if supervised:
        for s in (js, ps):
            s.set_supervised_data(SUP)
            s.set_supervised_loss_weight(2.0)
    return js, ps


def _metrics(solver):
    """The closed-form loss's metrics (total, bc, eq, supervised, eq1..4, vis_t mean)."""
    solver._ensure_ready()
    args = ((solver.state.params, solver.state.params_evm), solver._batch,
            solver.state.vis_t_minus, solver._stage_scalars(1e-3))
    with torch.no_grad():
        return np.asarray([float(v) for v in solver._loss_fn(*args)[1][0]])


def test_supervised_loss_and_residual_match_jax_solver(tmp_path):
    """The supervised loss (a NaN p target masked) in the loss metrics and
    the LM residual, before and after 3 Adam steps, against the JAX solver;
    sum(r**2) equals the loss total."""
    js, ps = _pair(tmp_path)
    np.testing.assert_allclose(_metrics(ps), _metrics(js), rtol=1e-5, atol=1e-9)
    js.train(num_epoch=3, lr=1e-3)
    ps.train(num_epoch=3, lr=1e-3)
    m = _metrics(ps)
    np.testing.assert_allclose(m, _metrics(js), rtol=1e-4, atol=1e-9)
    assert np.isfinite(m).all() and m[3] > 0
    assert ps.loss_history[-1][1].supervised > 0  # the step's own metric, no longer a stub
    res = make_residual_fn(engine=ps._engine("xla"), apply_main=ps._uvp_apply(),
                           apply_evm=ps._apply_evm(), coord_scale=ps.coord_scale,
                           alpha_e=ps.alpha_e, alpha_s=ps.alpha_s, evm=True)
    with torch.no_grad():
        r = res((ps.state.params, ps.state.params_evm), ps._batch, ps.state.vis_t_minus,
                ps._stage_scalars(1e-3))
    assert torch.isfinite(r).all()
    np.testing.assert_allclose((r @ r).item(), m[0], rtol=1e-5)
    ps.set_supervised_loss_weight(0.0)  # weight 0: no supervised rows at all
    ps._ensure_ready()
    assert ps._batch.x_s is None and _metrics(ps)[3] == 0.0


def test_adaptive_bc_weight_matches_jax_solver(tmp_path):
    """The grad-norm probe on the closed-form loss, and the EMA'd boundary
    weight over 7 Adam steps with log_interval 2 (3 updates), against the
    JAX solver."""
    js, ps = _pair(tmp_path, adaptive_bc_weight=True)
    js._ensure_ready()
    ps._ensure_ready()
    ratio = ps._grad_norm_ratio()
    assert np.isfinite(ratio) and ratio > 0
    np.testing.assert_allclose(ratio, js._grad_norm_ratio(js._stage_scalars(1e-3)), rtol=1e-5)
    js.train(num_epoch=7, lr=1e-3)
    ps.train(num_epoch=7, lr=1e-3)
    assert ps.current_alpha_b != 10.0
    np.testing.assert_allclose(ps.current_alpha_b, js.current_alpha_b, rtol=1e-4)
    jh = np.asarray(js._loss_history)  # (step, total, eq, bc, eq1..eq4)
    ph = np.asarray([(s, m.total, m.equation, m.boundary, m.eq1, m.eq2, m.eq3, m.eq4)
                     for s, m in ps.loss_history])
    np.testing.assert_allclose(ph, jh, rtol=1e-4, atol=1e-9)


def test_alpha_b_is_kept_across_stages_polish_and_load(tmp_path):
    """Adaptive mode keeps its weight at a stage start, a polish stage
    included, and load() restores it; an explicit bc_weight overrides; the
    static mode resets to the config's weight at each stage."""
    _, ad = _pair(tmp_path, supervised=False, adaptive_bc_weight=True)
    ad.train(num_epoch=5, lr=1e-3)
    adapted = ad.current_alpha_b
    assert adapted != 10.0 and adapted >= 1.0
    ad.train(num_epoch=0, lr=1e-3)
    ad.train(num_epoch=1, optimizer="lbfgs")
    assert ad.current_alpha_b == adapted
    path = ad.save("adaptive.ckpt", directory=str(tmp_path))
    _, fresh = _pair(tmp_path / "b", supervised=False, adaptive_bc_weight=True)
    fresh.load(path)
    assert fresh.current_alpha_b == adapted
    fresh.train(num_epoch=0, lr=1e-3, bc_weight=5.0)
    assert fresh.current_alpha_b == 5.0
    _, static = _pair(tmp_path / "c", supervised=False)
    static.current_alpha_b = 77.0
    static.train(num_epoch=1, optimizer="lbfgs")
    assert static.current_alpha_b == 10.0


@pytest.mark.parametrize("formulation", ["velocity", "streamfunction"])
def test_test_writes_the_jax_mat(tmp_path, formulation):
    """test(): the .mat keys and arrays of the JAX solver's on synthetic
    fields on a 9x9 grid (a NaN p point), PSI_pred under the streamfunction
    formulation."""
    js, ps = _pair(tmp_path, supervised=False, formulation=formulation)
    g = np.linspace(0.0, 1.0, 9, dtype=np.float32)
    x, y = (a.reshape(-1, 1) for a in np.meshgrid(g, g))
    rng = np.random.default_rng(5)
    u, v, p = (0.1 * rng.standard_normal((81, 1))).astype(np.float32), \
        (0.1 * rng.standard_normal((81, 1))).astype(np.float32), \
        (0.1 * rng.standard_normal((81, 1))).astype(np.float32)
    p[40] = np.nan
    mats = {}
    for name, s in (("jax", js), ("port", ps)):
        errs = s.test(x, y, u, v, p, loop=3, save_dir=str(tmp_path / name))
        assert np.isfinite(errs["p"])
        mats[name] = scipy.io.loadmat(str(tmp_path / name / "cavity_result_loop_3.mat"))
    keys = {k for k in mats["jax"] if not k.startswith("__")}
    assert keys == {k for k in mats["port"] if not k.startswith("__")}
    assert ("PSI_pred" in keys) == (formulation == "streamfunction")
    assert {"U_pred", "V_pred", "P_pred", "E_pred", "error_u", "error_v", "error_p",
            "error_p_gauge", "lam_bcs", "lam_equ"} <= keys
    for k in keys:
        assert mats["port"][k].shape == mats["jax"][k].shape, k
        np.testing.assert_allclose(mats["port"][k], mats["jax"][k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


# ------------------------------------------------------------- the driver

YAML = """\
experiment_name: tiny_polish
model_variant: {variant}
physics: {{Re: 100, alpha_evm: 0.03, bc_weight: 10, eq_weight: 1}}
network: {{layers: 2, layers_1: 2, hidden_size: 12, hidden_size_1: 6}}
eval_data: {eval}
supervision: {{enabled: {sup}, num_samples: 200, loss_weight: 0.5}}
training:
  N_f: 128
  log_interval: 1
  checkpoint_freq: 1000000
  checkpoint_dir: {out}
  max_chunk: {chunk}
  lm_microbatches: {micro}
  adaptive_bc_weight: {adaptive}
  sort_training_points: false
  enable_tensorboard: false
  training_stages:
    - {{alpha: 0.03, epochs: 3, lr: 1.0e-3, name: A}}
{polish}"""


def _config(tmp_path, name, optimizer="lbfgs", polish_steps=4, variant="nsfnet", sup=False,
            adaptive=False, micro=1, chunk=2000, stages=2):
    eval_path = tmp_path / "dns.mat"
    if not eval_path.exists():
        g = np.linspace(0.0, 1.0, 11)
        X, Y = np.meshgrid(g, g)
        rng = np.random.default_rng(0)
        P = rng.standard_normal(X.shape)
        P[3, 4] = np.nan
        scipy.io.savemat(str(eval_path), {"X_ref": X, "Y_ref": Y, "U_ref": np.sin(X) * Y,
                                          "V_ref": -np.cos(Y) * X, "P_ref": P})
    polish = (f"    - {{alpha: 0.03, epochs: {polish_steps}, lr: 1.0, name: P, "
              f"optimizer: {optimizer}}}\n") if stages == 2 else ""
    path = tmp_path / f"{name}.yaml"
    path.write_text(YAML.format(variant=variant, eval=eval_path, sup=str(sup).lower(),
                                out=tmp_path / name, chunk=chunk, micro=micro,
                                adaptive=str(adaptive).lower(), polish=polish))
    return str(path)


def _final(tmp_path, name, pattern="model_final.ckpt"):
    found = glob.glob(str(tmp_path / name / "**" / pattern), recursive=True)
    assert len(found) == 1, found
    return found[0]


def test_cli_runs_adam_then_lbfgs(tmp_path):
    """An Adam stage then an lbfgs stage (the re2000_nsfnet recipe's shape)
    through main() --cpu: exit 0, every step counted."""
    path = _config(tmp_path, "v1")
    assert port_train.unsupported(ConfigManager.from_file(path).config) == []
    assert port_train.main(["--config", path, "--cpu"]) == 0
    meta = ckpt.load_metadata(_final(tmp_path, "v1"))
    assert meta["global_step"] == 7 and meta["stage"] == "P"


def test_cli_refuses_an_lm_stage_under_l2(tmp_path):
    """LM minimises the MSE loss: the driver refuses an lm stage under
    loss_mode L2 before any stage trains; an lbfgs stage under L2 runs."""
    for optimizer in ("lm", "lbfgs"):
        path = _config(tmp_path, optimizer, optimizer=optimizer)
        text = open(path).read().replace("  N_f: 128\n", "  N_f: 128\n  loss_mode: L2\n")
        open(path, "w").write(text)
        refused = port_train.unsupported(ConfigManager.from_file(path).config)
        assert bool(refused) == (optimizer == "lm"), refused
    assert port_train.main(["--config", str(tmp_path / "lm.yaml"), "--cpu"]) == 2
    assert not glob.glob(str(tmp_path / "lm" / "**" / "*.ckpt"), recursive=True)


def test_cli_runs_lm_with_supervision_and_adaptive_bc(tmp_path, caplog):
    """An ev-NSFnet Adam stage then an lm stage over 2 slices, with DNS
    supervision drawn by the run's seed (a NaN p target) and the adaptive
    boundary weight, through main() --cpu."""
    path = _config(tmp_path, "lm", optimizer="lm", polish_steps=2, variant="ev-nsfnet",
                   sup=True, adaptive=True, micro=2)
    seen = []
    real = PINNSolver.train

    def spy(self, *a, **kw):
        seen.append(self)
        return real(self, *a, **kw)

    PINNSolver.train = spy
    try:
        assert port_train.main(["--config", path, "--cpu"]) == 0
    finally:
        PINNSolver.train = real
    s = seen[-1]
    assert s._batch.x_s.shape == (121, 1) and s._batch.n_p == 120.0  # all 121, one NaN p
    assert s.polish_stats["optimizer"] == "lm" and s.polish_stats["microbatches"] == 2
    assert s.current_alpha_b != 10.0 and s.loss_history[-1][1].supervised > 0
    meta = ckpt.load_metadata(_final(tmp_path, "lm"))
    assert meta["global_step"] == 5 and meta["alpha_b"] == s.current_alpha_b


@pytest.mark.parametrize("optimizer", ["lbfgs", "lm"])
def test_sigterm_inside_a_polish_stage(tmp_path, monkeypatch, optimizer):
    """A SIGTERM during the polish stage's first chunk stops the driver at
    the chunk's end with the stage-start state (the polish replaces the
    state only when its stage ends) and the stage-start step; --resume
    reruns the whole stage and ends bitwise where the uninterrupted run
    ends. Chunks: L-BFGS max_chunk // 40 = 2 steps, LM 1."""
    kw = dict(optimizer=optimizer, polish_steps=4 if optimizer == "lbfgs" else 2, chunk=80)
    sent = []
    if optimizer == "lbfgs":
        module, name = port_lbfgs, "zoom_linesearch"
    else:
        module, name = port_lm, "_cg"
    real = getattr(module, name)

    def first_call_signals(*a, **k):
        if not sent:
            sent.append(1)
            os.kill(os.getpid(), signal.SIGTERM)
        return real(*a, **k)

    monkeypatch.setattr(module, name, first_call_signals)
    assert port_train.main(["--config", _config(tmp_path, "stop", **kw), "--cpu"]) == 3
    monkeypatch.setattr(module, name, real)
    stop = _final(tmp_path, "stop", "sigterm_step*.ckpt")
    assert ckpt.load_metadata(stop)["global_step"] == 3
    assert port_train.main(["--config", _config(tmp_path, "adam", stages=1, **kw), "--cpu"]) == 0
    blob = lambda p: torch.load(p, map_location="cpu", weights_only=True)
    assert torch.equal(blob(stop)["params"], blob(_final(tmp_path, "adam"))["params"])

    assert port_train.main(["--config", _config(tmp_path, "stop", **kw), "--cpu",
                            "--resume", stop]) == 0
    assert port_train.main(["--config", _config(tmp_path, "whole", **kw), "--cpu"]) == 0
    resumed, whole = _final(tmp_path, "stop"), _final(tmp_path, "whole")
    assert ckpt.load_metadata(resumed)["global_step"] == ckpt.load_metadata(whole)["global_step"]
    assert torch.equal(blob(resumed)["params"], blob(whole)["params"])
