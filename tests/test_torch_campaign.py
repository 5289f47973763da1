"""PyTorch port: the campaign path of the driver on the CPU, at tiny sizes
(mirroring tests/test_drivers.py:176-657 and tests/test_solver.py:103, 372,
605): mid-stage resumes that reproduce the uninterrupted run bit for bit
(plain redraws, residual-aware redraws, an extended stage), the SIGTERM stop
in a subprocess, the rollback after a device error, the RAR schedule, the
warm start with widening and its guards, and the load guard on checkpoints
whose sidecar predates the architecture stamp."""

import glob
import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from nsfnet_tpu_torch import train as port_train
from nsfnet_tpu_torch.config import ConfigManager
from nsfnet_tpu_torch.data.cavity import CavityData
from nsfnet_tpu_torch.logger import RunLog
from nsfnet_tpu_torch.ops.fused_residual import KernelLaunchError
from nsfnet_tpu_torch.training import checkpoint as ckpt
from nsfnet_tpu_torch.training.solver import DEVICE_ERRORS, PINNSolver

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GENTLE = os.path.join(ROOT, "artifacts", "re4000_gentle", "final_state.ckpt")
STAGES = [("S1", 0.03, 25, "1.0e-3"), ("S2", 0.02, 50, "5.0e-4"), ("S3", 0.01, 25, "1.0e-4")]


def _config(tmp_path, name, stages=STAGES, extra="", hidden=12, hidden_1=8):
    """Tiny resampling campaign: checkpoints every 25 steps (mid-S2 at 50),
    the EVM gate every 10 stage epochs."""
    lines = "\n".join(f"            - {{alpha: {a}, epochs: {e}, lr: {lr}, name: {n}}}"
                      for n, a, e, lr in stages)
    text = textwrap.dedent(f"""
        experiment_name: {name}
        model_variant: ev-nsfnet
        physics: {{Re: 100, alpha_evm: 0.03}}
        network: {{layers: 2, layers_1: 2, hidden_size: {hidden}, hidden_size_1: {hidden_1}}}
        training:
          N_f: 128
          seed: 5
          log_interval: 1000
          enable_tensorboard: false
          sort_training_points: false
          resample_each_stage: true{extra}
          evm_update_freq: 10
          checkpoint_freq: 25
          checkpoint_dir: {tmp_path / name}
          training_stages:
{lines}
    """)
    path = tmp_path / f"{name}.yaml"
    path.write_text(text)
    return str(path)


def _edit(path, old, new):
    text = open(path).read()
    assert old in text, old
    with open(path, "w") as f:
        f.write(text.replace(old, new))


def _run(cfg, *extra):
    return port_train.main(["--config", cfg, "--cpu", *extra])


def _ckpt_at(run_dir, step, name="*.ckpt"):
    for c in glob.glob(os.path.join(run_dir, "**", name), recursive=True):
        if (ckpt.load_metadata(c) or {}).get("global_step") == step:
            return c
    raise AssertionError(f"no checkpoint at step {step} under {run_dir}")


def _assert_same_state(a, b):
    sa, sb = (torch.load(p, weights_only=True) for p in (a, b))
    for key in ("params", "params_evm", "vis_t_minus"):
        assert torch.equal(sa[key], sb[key]), key
    for key in ("opt_main", "opt_evm"):
        assert sa[key]["count"] == sb[key]["count"]
        assert torch.equal(sa[key]["mu"], sb[key]["mu"]) and torch.equal(sa[key]["nu"],
                                                                          sb[key]["nu"])
    assert (sa["step"], sa["epoch_in_stage"]) == (sb["step"], sb["epoch_in_stage"])


RAR_EVERY = "\n          rar_pool_mult: 2\n          rar_top_frac: 0.5\n          rar_schedule: every"


@pytest.mark.parametrize("extra", ["", RAR_EVERY], ids=["redraw", "rar"])
def test_resume_mid_stage_bit_exact(tmp_path, extra):
    """Resume from the mid-S2 checkpoint (step 50, S2 epoch 25 of 50, written
    after S2's redraw): the sampler state replays S2's draw (under RAR from
    the stored indices, without scores), S3 redraws as the uninterrupted run
    did, and the EVM gate keeps its phase."""
    a, b = _config(tmp_path, "a", extra=extra), _config(tmp_path, "b", extra=extra)
    assert _run(a) == 0
    mid = _ckpt_at(str(tmp_path / "a"), 50)
    meta = ckpt.load_metadata(mid)
    assert meta["stage"] == "S2" and meta["sampler"]["draws_next"] == 1
    assert ("rar" in meta["sampler"]) == bool(extra)
    assert _run(b, "--resume", mid) == 0
    _assert_same_state(_ckpt_at(str(tmp_path / "a"), 100, "model_final.ckpt"),
                       _ckpt_at(str(tmp_path / "b"), 100, "model_final.ckpt"))


def test_resume_into_extended_stage_bit_exact(tmp_path):
    """A mid-S2 checkpoint of one stage table resumes into a table whose S2
    was lengthened and S3 retuned: the same as running the new table
    uninterrupted (the stage length does not leak into the steps)."""
    ext = [("S1", 0.03, 25, "1.0e-3"), ("S2", 0.02, 75, "5.0e-4"), ("S3", 0.01, 25, "2.0e-4")]
    w = _config(tmp_path, "w")
    u, r = _config(tmp_path, "u", stages=ext), _config(tmp_path, "r", stages=ext)
    assert _run(w) == 0 and _run(u) == 0
    assert _run(r, "--resume", _ckpt_at(str(tmp_path / "w"), 50)) == 0
    _assert_same_state(_ckpt_at(str(tmp_path / "u"), 125, "model_final.ckpt"),
                       _ckpt_at(str(tmp_path / "r"), 125, "model_final.ckpt"))


def test_resume_without_sampler_state_warns_approximate(tmp_path, monkeypatch):
    a = _config(tmp_path, "a")
    assert _run(a) == 0
    mid = _ckpt_at(str(tmp_path / "a"), 50)
    meta = ckpt.load_metadata(mid)  # a writer without a sampler state
    del meta["sampler"]
    json.dump(meta, open(mid + ".json", "w"))
    warned = []
    monkeypatch.setattr(RunLog, "warning", lambda self, msg: warned.append(msg))
    assert _run(_config(tmp_path, "b"), "--resume", mid) == 0
    assert any("(approximate resume)" in w for w in warned)


def test_sigterm_stops_with_a_checkpoint_and_resumes_bit_exact(tmp_path):
    """A real SIGTERM to the driver in a subprocess: it stops at a chunk
    boundary, writes sigterm_step<N>.ckpt, exits 3; resuming it to step
    N + 30 equals an uninterrupted run of N + 30 steps."""
    path = _config(tmp_path, "sig", stages=[("S1", 0.03, 500_000, "1.0e-3")])
    _edit(path, "log_interval: 1000", "log_interval: 7")
    _edit(path, "checkpoint_freq: 25", "checkpoint_freq: 20")
    # the thread count of this process: the CPU's sums then split alike
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    log = tmp_path / "child.log"
    with open(log, "w") as out:
        proc = subprocess.Popen([sys.executable, "-m", "nsfnet_tpu_torch.train", "--config",
                                 path, "--cpu"], cwd=str(tmp_path), env=env, stdout=out,
                                stderr=subprocess.STDOUT)
        try:
            deadline = time.time() + 120
            while not glob.glob(str(tmp_path / "sig" / "**" / "model_cavity_loop20.ckpt"),
                                recursive=True):
                assert proc.poll() is None, log.read_text()[-2000:]
                assert time.time() < deadline, "no cadence checkpoint within 120 s"
                time.sleep(0.05)
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert proc.returncode == 3, log.read_text()[-2000:]
    (stop,) = glob.glob(str(tmp_path / "sig" / "**" / "sigterm_step*.ckpt"), recursive=True)
    meta = ckpt.load_metadata(stop)
    step = meta["global_step"]
    assert stop.endswith(f"sigterm_step{step}.ckpt") and step >= 20
    blob = torch.load(stop, weights_only=True)
    assert blob["step"] == blob["epoch_in_stage"] == step  # counters agree with the params
    short = [("S1", 0.03, step + 30, "1.0e-3")]
    for name in ("resumed", "whole"):
        p = _config(tmp_path, name, stages=short)
        _edit(p, "log_interval: 1000", "log_interval: 7")
        assert _run(p, *(("--resume", stop) if name == "resumed" else ())) == 0
    _assert_same_state(_ckpt_at(str(tmp_path / "resumed"), step + 30, "model_final.ckpt"),
                       _ckpt_at(str(tmp_path / "whole"), step + 30, "model_final.ckpt"))


ARCH = dict(Re=100, layers=2, layers_1=2, hidden_size=12, hidden_size_1=8, N_f=128,
            alpha_evm=0.03, seed=7, evm_update_freq=3, log_interval=1000)


def _solver(tmp_path, **kw):
    s = PINNSolver(**{**ARCH, **kw}, checkpoint_path=str(tmp_path), device="cpu")
    d = CavityData(N_f=s.N_f, sort_training_points=False, sdf_enabled=True, seed=3)
    s.set_boundary_data(X=d.boundary_data())
    s.set_eq_training_data(X=d.training_data(), weights=d.sdf_weights)
    return s


ERRORS = [KernelLaunchError("fused residual loss forward: CUDA error 700 at launch"),
          torch.cuda.OutOfMemoryError("CUDA out of memory")]
if hasattr(torch, "AcceleratorError"):
    ERRORS.append(torch.AcceleratorError("CUDA error: an illegal memory access"))


@pytest.mark.parametrize("error", ERRORS, ids=lambda e: type(e).__name__)
def test_device_error_rolls_back_to_the_uninterrupted_run(tmp_path, error):
    """An error in the middle of a chunk (the runner has advanced the state
    in place) rolls back to the stage's last checkpoint; the stage then ends
    where the uninterrupted run ends, bit for bit."""
    assert isinstance(error, DEVICE_ERRORS)
    whole = _solver(tmp_path / "whole", checkpoint_freq=4)
    whole.train(num_epoch=13, lr=1e-3)

    s = _solver(tmp_path / "flaky", checkpoint_freq=4)
    s._ensure_ready()
    real, calls = s._runner, []

    def flaky(state, batch, sc, n_steps):
        calls.append(n_steps)
        if len(calls) == 4:  # steps 6, 7 of 5..8: one step, then the error
            real(state, batch, sc, 1)
            raise error
        return real(state, batch, sc, n_steps)

    s._runner = flaky
    s.train(num_epoch=13, lr=1e-3)
    assert len(calls) == 4 and s.global_step == whole.global_step == 13
    for key in ("params", "params_evm", "vis_t_minus"):
        assert torch.equal(getattr(s.state, key), getattr(whole.state, key)), key
    assert s.state.opt_evm.count == whole.state.opt_evm.count


def test_device_error_without_a_checkpoint_or_a_fourth_time_is_raised(tmp_path):
    s = _solver(tmp_path, checkpoint_freq=10**6)
    s._ensure_ready()

    def broken(state, batch, sc, n_steps):
        raise KernelLaunchError("CUDA error 700 at launch")

    s._runner = broken
    with pytest.raises(KernelLaunchError):
        s.train(num_epoch=5, lr=1e-3)  # no checkpoint yet: nothing to roll back to
    s = _solver(tmp_path, checkpoint_freq=2)
    s.train(num_epoch=2, lr=1e-3)
    real, calls = s._runner, []

    def dies_after_ckpt(state, batch, sc, n_steps):
        calls.append(n_steps)
        if len(calls) > 2:
            raise KernelLaunchError("CUDA error 700 at launch")
        return real(state, batch, sc, n_steps)

    orig_load = s.load

    def load_and_break(path):  # every rebuilt runner breaks again
        orig_load(path)
        s._ensure_ready()
        s._runner = dies_after_ckpt

    s.load = load_and_break
    s._runner = dies_after_ckpt
    with pytest.raises(KernelLaunchError):
        s.train(num_epoch=8, lr=1e-3)
    assert len(calls) == 6  # 2 good chunks, the error, then 3 rollbacks


def test_rar_schedule_first_vs_every(tmp_path, monkeypatch):
    calls = []
    orig = CavityData.rar_training_data
    monkeypatch.setattr(CavityData, "rar_training_data",
                        lambda self, *a, **kw: (calls.append(1), orig(self, *a, **kw))[1])
    rar = "\n          rar_pool_mult: 2\n          rar_top_frac: 0.5"
    assert _run(_config(tmp_path, "first", extra=rar)) == 0  # 3 stages: 2 redraws
    assert len(calls) == 1
    calls.clear()
    assert _run(_config(tmp_path, "every", extra=rar + "\n          rar_schedule: every")) == 0
    assert len(calls) == 2


def test_warm_start_widens_and_keeps_the_function(tmp_path):
    donor_cfg = _config(tmp_path, "donor", stages=[("S1", 0.03, 30, "1.0e-3")])
    assert _run(donor_cfg) == 0
    donor_ckpt = _ckpt_at(str(tmp_path / "donor"), 30, "model_final.ckpt")
    wide = _config(tmp_path, "wide", stages=[("P1", 0.01, 10, "1.0e-4"),
                                             ("P2", 0.01, 5, "1.0e-4")], hidden=16,
                   extra="\n          rar_pool_mult: 2")

    cfg = ConfigManager.from_file(wide).config
    s, d = port_train.build_solver(cfg, "cpu"), port_train.build_data(cfg)
    s.attach_dataset(d)
    s.set_boundary_data(X=d.boundary_data())
    s.set_eq_training_data(X=d.training_data(), weights=d.sdf_weights)
    before = d.get_state()
    assert port_train.warm_start(s, cfg, d, donor_ckpt) == 12
    assert d.get_state() == before  # the donor shared the draw: no sampler advance
    donor = PINNSolver(**{**ARCH, "seed": 0}, device="cpu")
    donor.load(donor_ckpt)
    g = np.linspace(0.0, 1.0, 11, dtype=np.float32)
    gx, gy = (a.reshape(-1, 1) for a in np.meshgrid(g, g))
    for a, b in zip(s.predict((gx, gy)), donor.predict((gx, gy))):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    assert s.state.opt_main.count == 0 and s.global_step == 0
    x = torch.cat([torch.from_numpy(c) for c in s.eq_points()], 1)
    with torch.no_grad():
        carry = 0.03 * s.net_1(x).abs()  # recomputed from the installed EVM net
    s._ensure_ready()
    torch.testing.assert_close(s.state.vis_t_minus[:128], carry, rtol=1e-6, atol=0)

    assert _run(wide, "--init-from", donor_ckpt) == 0
    meta = ckpt.load_metadata(_ckpt_at(str(tmp_path / "wide"), 15, "model_final.ckpt"))
    assert meta["hidden_size"] == 16 and meta["sampler"]["rar"]["pool_mult"] == 2


def test_warm_start_from_the_committed_jax_checkpoint(tmp_path):
    """configs/re4000_ev_polish_h160.yaml cut to a tiny N_f: the h80 JAX
    checkpoint (its sidecar has no EVM stamp) widened to h160."""
    raw = ConfigManager.from_file(os.path.join(ROOT, "configs",
                                               "re4000_ev_polish_h160.yaml")).to_dict()
    raw["training"].update(N_f=64, checkpoint_dir=str(tmp_path / "polish"), log_interval=2)
    raw["eval_data"] = ""
    raw["training"]["training_stages"] = raw["training"]["training_stages"][:2]
    for st, n in zip(raw["training"]["training_stages"], (2, 2)):
        st.update(epochs=n, stall_min_epochs=0)
    path = tmp_path / "polish.yaml"
    path.write_text(json.dumps(raw))  # YAML reads JSON
    assert _run(str(path), "--init-from", GENTLE) == 0
    meta = ckpt.load_metadata(_ckpt_at(str(tmp_path / "polish"), 4, "model_final.ckpt"))
    assert (meta["hidden_size"], meta["stage"]) == (160, "P2")
    assert meta["sampler"]["rar"]["pool_mult"] == 4  # P2's entry ran RAR


def test_warm_start_guards(tmp_path):
    donor_cfg = _config(tmp_path, "donor", stages=[("S1", 0.03, 5, "1.0e-3")])
    assert _run(donor_cfg) == 0
    donor_ckpt = _ckpt_at(str(tmp_path / "donor"), 5, "model_final.ckpt")
    assert ckpt.peek_architecture(donor_ckpt)["hidden_size"] == 12
    one = [("P1", 0.01, 3, "1.0e-4")]
    wide = _config(tmp_path, "wide", stages=one, hidden=16)
    # the port's flat vectors carry no shapes: without its sidecar's stamp
    # the donor's width is unknown, and the warm start is refused
    stamped = ckpt.load_metadata(donor_ckpt)
    json.dump({k: v for k, v in stamped.items() if k not in ("hidden_size", "layers")},
              open(donor_ckpt + ".json", "w"))
    assert ckpt.peek_architecture(donor_ckpt) is None
    assert _run(wide, "--init-from", donor_ckpt) == 2
    json.dump(stamped, open(donor_ckpt + ".json", "w"))
    assert _run(wide, "--init-from", donor_ckpt) == 0
    narrow = _config(tmp_path, "narrow", stages=one, hidden=8)
    evm = _config(tmp_path, "evm", stages=one, hidden=16, hidden_1=12)
    deep = _config(tmp_path, "deep", stages=one, hidden=16)
    _edit(deep, "network: {layers: 2", "network: {layers: 3")
    sf = _config(tmp_path, "sf", stages=one, hidden=16)
    _edit(sf, "hidden_size_1: 8}", "hidden_size_1: 8, formulation: streamfunction}")
    for cfg in (narrow, evm, deep, sf):
        assert _run(cfg, "--init-from", donor_ckpt) == 2, cfg
    assert _run(narrow, "--init-from", donor_ckpt, "--resume", donor_ckpt) == 2


def test_load_guard_takes_the_keys_the_sidecar_has(tmp_path):
    """Only the metadata's own keys are compared; the shapes come from the
    state. The committed h80 checkpoint's sidecar has no EVM stamp."""
    jax_solver = PINNSolver(Re=4000, layers=6, layers_1=4, hidden_size=80, hidden_size_1=40,
                            N_f=64, alpha_evm=0.002, device="cpu")
    jax_solver.load(GENTLE)
    assert jax_solver.global_step == 1_400_000 and jax_solver.current_stage == "S8"
    for bad in (dict(hidden_size=160), dict(hidden_size_1=32)):
        with pytest.raises(ValueError, match="architecture"):
            PINNSolver(**{**dict(Re=4000, layers=6, layers_1=4, hidden_size=80,
                                 hidden_size_1=40), **bad}, device="cpu").load(GENTLE)

    s = _solver(tmp_path)
    s.train(num_epoch=3, lr=1e-3)
    path = s.save("p.ckpt", directory=str(tmp_path))
    meta = ckpt.load_metadata(path)
    for k in ("layers_1", "hidden_size_1", "formulation", "backbone"):
        meta.pop(k)
    json.dump(meta, open(path + ".json", "w"))
    t = _solver(tmp_path, seed=99)
    t.load(path)
    assert torch.equal(t.state.params, s.state.params) and t.global_step == 3
    with pytest.raises(ValueError, match="architecture"):
        _solver(tmp_path, hidden_size_1=6).load(path)  # the state's shapes tell it


def test_load_short_carry_is_recomputed(tmp_path):
    """A writer with fewer points than the solver: the carry comes from the
    restored EVM net, not from padding with the vis_t0 cap."""
    small = _solver(tmp_path, N_f=64)
    small.train(num_epoch=3, lr=1e-3)
    path = small.save("short.ckpt", directory=str(tmp_path))
    big = _solver(tmp_path, N_f=256)
    big.load(path)
    x = torch.cat([torch.from_numpy(c) for c in big.eq_points()], 1)
    with torch.no_grad():
        expect = big.alpha_evm * big.net_1(x).abs()
    torch.testing.assert_close(big.state.vis_t_minus[:256], expect, rtol=1e-6, atol=0)
    assert big.state.vis_t_minus[:256].max() < big.vis_t0


def test_driver_takes_all_38_configs():
    """train.unsupported() refuses none of the repo's 38 configs, and
    kan_cavity.yaml (the KAN backbone) is among them."""
    refused = {}
    paths = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))
    for p in paths:
        out = port_train.unsupported(ConfigManager.from_file(p).config)
        if out:
            refused[os.path.basename(p)] = out
    assert len(paths) == 38
    assert refused == {}
    assert "kan_cavity.yaml" in {os.path.basename(p) for p in paths}
