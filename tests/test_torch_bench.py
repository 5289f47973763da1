"""PyTorch port: the measurement entry points (nsfnet_tpu_torch/bench.py,
nsfnet_tpu_torch/tools/perf_matrix.py) against bench.py and
scripts/perf_matrix.py on the CPU: the model-FLOP count, the built solver's
points and its first steps, the bench's line with --cpu and its error line
without a card, the pause protocol, and the matrix's rows and exit code."""

import importlib.util
import json
import os
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from nsfnet_tpu_torch import bench as port_bench
from nsfnet_tpu_torch.models.convert import params_from_numpy
from nsfnet_tpu_torch.tools import perf_matrix as pm

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_KEYS = ("metric", "value", "unit", "vs_baseline")
# the labels scripts/perf_matrix.py gives its rows off the TPU (perf_matrix.py:104-157)
JAX_CPU_LABELS = ["mlp/pallas highest", "mlp/pallas high", "mlp/pallas default",
                  "sf/xla-closed-form high", "kan/generic high"]


@pytest.fixture(scope="module")
def jax_matrix():
    """scripts/perf_matrix.py as a module, with the compile-cache settings
    its import makes restored afterwards."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    old = {k: getattr(jax.config, k) for k in keys}
    spec = importlib.util.spec_from_file_location(
        "jax_perf_matrix", os.path.join(ROOT, "scripts", "perf_matrix.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    yield mod
    for k, v in old.items():
        jax.config.update(k, v)


@pytest.mark.parametrize("widths", [(6, 80, 4, 40), (6, 160, 4, 40), (6, 352, 4, 40),
                                    (4, 120, 4, 40)])
def test_model_flops_per_point_matches_jax(jax_matrix, widths):
    assert pm.model_flops_per_point(*widths) == jax_matrix.model_flops_per_point(*widths)


def test_model_flops_per_point_values():
    assert pm.model_flops_per_point() == 997_680
    assert pm.model_flops_per_point(6, 160, 4, 40) == 3_885_840
    assert pm.PASSES == {"default": 1, "high": 3, "highest": 6}


def test_build_matches_jax_build(jax_matrix, monkeypatch):
    """The same points, weights and boundary rows bitwise; from the JAX
    solver's initial weights, three Adam steps at lr 1e-3 to the same loss."""
    import nsfnet_tpu.data.cavity as jax_cavity

    jax_cls = jax_cavity.CavityData
    monkeypatch.setattr(jax_cavity, "CavityData",
                        lambda **kw: jax_cls(**kw, use_native=False))
    js = jax_matrix.build(256)
    ps = pm.build(256, device="cpu")
    for got, ref in ((ps._eq, js._eq), (ps._bc, js._bc),
                     ((ps._eq_weights,), (js._eq_weights,))):
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    assert ps._bc[0].shape == (pm.N_B, 1)

    ps.set_params(params_from_numpy(jax.device_get(js.state.params)),
                  params_from_numpy(jax.device_get(js.state.params_evm)))
    js.state, jm = js._runner(js.state, js._batch, js._stage_scalars(1e-3), n_steps=3)
    pm_ = ps.run_steps(3, lr=1e-3)
    np.testing.assert_allclose(float(pm_.total), float(jm.total), rtol=2e-5)


def _run(args, cwd, timeout=300):
    # four threads: a bench on every core of a machine that
    # other test workers share thrashes (>180 s under 6 workers, 15 s alone)
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "OMP_NUM_THREADS": "4"}
    return subprocess.run([sys.executable, "-m", "nsfnet_tpu_torch.bench", *args], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=timeout)


def test_bench_cpu_prints_one_line_last(tmp_path):
    """The line; and a CPU run leaves a trainer registered in its working
    directory running, its flag unraised."""
    (tmp_path / ".run").mkdir()
    trainer = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(300)"])
    (tmp_path / ".run" / "campaign.pid").write_text(str(trainer.pid))
    try:
        r = _run(["--cpu"], tmp_path)
        assert trainer.poll() is None, "a --cpu run paused a live trainer"
    finally:
        trainer.kill()
        trainer.wait()
    assert not (tmp_path / ".run" / "pause").exists()
    assert "paused" not in r.stderr
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    line = json.loads(lines[-1])
    assert set(JAX_KEYS) | {"mfu", "step_ms", "device"} <= set(line)
    assert line["metric"] == "collocation_points_per_sec_per_chip_re2000"
    assert line["unit"] == "points/s/chip" and line["device"] == "cpu"
    assert line["value"] > 0 and line["step_ms"] > 0 and line["mfu"] is None
    assert line["vs_baseline"] == round(line["value"] / 142000, 2)
    launches = json.loads(lines[-2])
    chunk_ms = launches.pop("chunk_ms_per_step")
    assert launches.pop("device_ms_per_step") is None and launches.pop("busy_share") is None
    assert launches == {"launches": {"fused_residual_fwd": 0, "fused_residual_bwd": 0},
                        "chunks": 4, "steps_per_chunk": 20}
    assert len(chunk_ms) == 4 and min(chunk_ms[1:]) == pytest.approx(line["step_ms"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="holds the run without a card")
def test_bench_without_a_card_exits_1_with_an_error_line(tmp_path):
    r = _run([], tmp_path)
    assert r.returncode == 1
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["value"] == 0.0 and line["vs_baseline"] == 0.0 and line["error"]
    assert line["metric"] == "collocation_points_per_sec_per_chip_re2000"


def test_pause_protocol(tmp_path):
    """The cases of tests/test_drivers.py::test_bench_pause_protocol: no
    pidfile, a dead and a garbage pidfile, a live registered process."""
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    flag = run_dir / "pause"

    cleanup = port_bench._pause_live_trainers(timeout_s=1, run_dir=str(run_dir))
    assert not flag.exists()
    cleanup()

    (run_dir / "stale.pid").write_text("999999999")
    (run_dir / "junk.pid").write_text("not-a-pid")
    (run_dir / "group.pid").write_text("0")  # kill(0) would signal the bench's own group
    cleanup = port_bench._pause_live_trainers(timeout_s=1, run_dir=str(run_dir))
    assert not flag.exists()
    cleanup()

    proc = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(300)"])
    (run_dir / "campaign.pid").write_text(str(proc.pid))
    t0 = time.time()
    cleanup = port_bench._pause_live_trainers(timeout_s=30, run_dir=str(run_dir))
    assert flag.exists(), "the flag holds off the watchdog's relaunch during the bench"
    assert proc.wait(timeout=10) == -signal.SIGTERM
    assert time.time() - t0 < 25, "returns as soon as the trainer exits"
    cleanup()
    assert not flag.exists(), "cleanup lets the watchdog resume"


TINY = (64, 2, 64, 1)  # n_f, steps, kan_n_f, kan_steps


def test_run_gives_the_jax_rows_on_the_cpu():
    rows = pm.run(*TINY, device="cpu")
    assert [r["config"] for r in rows] == JAX_CPU_LABELS
    zero = dict.fromkeys(pm.launch_counts(), 0)
    for r in rows:
        assert "error" not in r, r
        assert r["pts_per_s_per_chip"] > 0 and r["launches"] == zero
        assert r["vs_baseline"] == round(r["pts_per_s_per_chip"] / 142000, 2)
        assert r["mfu"] is None and r["tensor_core_util_pct"] is None
        assert r["device_ms_per_step"] is None and r["busy_share"] is None
    for r in rows[:3]:
        assert r["fused_loss"] is True and r["model_tflops_per_s"] > 0
    assert rows[3]["model_tflops_per_s"] is None


def test_main_exits_nonzero_when_a_row_raises(tmp_path, monkeypatch):
    real_build = pm.build

    def build(n_f, device=None, **kw):
        if kw.get("formulation") == "streamfunction":
            raise RuntimeError("no streamfunction today")
        return real_build(n_f, device, **kw)

    monkeypatch.setattr(pm, "matrix_sizes", lambda on_card, quick=False: TINY)
    monkeypatch.setattr(pm, "build", build)
    out = tmp_path / "m.json"
    assert pm.main(["--cpu", "--out", str(out)]) == 1
    rec = json.loads(out.read_text())
    assert rec["platform"] == "cpu" and rec["device"] == "cpu" and rec["n_f"] == TINY[0]
    rows = {r["config"]: r for r in rec["rows"]}
    assert list(rows) == JAX_CPU_LABELS
    assert rows["sf/xla-closed-form high"]["error"] == "RuntimeError: no streamfunction today"
    assert all("error" not in r and r["pts_per_s_per_chip"] > 0
               for k, r in rows.items() if k != "sf/xla-closed-form high")
