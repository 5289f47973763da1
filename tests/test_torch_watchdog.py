"""PyTorch port: the watchdog (nsfnet_tpu_torch/tools/watchdog.py), the
protocol of scripts/run_with_watchdog.sh (tests/test_watchdog.py holds the
script): cold-start args only while no checkpoint exists, then --resume of
the newest; a stale log's SIGTERM (SIGKILL after the grace) and restart;
the deadline's clean exit 0; the .run/pause flag and its staleness bound;
exit code 2 aborts; the .pid files. A stub trainer that exits, hangs or
ignores SIGTERM stands in for train.py, with the intervals cut to
fractions of a second; one run starts the real train.py on the CPU."""

import json
import os
import subprocess
import sys
import textwrap
import time

import pytest

from nsfnet_tpu_torch.tools import watchdog

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# per launch the stub takes the next mode of plan.json: ok (exit 0), fail
# (exit 1), rc2 (exit 2), hang (writes a checkpoint, then sleeps without
# logging; SIGTERM exits 3) or deaf (ignores SIGTERM)
STUB = textwrap.dedent("""
    import json, os, signal, sys, time
    with open("calls.jsonl", "a") as f:
        f.write(json.dumps(sys.argv[1:]) + "\\n")
    plan = json.load(open("plan.json"))
    n = sum(1 for _ in open("calls.jsonl")) - 1
    mode = plan[min(n, len(plan) - 1)]
    print(f"stub launch {n}: {mode}", flush=True)
    if mode in ("ok", "fail", "rc2"):
        sys.exit({"ok": 0, "fail": 1, "rc2": 2}[mode])
    os.makedirs("results/run", exist_ok=True)
    open(f"results/run/step{n}.ckpt", "w").close()
    if mode == "deaf":
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
    else:
        signal.signal(signal.SIGTERM, lambda *a: sys.exit(3))
    while True:
        time.sleep(0.05)
""")
FAST = dict(poll=0.1, grace=0.6, grace_poll=0.05, pause_poll=0.05, restart_delay=0.05,
            kill_settle=0.05)
CONFIG = """\
experiment_name: wd
model_variant: ev-nsfnet
physics: {Re: 100, alpha_evm: 0.03}
network: {layers: 2, layers_1: 2, hidden_size: 8, hidden_size_1: 8}
training:
  N_f: 64
  log_interval: 2
  enable_tensorboard: false
  sort_training_points: false
  checkpoint_freq: 1000000
  checkpoint_dir: results
  training_stages:
    - {alpha: 0.03, epochs: 4, lr: 1.0e-3, name: S1}
"""


@pytest.fixture
def stub(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "stub.py").write_text(STUB)
    (tmp_path / "wd.yaml").write_text(CONFIG)

    def run(plan, **kw):
        (tmp_path / "plan.json").write_text(json.dumps(plan))
        rc = watchdog.run("wd.yaml", "run.log", trainer=[sys.executable, "stub.py"],
                          **{**FAST, "stale": 600.0, "deadline": 0.0, **kw})
        calls = [json.loads(ln) for ln in open("calls.jsonl")] if os.path.exists(
            "calls.jsonl") else []
        return rc, calls, open("run.log").read()

    return run


def test_cold_args_until_a_checkpoint_then_resume_newest(stub, tmp_path):
    cold = ["--init-from", "donor.ckpt"]
    rc, calls, log = stub(["fail", "ok"], cold_args=cold, trainer_args=["--cpu"])
    assert rc == 0 and "training completed" in log
    assert calls == [["--config", "wd.yaml", *cold, "--cpu"]] * 2  # nothing checkpointed
    assert log.count("run ended abnormally (rc=1)") == 1
    assert open("run.log.pid").read().strip().isdigit()
    assert not os.path.exists(".run/wd.pid")  # removed on exit
    os.remove("calls.jsonl")
    # the newest of two checkpoints wins, and the cold args go
    os.makedirs("results/a", exist_ok=True)
    for name, age in (("old.ckpt", 100), ("new.ckpt", 10)):
        path = os.path.join("results/a", name)
        open(path, "w").close()
        os.utime(path, (time.time() - age,) * 2)
    rc, calls, _ = stub(["ok"], cold_args=cold)
    assert rc == 0 and calls == [["--config", "wd.yaml", "--resume", "results/a/new.ckpt"]]


def test_cold_init_override(stub, tmp_path):
    os.makedirs("results", exist_ok=True)
    open("better.ckpt", "w").close()
    (tmp_path / "results" / "cold_init_override").write_text("better.ckpt\n")
    rc, calls, log = stub(["ok"], cold_args=["--init-from", "donor.ckpt"])
    assert rc == 0 and calls == [["--config", "wd.yaml", "--init-from", "better.ckpt"]]
    assert "cold-start override" in log


def test_stale_log_sigterm_then_resume(stub):
    rc, calls, log = stub(["hang", "ok"], stale=0.5)
    assert rc == 0
    assert "log stale" in log and "SIGKILL" not in log
    assert calls[1] == ["--config", "wd.yaml", "--resume", "results/run/step0.ckpt"]
    assert "stub launch 0: hang" in log  # the trainer's output goes to the log


def test_sigterm_ignored_escalates_to_sigkill(stub):
    rc, calls, log = stub(["deaf", "ok"], stale=0.5)
    assert rc == 0 and "ignored SIGTERM" in log and len(calls) == 2


def test_deadline_exits_0(stub):
    t0 = time.time()
    rc, calls, log = stub(["hang"], deadline=time.time() + 1.0)
    assert rc == 0 and len(calls) == 1 and "deadline reached - SIGTERM" in log
    assert time.time() - t0 < 10


def test_pause_flag_waits_and_a_stale_one_is_removed(stub):
    os.makedirs(".run", exist_ok=True)
    open(".run/pause", "w").close()
    rc, calls, log = stub(["ok"], deadline=time.time() + 0.5)
    assert rc == 0 and calls == [] and "deadline reached while paused" in log
    os.utime(".run/pause", (time.time() - 100,) * 2)
    rc, calls, log = stub(["ok"], pause_max=50.0)
    assert rc == 0 and len(calls) == 1 and "pause flag stale" in log
    assert not os.path.exists(".run/pause")


def test_configuration_error_aborts(stub):
    rc, calls, log = stub(["rc2", "ok"])
    assert rc == 1 and len(calls) == 1 and "configuration error (rc=2)" in log


def test_cli_runs_the_real_trainer(tmp_path):
    """python -m nsfnet_tpu_torch.tools.watchdog --cpu: a cold run of the
    real train.py to completion (the resume protocol is the stub's above);
    the trainer keeps to one thread, beside the other test workers."""
    (tmp_path / "wd.yaml").write_text(CONFIG)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "nsfnet_tpu_torch.tools.watchdog", "--cpu", "wd.yaml",
           "run.log", "600"]
    r = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    log = (tmp_path / "run.log").read_text()
    assert r.returncode == 0, log[-3000:]
    assert log.count("training completed") == 1 and "launching (resume: none)" in log
    assert list(tmp_path.glob("results/**/model_final.ckpt"))
