"""The harness end to end on the CPU, at a tiny size, on the kernels' plain
versions; the contract's last line; the readers over a trace record."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import run, trace
from benchmark.flops import H100_BF16_FLOPS, loss_kernel_flops, mlp_sizes, roofline_ms

SPEC = run.load_json(run.ROOT, "BENCHMARK.json")
CELLS = [w["name"] for w in SPEC["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device", "compared"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_end_to_end(cell, capsys):
    result, compared = run.run_cell(cell, 2**31 + 11, 0.2, False, device="cpu", n_f=1024,
                                    chunk_steps=2, t0=0.0)
    run.emit(result, compared)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == KEYS  # `compared` comes last
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    names = {m["name"] for m in run.metrics_of(SPEC, run.cell_of(SPEC, cell), "end_to_end")}
    assert set(line["metrics"]) == names and "setup_s" in names
    assert all(v["value"] > 0 for v in line["metrics"].values())
    tail = err.strip().splitlines()[-len(compared):]
    assert [t.split()[0] for t in tail] == list(compared)
    for k, c in line["compared"].items():
        assert c["value"] <= c["limit"]


def test_cpu_trace_run_reports_no_device_metric():
    result, _ = run.run_cell(CELLS[0], 5, 0.1, True, device="cpu", n_f=512, chunk_steps=1,
                             t0=0.0)
    assert result["metrics"] == {} and "busy_s" not in result["device"]


def record(config, steps=2, n_f=120_000):
    t0 = 1000.0
    dev = []
    t = t0 + 50.0
    for _ in range(steps):  # k1, two plain ops, k2, a copy
        for name, cat, dur in [("void loss_fwd_kernel<2, false>(float const*)", "kernel", 940.0),
                               ("elementwise_kernel", "kernel", 20.0),
                               ("gemm", "kernel", 30.0),
                               ("void loss_bwd_kernel<2, false>(float const*)", "kernel", 4240.0),
                               ("Memcpy DtoD", "gpu_memcpy", 10.0)]:
            dev.append((name, cat, t, dur))
            t += dur + 5.0
    return {"t0": t0, "window_us": t + 100.0 - t0, "device": dev,
            "host": [("aten::cat", t0, 60.0)], "steps": steps, "evaluations": 2 * steps,
            "points_per_s": 2.0e7,
            "n_f": n_f, "config": config}


def test_readers_on_a_record():
    config = run.load_json(run.HERE, "configs", "ev-nsfnet-re2000-6x80.json")
    rec = record(config)
    values = {m["name"]: run.load_reader(m["name"])(rec) for m in SPEC["per_layer"]}
    sizes = mlp_sizes(6, 80)
    f1, f2 = loss_kernel_flops(sizes, 120_000)
    assert values["k1_loss_fwd_roofline"] == pytest.approx(100 * (1e3 * f1 / H100_BF16_FLOPS) / 0.94)
    assert values["k2_loss_bwd_roofline"] == pytest.approx(
        100 * roofline_ms(f2, 0) / 4.24)
    assert values["launches_per_step.adam"] == 5
    assert values["plain_ms_per_step.adam"] == pytest.approx(0.06)
    busy = 2 * (940 + 20 + 30 + 4240 + 10)
    assert values["idle_share.adam"] == pytest.approx(100 * (1 - busy / rec["window_us"]))
    assert values["mfu.adam"] == pytest.approx(100 * 2.0e7 * 997_680 / H100_BF16_FLOPS)
    b = trace.breakdown(rec)
    assert b["device_ops"][0][0].startswith("void loss_bwd_kernel")
    assert b["device_ops"][0][1] == pytest.approx(2 * 4240e-6)
    # the longest gaps: the window's tail (no host op open), then its head
    assert b["idle_gaps"][:2] == [["python", pytest.approx(105e-6)],
                                  ["aten::cat", pytest.approx(50e-6)]]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_readers_find_nothing_in_an_empty_trace():
    config = run.load_json(run.HERE, "configs", "ev-nsfnet-re2000-6x80.json")
    rec = dict(record(config), device=[])
    for m in SPEC["per_layer"]:
        if m["source"] == "device_trace":
            assert run.load_reader(m["name"])(rec) is None, m["name"]


def test_no_card_exits_without_a_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed",
                        "3", "--seconds", "1", "--trace", "0"], cwd=run.ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(run.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.'); from benchmark import run; "
            f"r, c = run.run_cell({CELLS[0]!r}, 3, 0.1, False, device='cpu', n_f=256, "
            "chunk_steps=1, t0=0.0); run.emit(r, c)")
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "nsfnet_tpu_torch" in r.stderr
    assert r.stdout.strip() == ""
