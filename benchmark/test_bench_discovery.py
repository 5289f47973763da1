"""A configuration, a traffic mix, a driver, a cell's limits and a per-layer
metric added as new files (and new entries of BENCHMARK.json) to a copy of
the benchmark are found by name, and no file that was there changes."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from benchmark import run

DRIVER = '''"""A driver added by a later change: the Adam driver, with a metric of its own."""
from benchmark.drivers import adam


def run(ctx):
    out = adam.run(ctx)
    out["end_to_end"]["demo_points_per_s"] = out["end_to_end"]["adam_points_per_s"]
    return out
'''
READER = '''"""A reader added by a later change."""


def read(rec):
    return float(len(rec["device"])) or None
'''


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_files_are_found_by_name(tmp_path):
    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), tmp_path)
    bench = tmp_path / "benchmark"
    shutil.copytree(run.HERE, bench, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path)

    config = json.loads((bench / "configs" / "ev-nsfnet-re2000-6x80.json").read_text())
    config.update(name="demo-4x48", model_flops_per_point=1.0)
    config["app_config"]["network"].update(layers=4, hidden_size=48)
    (bench / "configs" / "demo-4x48.json").write_text(json.dumps(config))
    (bench / "traffic" / "demo-mix.json").write_text(json.dumps(
        {"driver": "demo_driver", "checked_steps": 3, "chunk_steps": 2, "traced_steps": 2}))
    (bench / "drivers" / "demo_driver.py").write_text(DRIVER)
    (bench / "metrics" / "demo.share.py").write_text(READER)
    (bench / "limits" / "demo-cell.json").write_text(
        (bench / "limits" / "ev6x80-adam.json").read_text())
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "demo-4x48", "source": "https://example.org/demo",
                            "file": "benchmark/configs/demo-4x48.json", "reduced": [],
                            "why": "demo"})
    spec["workloads"].append({"name": "demo-cell", "config": "demo-4x48",
                              "traffic": "demo-mix", "chips": 1, "why": "demo"})
    spec["end_to_end"].append({"name": "demo_points_per_s", "unit": "points/s",
                               "better": "higher", "bound": 0.01, "source": "host_clock",
                               "workloads": ["demo-cell"]})
    spec["per_layer"].append({"name": "demo.share", "unit": "%", "better": "higher",
                              "source": "device_trace", "layer": "device",
                              "moves": "demo_points_per_s", "workloads": ["demo-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    code = ("import json, sys; sys.path.insert(0, '.'); from benchmark import run; "
            "assert run.HERE.startswith(sys.argv[1]), run.HERE; "
            "r, c = run.run_cell('demo-cell', 7, 0.1, False, device='cpu', n_f=512, t0=0.0); "
            "spec = run.load_json(run.ROOT, 'BENCHMARK.json'); "
            "cell = run.cell_of(spec, 'demo-cell'); "
            "names = [m['name'] for m in run.metrics_of(spec, cell, 'per_layer')]; "
            "v = run.load_reader('demo.share')({'device': [1, 2]}); "
            "print(json.dumps({'line': r, 'per_layer': names, 'read': v}))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), run.ROOT]))
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert set(got["line"]["metrics"]) == {"demo_points_per_s", "setup_s"}
    assert got["line"]["correct"] is True
    assert got["per_layer"] == ["demo.share"] and got["read"] == 2.0

    after = _digests(tmp_path)
    assert {k: after[k] for k in before if k != "BENCHMARK.json"} == \
        {k: v for k, v in before.items() if k != "BENCHMARK.json"}
    old = json.loads(open(os.path.join(run.ROOT, "BENCHMARK.json")).read())
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert spec[key][:len(old[key])] == old[key]  # entries only added
