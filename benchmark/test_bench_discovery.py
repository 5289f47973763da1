"""A configuration, a traffic mix, a driver, a cell's limits and a per-layer
metric added as new files (and new entries of BENCHMARK.json) to a copy of
the benchmark are found by name, and no file that was there changes; so is
a configuration of the other formulation with a reference of its own."""

import hashlib
import json
import os
import re
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

STUB = '''"""A reference added by a later change, for a streamfunction
configuration: a stub that records what it is handed and returns a step's
worth of numbers for each of its own terms."""
import json
import os

import torch

TERMS = ("total", "boundary", "eq1", "eq2", "eq4")  # continuity is 0 by construction


def adam_steps(inputs, app, lr, n_steps, block=20000, mm=None, tf32=False):
    with open(os.environ["STUB_SEEN"], "a") as f:
        f.write(json.dumps({"head": inputs.params[-1][0].shape[1],
                            "evm": inputs.params_evm is not None,
                            "n_f": inputs.x_f.shape[0]}) + "\\n")
    leaves = [t.detach().clone() for pair in inputs.params for t in pair]
    return {"losses": [[1.0] * len(TERMS)] * n_steps,
            "first_grad": [torch.ones_like(t) for t in leaves], "params": leaves,
            "params_evm": [t.detach() for pair in inputs.params_evm for t in pair]}
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


def test_a_streamfunction_configuration_plugs_in_as_new_files(tmp_path):
    """A streamfunction ev-NSFnet configuration with a reference of its own
    (TERMS without eq3), its cell and its limits, added as new files and new
    entries: the per-cell collection hands it its own inputs (a 2-wide
    head, the EVM net), its own reference and its terms, in the run and in
    the per-cell tests, and no file that was there changes."""
    from benchmark.flops import app_flops_per_point

    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), tmp_path)
    bench = tmp_path / "benchmark"
    shutil.copytree(run.HERE, bench, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path)

    config = json.loads((bench / "configs" / "ev-nsfnet-re2000-6x80.json").read_text())
    config["app_config"]["network"]["formulation"] = "streamfunction"
    config.update(name="sf-demo", reference="sf_stub",
                  model_flops_per_point=app_flops_per_point(config["app_config"]))
    (bench / "configs" / "sf-demo.json").write_text(json.dumps(config))
    (bench / "reference" / "sf_stub.py").write_text(STUB)
    (bench / "limits" / "sf-demo-adam.json").write_text(
        (bench / "limits" / "ev6x80-adam.json").read_text())
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "sf-demo", "source": "https://example.org/demo",
                            "file": "benchmark/configs/sf-demo.json", "reduced": [],
                            "why": "demo"})
    spec["workloads"].append({"name": "sf-demo-adam", "config": "sf-demo",
                              "traffic": "adam-c200", "chips": 1, "why": "demo"})
    joined = ["adam_points_per_s", "mfu.adam", "plain_ms_per_step.adam",
              "host_launch_ms_per_step.adam"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in joined:
            m["workloads"].append("sf-demo-adam")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    seen = tmp_path / "seen.jsonl"
    code = ("import json, sys, torch; sys.path.insert(0, '.'); from benchmark import compare, run; "
            "from benchmark.inputs import make_inputs; "
            "assert run.HERE.startswith(sys.argv[1]), run.HERE; "
            "p = run.load_cell('sf-demo-adam'); p.app['training']['N_f'] = 256; "
            "inp = make_inputs(p.app, 5, 'cpu'); "
            "prog = p.driver.prefix(p.app, p.traffic, 5, inp, torch.device('cpu'), p.reference)[1]; "
            "ref = p.driver.reference_run(inp, p.app, p.traffic, p.reference); "
            "r, c = run.run_cell('sf-demo-adam', 7, 0.1, False, device='cpu', n_f=256, "
            "chunk_steps=2, t0=0.0); "
            "spec = run.load_json(run.ROOT, 'BENCHMARK.json'); "
            "cell = run.cell_of(spec, 'sf-demo-adam'); "
            "print(json.dumps({'reference': p.reference.__name__, 'terms': p.reference.TERMS, "
            "'read': prog['losses'][0], 'gaps': list(compare.term_gaps(prog, ref, p.reference.TERMS)), "
            "'line': r, 'per_layer': [m['name'] for m in run.metrics_of(spec, cell, 'per_layer')]}))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), run.ROOT]),
               STUB_SEEN=str(seen))
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    terms = ["total", "boundary", "eq1", "eq2", "eq4"]
    assert got["reference"] == "benchmark.reference.sf_stub" and got["terms"] == terms
    # the solver's metrics read by those names: five, none of them continuity's 0
    assert len(got["read"]) == 5 and all(v > 0 for v in got["read"])
    assert got["gaps"] == terms
    # the reference got the configuration's own inputs, in both places
    assert [json.loads(x) for x in seen.read_text().splitlines()] == \
        [{"head": 2, "evm": True, "n_f": 256}] * 2
    line = got["line"]
    assert set(line["metrics"]) == {"adam_points_per_s", "setup_s"}
    assert set(line["compared"]) == {"loss_gap", "grad_gap", "delta_gap"}
    assert got["per_layer"] == joined[1:]

    # the per-cell tests take it up: its count passes, and each per-cell test
    # has a case of its own for it
    r = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                        "benchmark/test_bench_flops.py", "-k", "sf-demo"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and re.search(r"\b1 passed", r.stdout), r.stdout[-3000:]
    r = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                        "--collect-only", "benchmark/test_bench_reference.py",
                        "benchmark/test_bench_run.py"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:]
    ids = r.stdout.splitlines()
    for test in ("test_reference_agrees_with_the_plain_path[sf-demo-16]",
                 "test_control_fails_the_check[sf-demo-adam]",
                 "test_each_fault_makes_the_run_incorrect[sf-demo-adam-equation_dropped]",
                 "test_cell_runs_end_to_end[sf-demo-adam]"):
        assert any(i.endswith(test) for i in ids), test

    after = _digests(tmp_path)
    assert {k: after[k] for k in before if k != "BENCHMARK.json"} == \
        {k: v for k, v in before.items() if k != "BENCHMARK.json"}
    old = json.loads(open(os.path.join(run.ROOT, "BENCHMARK.json")).read())
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for a, b in zip(old[key], spec[key]):  # entries only added; a cell only joins a list
            assert {k: v for k, v in a.items() if k != "workloads"} == \
                {k: v for k, v in b.items() if k != "workloads"}
            assert b.get("workloads", [])[:len(a.get("workloads", []))] == a.get("workloads", [])
