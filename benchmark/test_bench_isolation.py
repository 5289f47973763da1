"""What the benchmark loads: never JAX or the JAX package (compared by whole
top-level name, since the port's name begins with the JAX package's), and
never the port's own measurement entry points, which later changes may
edit."""

import ast
import os
import subprocess
import sys

from benchmark import run

BANNED = ("nsfnet_tpu_torch.bench", "nsfnet_tpu_torch.tools.perf_matrix")


def test_a_run_loads_no_jax_and_no_measurement_entry_point():
    code = ("import sys, json; sys.path.insert(0, '.'); from benchmark import run; "
            "r, c = run.run_cell(run.load_json(run.ROOT, 'BENCHMARK.json')['workloads'][0]"
            "['name'], 9, 0.1, True, device='cpu', n_f=256, chunk_steps=1, t0=0.0); "
            "print(json.dumps({'forbidden': run.forbidden_modules(), "
            "'mods': sorted(m for m in sys.modules if m.startswith('nsfnet'))}))")
    r = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    import json
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["forbidden"] == []
    assert "nsfnet_tpu_torch" in got["mods"]
    assert not any(m in got["mods"] for m in BANNED)
    assert not any(m.split(".")[0] == "nsfnet_tpu" for m in got["mods"])


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "nsfnet_tpu_torch_x", sys)
    assert "nsfnet_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in run.forbidden_modules()


def test_no_source_imports_them():
    for d, _, files in os.walk(run.HERE):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(d, f)).read())
            for node in ast.walk(tree):
                names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                         [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                for n in names:
                    assert n.split(".")[0] not in run.FORBIDDEN, (f, n)
                    assert not any(n == b or n.startswith(b + ".") for b in BANNED), (f, n)
