"""The reference against the port's plain path on the CPU, and the check
decided false under the control and under each planted fault."""

import ast
import importlib
import json
import os

import pytest
import torch

from benchmark import compare, faults, run
from benchmark.drivers import adam
from benchmark.inputs import make_inputs
from benchmark.reference import ev_nsfnet

SPEC = run.load_json(run.ROOT, "BENCHMARK.json")
CELLS = [w["name"] for w in SPEC["workloads"]]


def _config(cell):
    return run.load_json(run.HERE, "configs", f"{run.cell_of(SPEC, cell)['config']}.json")


def test_reference_imports_nothing_of_the_port():
    d = os.path.join(run.HERE, "reference")
    for f in os.listdir(d):
        if f.endswith(".py"):
            for node in ast.walk(ast.parse(open(os.path.join(d, f)).read())):
                if isinstance(node, (ast.Import, ast.ImportFrom)):
                    names = [a.name for a in node.names] if isinstance(node, ast.Import) \
                        else [node.module or ""]
                    assert all(n.split(".")[0] in ("torch", "numpy", "__future__", "contextlib",
                                                   "typing") or n == "benchmark.reference"
                               for n in names), (f, names)


@pytest.mark.parametrize("hidden", [16, 80])
def test_reference_agrees_with_the_plain_path(hidden):
    app = json.loads(json.dumps(_config(CELLS[0])["app_config"]))
    app["network"].update(layers=3, hidden_size=hidden)
    app["training"]["N_f"] = 256
    inp = make_inputs(app, 123, "cpu")
    lr = adam.stage_lr(app)
    prog = adam.checked_steps(adam.build(app, 123, inp, torch.device("cpu")), lr, 3)
    ref = ev_nsfnet.adam_steps(inp, app, lr, 3, block=100)
    values = compare.readings(prog, ref, adam.leaves(inp.params))
    assert values["loss_gap"] < 1e-5 and values["grad_gap"] < 1e-6
    assert values["delta_gap"] < 1e-5


def _driver(cell):
    traffic = run.load_json(run.HERE, "traffic", f"{run.cell_of(SPEC, cell)['traffic']}.json")
    return importlib.import_module(f"benchmark.drivers.{traffic['driver']}"), traffic


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_check(cell):
    """The reference computed with one bfloat16 pass, put in the port's place."""
    app = json.loads(json.dumps(_config(cell)["app_config"]))
    app["training"]["N_f"] = 1024
    inp = make_inputs(app, 2**31 + 5, "cpu")
    driver, traffic = _driver(cell)
    ref = driver.reference_run(inp, app, traffic, ev_nsfnet)
    low = driver.reference_run(inp, app, traffic, ev_nsfnet, mm=faults.bf16_product)
    judged = compare.judge(driver.readings(low, ref, inp),
                           run.load_json(run.HERE, "limits", f"{cell}.json"))
    assert not all(c["ok"] for c in judged.values())


@pytest.mark.parametrize("fault", list(faults.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_each_fault_makes_the_run_incorrect(cell, fault):
    with faults.FAULTS[fault]():
        result, _ = run.run_cell(cell, 2**31 + 17, 0.1, False, device="cpu", n_f=1024,
                                 chunk_steps=1, t0=0.0)
    assert result["correct"] is False


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's own lower precision runs in its kernels")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card_fails_the_check(cell, card):
    """The port with its own lower precision, "default" (one bf16 pass)."""
    app = json.loads(json.dumps(_config(cell)["app_config"]))
    app["training"]["N_f"] = 16_384
    inp = make_inputs(app, 2**31 + 23, card)
    driver, traffic = _driver(cell)
    ref = driver.reference_run(inp, app, traffic, ev_nsfnet)
    sound = driver.prefix(app, traffic, 1, inp, card)[1]
    app["training"]["matmul_precision"] = "default"
    low = driver.prefix(app, traffic, 1, inp, card)[1]
    limits = run.load_json(run.HERE, "limits", f"{cell}.json")
    ok = lambda p: all(c["ok"] for c in compare.judge(driver.readings(p, ref, inp),
                                                      limits).values())
    assert ok(sound) and not ok(low)
