"""The reference against the port's plain path on the CPU, and the check
decided false under the control and under each planted fault."""

import ast
import contextlib
import copy
import os

import pytest
import torch

from benchmark import compare, faults, run
from benchmark.drivers import adam
from benchmark.inputs import make_inputs

SPEC = run.load_json(run.ROOT, "BENCHMARK.json")
CELLS = [w["name"] for w in SPEC["workloads"]]
CONFIGS = [c["name"] for c in SPEC["configs"]]


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
@pytest.mark.parametrize("name", CONFIGS)
def test_reference_agrees_with_the_plain_path(name, hidden):
    """Each configuration's own reference against the port's plain path on
    its own inputs, the main net cut to 3 hidden layers."""
    config = run.load_config(name)
    reference = run.reference_of(config)
    app = copy.deepcopy(config["app_config"])
    app["network"].update(layers=3, hidden_size=hidden)
    app["training"]["N_f"] = 256
    inp = make_inputs(app, 123, "cpu")
    lr = adam.stage_lr(app)
    prog = adam.checked_steps(adam.build(app, 123, inp, torch.device("cpu")), lr, 3,
                              reference.TERMS)
    ref = reference.adam_steps(inp, app, lr, 3, block=100)
    values = compare.readings(prog, ref, adam.leaves(inp.params))
    assert values["loss_gap"] < 1e-5 and values["grad_gap"] < 1e-6
    assert values["delta_gap"] < 1e-5


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_check(cell):
    """The reference computed with one bfloat16 pass, put in the port's place."""
    parts = run.load_cell(cell)
    app, driver, traffic, reference = parts.app, parts.driver, parts.traffic, parts.reference
    app["training"]["N_f"] = 1024
    inp = make_inputs(app, 2**31 + 5, "cpu")
    ref = driver.reference_run(inp, app, traffic, reference)
    low = driver.reference_run(inp, app, traffic, reference, mm=faults.bf16_product)
    judged = compare.judge(driver.readings(low, ref, inp), parts.limits)
    assert not all(c["ok"] for c in judged.values())


@pytest.mark.parametrize("fault", list(faults.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_each_fault_makes_the_run_incorrect(cell, fault):
    with faults.FAULTS[fault]():
        result, _ = run.run_cell(cell, 2**31 + 17, 0.1, False, device="cpu", n_f=1024,
                                 chunk_steps=1, t0=0.0)
    assert result["correct"] is False


# configurations of the kinds the next cells bring (BENCHMARK.json has none
# yet): the streamfunction ev-NSFnet, and the vanilla NSFnet (no EVM net)
KINDS = {"streamfunction-ev": {"formulation": "streamfunction"},
         "velocity-no-evm": {"model_variant": "nsfnet"}}


def _checked(kind, fault=None):
    app = copy.deepcopy(run.load_config(CONFIGS[0])["app_config"])
    change = KINDS[kind]
    app["network"].update(formulation=change.get("formulation", "velocity"), layers=3,
                          hidden_size=16)
    app["model_variant"] = change.get("model_variant", app["model_variant"])
    app["training"]["N_f"] = 256
    inp = make_inputs(app, 2**31 + 43, "cpu")
    terms = ("total", "boundary", "eq1", "eq2", "eq3", "eq4")
    with faults.FAULTS[fault]() if fault else contextlib.nullcontext():
        solver = adam.build(app, 1, inp, torch.device("cpu"))
        return adam.checked_steps(solver, adam.stage_lr(app), 2, terms)


@pytest.mark.parametrize("fault", list(faults.FAULTS))
@pytest.mark.parametrize("kind", list(KINDS))
def test_each_fault_reaches_the_other_kinds_of_configuration(kind, fault):
    """Each fault changes what the checked steps of such a configuration give,
    so that its cell's check can see it."""
    sound, faulted = _checked(kind), _checked(kind, fault)
    assert faulted["losses"] != sound["losses"]
    assert not all(a.equal(b) for a, b in zip(faulted["params"], sound["params"]))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's own lower precision runs in its kernels")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card_fails_the_check(cell, card):
    """The port with its own lower precision, "default" (one bf16 pass)."""
    parts = run.load_cell(cell)
    app, driver, traffic, reference = parts.app, parts.driver, parts.traffic, parts.reference
    app["training"]["N_f"] = 16_384
    inp = make_inputs(app, 2**31 + 23, card)
    ref = driver.reference_run(inp, app, traffic, reference)
    sound = driver.prefix(app, traffic, 1, inp, card, reference)[1]
    app["training"]["matmul_precision"] = "default"
    low = driver.prefix(app, traffic, 1, inp, card, reference)[1]
    ok = lambda p: all(c["ok"] for c in compare.judge(driver.readings(p, ref, inp),
                                                      parts.limits).values())
    assert ok(sound) and not ok(low)
