"""The L-BFGS polish cell (`ev6x80-lbfgs`), built and calibrated but not yet
in BENCHMARK.json (PERF.md, Open questions): these are the entries a change
adds to make it a cell. Its driver, reference, readers and limits are
tested here through a BENCHMARK.json that holds them."""

import contextlib
import copy

import pytest

from benchmark import faults, run
from benchmark.test_bench_run import record

CELL = {"name": "ev6x80-lbfgs", "config": "ev-nsfnet-re2000-6x80", "traffic": "lbfgs-s50",
        "chips": 1,
        "why": "122,052 points an L-BFGS evaluation, 50-step stages after 3 Adam steps; kernels "
               "bypassed (closed form, exact fp32), one host sync per line-search trial"}
END_TO_END = {"name": "lbfgs_points_per_s", "unit": "points/s", "better": "higher",
              "bound": 0.17, "source": "host_clock", "workloads": [CELL["name"]]}
POLISH = "polish: training/lbfgs.py, solver.train_lbfgs on the closed form"
PER_LAYER = [
    {"name": "mfu.lbfgs", "unit": "%", "better": "higher", "source": "host_clock",
     "layer": POLISH, "moves": "lbfgs_points_per_s", "workloads": [CELL["name"]]},
    {"name": "launches_per_eval.lbfgs", "unit": "launches", "better": "lower",
     "source": "device_trace", "layer": POLISH, "moves": "lbfgs_points_per_s",
     "workloads": [CELL["name"]]},
    {"name": "idle_share.lbfgs", "unit": "%", "better": "lower", "source": "device_trace",
     "layer": "device", "moves": "lbfgs_points_per_s", "workloads": [CELL["name"]]},
]


@pytest.fixture
def with_cell(monkeypatch):
    load = run.load_json

    def load_json(*parts):
        data = load(*parts)
        if parts[-1] == "BENCHMARK.json":
            data = copy.deepcopy(data)
            data["workloads"].append(CELL)
            data["end_to_end"].insert(-1, END_TO_END)
            data["per_layer"] += PER_LAYER
        return data

    monkeypatch.setattr(run, "load_json", load_json)


@pytest.mark.parametrize("fault", [None] + list(faults.FAULTS))
def test_the_cell_runs_and_each_fault_fails_it(with_cell, fault):
    with faults.FAULTS[fault]() if fault else contextlib.nullcontext():
        result, compared = run.run_cell(CELL["name"], 2**31 + 29, 0.1, False, device="cpu",
                                        n_f=1024, t0=0.0)
    assert set(result["metrics"]) == {"lbfgs_points_per_s", "setup_s"}
    assert list(compared) == ["loss_gap", "grad_gap", "delta_gap", "lbfgs_loss_gap",
                              "lbfgs_delta_gap"]
    assert result["correct"] is (fault is None)


def test_its_readers():
    config = run.load_json(run.HERE, "configs", f"{CELL['config']}.json")
    rec = record(config)
    read = {m["name"]: run.load_reader(m["name"])(rec) for m in PER_LAYER}
    assert read["mfu.lbfgs"] == run.load_reader("mfu.adam")(rec)
    assert read["launches_per_eval.lbfgs"] == len(rec["device"]) / rec["evaluations"]
    assert read["idle_share.lbfgs"] == run.load_reader("idle_share.adam")(rec)
    assert all(run.load_reader(m["name"])(dict(rec, device=[])) is None
               for m in PER_LAYER if m["source"] == "device_trace")
