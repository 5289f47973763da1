#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Reads the cell from BENCHMARK.json at the root of the checkout and finds
everything else by name under benchmark/: the configuration
(configs/<config>.json, with its reference in reference/<module>.py), the
traffic mix (traffic/<traffic>.json), the driver the mix names
(drivers/<driver>.py), the cell's limits of `correct` (limits/<cell>.json)
and one reader per per-layer metric (metrics/<metric>.py). Prints, as the last line of standard output, one
JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics with `--trace 0`, its per-layer ones with `--trace 1`),
`device`, with `--trace 1` `breakdown`, and last `compared`: each number
the check compared, beside its limit; those also end standard error.

Exits 2 without a result where there is no CUDA card or fewer than the
cell asks for, and 3 where a module of JAX or the JAX package is loaded
once the run is done.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
FORBIDDEN = ("jax", "jaxlib", "flax", "nsfnet_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts), encoding="utf-8") as f:
        return json.load(f)


def cell_of(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(spec: dict, cell: dict, kind: str) -> list:
    """The cell's metrics of `kind` (end_to_end or per_layer): those that
    list it, and those that list no cells. A per-layer metric that lists
    none is reported where the metric it moves is."""
    e2e = {m["name"] for m in metrics_of(spec, cell, "end_to_end")} if kind == "per_layer" else None
    out = []
    for m in spec[kind]:
        if "workloads" in m:
            if cell["name"] in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def load_reader(name: str):
    """metrics/<name>.py; a name may hold dots, so it is loaded by path."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             n_f: int = None, chunk_steps: int = None, t0: float = None):
    """One run of a cell; returns (the result line's object, compared).
    `device` "cpu" skips the look for a card (tests): the port then runs its
    plain versions; `n_f` and `chunk_steps` shrink the cell for such runs."""
    t0 = T0 if t0 is None else t0
    spec = load_json(ROOT, "BENCHMARK.json")
    cell = cell_of(spec, workload)
    config = load_json(HERE, "configs", f"{cell['config']}.json")
    traffic = load_json(HERE, "traffic", f"{cell['traffic']}.json")
    app = json.loads(json.dumps(config["app_config"]))
    if n_f is not None:
        app["training"]["N_f"] = int(n_f)
    if chunk_steps is not None:
        traffic = dict(traffic, chunk_steps=int(chunk_steps))
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    reference = importlib.import_module(f"benchmark.reference.{config['reference']}")
    ctx = SimpleNamespace(app=app, traffic=traffic, seed=int(seed), seconds=float(seconds),
                          trace=bool(trace), device=device, reference=reference,
                          limits=load_json(HERE, "limits", f"{workload}.json"))
    out = driver.run(ctx)

    import torch

    on_card = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(out["memory_peak_bytes"])}
    metrics, breakdown = {}, None
    if not trace:
        values = dict(out["end_to_end"], setup_s=out["window_start"] - t0)
        for m in metrics_of(spec, cell, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    elif out["record"] is not None:
        from benchmark import trace as tr

        rec = dict(out["record"], config=config)
        for m in metrics_of(spec, cell, "per_layer"):
            v = load_reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev.update(busy_s=tr.busy_us(rec) / 1e6, window_s=rec["window_us"] / 1e6)
        breakdown = tr.breakdown(rec)
    compared = out["compared"]
    result = {"correct": all(c["ok"] for c in compared.values()),
              "attempted": int(out["attempted"]), "failed": int(out["failed"]),
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    # a reading that is not finite is written as null: JSON has no NaN
    finite = lambda v: v if math.isfinite(v) else None
    result["compared"] = {k: {"value": finite(c["value"]), "limit": c["limit"]}
                          for k, c in compared.items()}
    return result, compared


def card_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=30)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Run one cell of the port's benchmark once")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cell = cell_of(load_json(ROOT, "BENCHMARK.json"), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"run: the cell needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result, compared = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"run: modules of JAX or the JAX package are loaded: {found}", file=sys.stderr)
        return 3
    print(f"card: {card_line()}", file=sys.stderr)
    emit(result, compared)
    return 0


def emit(result: dict, compared: dict) -> None:
    """Each compared number beside its limit as the last lines of standard
    error, then the result as the last line of standard output."""
    for name, c in compared.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r} {'ok' if c['ok'] else 'FAIL'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())
