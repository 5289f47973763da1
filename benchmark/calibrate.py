#!/usr/bin/env python3
"""Readings that the limits of `correct` are set from, on the card, at the
cell's own size (PERF.md gives them beside each limit).

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,... \
        [--faulted 3] [--out chiprun_out/calibrate_<cell>.jsonl]

For each seed, in one process: the inputs, the reference's checked steps
once, then the port's checked steps as the cell's driver runs them
(`sound`), with its own lower precision, "default", switched on
(`control`), and, on the first `--faulted` seeds, with each fault of
faults.py planted, and the reference itself put in the port's place with one
bfloat16 pass (`ref_bf16`) and with TF32 (`ref_tf32`). Prints one JSON line per seed and
variant, and a summary of each variant's least and largest readings. The
benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from benchmark import compare, faults, run  # noqa: E402
from benchmark.drivers import adam  # noqa: E402
from benchmark.inputs import make_inputs  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--faulted", type=int, default=3, help="seeds that also get the faults")
    p.add_argument("--device", default="cuda")
    p.add_argument("--n-f", type=int, default=None, help="collocation points (tests)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import importlib

    import torch

    spec = run.load_json(run.ROOT, "BENCHMARK.json")
    cell = run.cell_of(spec, args.workload)
    config = run.load_json(HERE, "configs", f"{cell['config']}.json")
    traffic = run.load_json(HERE, "traffic", f"{cell['traffic']}.json")
    limits = run.load_json(HERE, "limits", f"{args.workload}.json")
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    reference = importlib.import_module(f"benchmark.reference.{config['reference']}")
    app = copy.deepcopy(config["app_config"])
    if args.n_f is not None:
        app["training"]["N_f"] = args.n_f
    control = copy.deepcopy(app)
    control["training"]["matmul_precision"] = "default"
    dev = torch.device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    rows = []
    out = open(args.out, "w") if args.out else None

    def emit(row):
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        inp = make_inputs(app, seed, dev)
        sync()
        t = time.perf_counter()
        ref = driver.reference_run(inp, app, traffic, reference)
        sync()
        ref_s = time.perf_counter() - t
        variants = [("sound", app, None), ("control", control, None)]
        if i < args.faulted:
            variants += [(name, app, make) for name, make in faults.FAULTS.items()]
        for name, a, make in variants:
            with (make() if make else contextlib.nullcontext()):
                solver, prog = driver.prefix(a, traffic, seed, inp, dev)
            del solver
            row = dict(seed=seed, variant=name, ref_s=ref_s, **driver.readings(prog, ref, inp))
            adam_part = (prog.get("adam", prog), ref.get("adam", ref))
            row["terms"] = compare.term_gaps(*adam_part)
            row["not_compared"] = compare.not_compared(*adam_part, adam.leaves(inp.params))
            emit(row)
        if i < args.faulted:
            for name, precision in (("ref_bf16", {"mm": faults.bf16_product}),
                                    ("ref_tf32", {"tf32": True})):
                low = driver.reference_run(inp, app, traffic, reference, **precision)
                emit(dict(seed=seed, variant=name, ref_s=ref_s,
                          **driver.readings(low, ref, inp)))
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    summary = {}
    for r in rows:
        s = summary.setdefault(r["variant"], {k: [float("inf"), 0.0] for k in limits})
        for k in limits:
            s[k] = [min(s[k][0], r[k]), max(s[k][1], r[k])]
    line = json.dumps({"summary": summary, "limits": limits})
    print(line, flush=True)
    if out:
        out.write(line + "\n")
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
