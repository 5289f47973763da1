"""Back-to-back L-BFGS polish stages through the port's normal path.

Set-up builds the solver as the Adam driver does and runs its checked Adam
steps (`checked_steps`, the start of the run, compared as in an Adam cell),
then one L-BFGS stage of `checked_lbfgs_steps` steps, `PINNSolver.train(n,
optimizer="lbfgs")`, the call the window makes; then one warm-up stage.
The window runs whole stages of `stage_steps` steps until `seconds` have
passed, so it ends at a stage end; its rate counts the points of every
value-and-grad evaluation (`polish_stats["evaluations"]`). With tracing, one
more stage of `traced_steps` steps runs under the profiler.

The reference (the configuration's) repeats the Adam steps from the same
inputs and then the L-BFGS stage from its own state. The stage's numbers:
`lbfgs_loss_gap`, the largest relative gap of the loss at the start of each
step; `lbfgs_delta_gap`, the change of both nets over the stage by the
median leaf (compare.median_leaf_gap), leaves whose reference gradient at
the stage's start is nought to round-off left out. L-BFGS keeps its gradients
inside the stage, so no first gradient of the program's is compared there.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from benchmark import compare
from benchmark.drivers import adam
from benchmark.inputs import make_inputs


def _both(solver):
    return adam.leaves(solver.params()) + adam.leaves(solver.params_evm())


def prefix(app: dict, traffic: dict, seed: int, inp, dev):
    """The solver and what its checked Adam steps and checked L-BFGS stage
    produced."""
    solver, prog_adam = adam.prefix(app, traffic, seed, inp, dev)
    start = _both(solver)
    solver.train(num_epoch=int(traffic["checked_lbfgs_steps"]), optimizer="lbfgs")
    st = solver.polish_stats
    return solver, {"adam": prog_adam, "start": start, "history": list(st["history"]),
                    "evaluations": list(st["evaluations"]), "params": _both(solver)}


def reference_run(inp, app: dict, traffic: dict, reference, **precision) -> dict:
    ref_adam = adam.reference_run(inp, app, traffic, reference, **precision)
    lb = reference.lbfgs_steps(ref_adam["params"], ref_adam["params_evm"], inp, app,
                               int(traffic["checked_lbfgs_steps"]),
                               tf32=precision.get("tf32", False))
    return dict(lb, adam=ref_adam, start=ref_adam["params"] + ref_adam["params_evm"])


def readings(prog: dict, ref: dict, inp) -> dict:
    delta = lambda d: [a - s for a, s in zip(d["params"], d["start"])]
    return dict(adam.readings(prog["adam"], ref["adam"], inp),
                lbfgs_loss_gap=compare.relative_gap(prog["history"], ref["history"]),
                lbfgs_delta_gap=compare.median_leaf_gap(delta(prog), delta(ref),
                                                        compare.moved_leaves(ref["first_grad"])))


def run(ctx) -> dict:
    app, traffic, dev = ctx.app, ctx.traffic, torch.device(ctx.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    inp = make_inputs(app, ctx.seed, dev)
    solver, prog = prefix(app, traffic, ctx.seed, inp, dev)
    points_per_eval = inp.x_f.shape[0] + inp.x_b.shape[0]
    stage = int(traffic["stage_steps"])

    def one_stage(n):
        solver.train(num_epoch=n, optimizer="lbfgs")
        return solver.polish_stats

    one_stage(stage)  # warm-up
    sync()

    window_start = time.perf_counter()
    steps = failed = evaluations = 0
    while True:
        st = one_stage(stage)
        sync()
        steps += len(st["history"])
        evaluations += sum(st["evaluations"])
        if not math.isfinite(st["history"][-1]):
            failed += len(st["history"])
        if time.perf_counter() - window_start >= ctx.seconds:
            break
    window_s = time.perf_counter() - window_start
    rate = evaluations * points_per_eval / window_s

    record = None
    if ctx.trace and dev.type == "cuda":
        from benchmark.trace import trace_chunk

        traced = {}
        record = trace_chunk(lambda: traced.update(one_stage(int(traffic["traced_steps"]))))
        record.update(steps=len(traced["history"]), evaluations=sum(traced["evaluations"]),
                      points_per_s=rate, n_f=int(inp.x_f.shape[0]))

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del solver
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    values = readings(prog, reference_run(inp, app, traffic, ctx.reference), inp)
    return {"window_start": window_start, "end_to_end": {"lbfgs_points_per_s": rate},
            "attempted": steps, "failed": failed, "record": record,
            "memory_peak_bytes": peak, "compared": compare.judge(values, ctx.limits)}
