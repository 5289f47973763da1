"""Full-batch Adam through the port's normal path.

Set-up builds one `PINNSolver` from the configuration as
`nsfnet_tpu_torch.train.build_solver` does, hands it the inputs made from the
seed (points, weights), and drives it through its first `checked_steps` steps with
`run_steps`, the call the window makes; those steps are what `correct` is
decided on. Then one warm-up chunk, then the window: whole chunks of
`chunk_steps` steps, each ended by a synchronisation, until `seconds` have
passed. With tracing, one more chunk of `traced_steps` steps runs under the
profiler. Once the peak memory is read and the solver is freed, the
configuration's reference runs the checked steps again from the same inputs.

Every run starts at stage step 0 and the EVM net's gated update comes at
stage step `evm_update_freq` (10,000), which no window reaches.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from benchmark import compare
from benchmark.inputs import make_inputs

ADAM_B1 = 0.9  # the configuration's Adam (torch.optim.Adam's defaults)


def leaves(pairs):
    """Copies of a net's (W, b) pairs as one list: W0, b0, W1, b1, ..."""
    return [t.detach().clone() for pair in pairs for t in pair]


def build(app: dict, seed: int, inp, dev):
    """The port's solver for `app`, built as train.build_solver builds it,
    holding the inputs (points and weights) made from the seed. The engine
    is named: "pallas" is what "auto" gives on a card, and on the CPU it
    runs the same kernel wiring with the kernels' plain versions."""
    from nsfnet_tpu_torch.config import ConfigManager
    from nsfnet_tpu_torch.train import solver_kwargs
    from nsfnet_tpu_torch.training.solver import PINNSolver

    cfg = ConfigManager.from_dict(app).config
    cfg.training.seed = int(seed)
    solver = PINNSolver(**solver_kwargs(cfg), engine="pallas", device=dev)
    solver.set_alpha_evm(float(app["training"]["training_stages"][0]["alpha"]))
    host = lambda t: t.cpu().numpy()
    solver.set_boundary_data(X=tuple(host(t) for t in (inp.x_b, inp.y_b, inp.u_b, inp.v_b)))
    solver.set_eq_training_data(X=(host(inp.x_f), host(inp.y_f)), weights=host(inp.w_f))
    solver.set_params(inp.params, inp.params_evm)
    return solver


def checked_steps(solver, lr: float, n: int) -> dict:
    """The first `n` steps, one `run_steps` call each: each step's loss terms
    (compare.TERMS), the first gradient as Adam got it (its first moment
    over 1 - b1) and the weights after the steps, as leaves W0, b0, W1, b1,
    ..."""
    losses, first_grad = [], None
    for i in range(n):
        m = solver.run_steps(1, lr)
        losses.append(torch.stack([m.total, m.boundary, m.eq1, m.eq2, m.eq3, m.eq4]))
        if i == 0:
            first_grad = [t / (1.0 - ADAM_B1) for t in leaves(
                solver.net.unflatten(solver.state.opt_main.mu))]
    return {"losses": [x.tolist() for x in losses], "first_grad": first_grad,
            "params": leaves(solver.params())}


def stage_lr(app: dict) -> float:
    return float(app["training"]["training_stages"][0]["lr"])


def prefix(app: dict, traffic: dict, seed: int, inp, dev):
    """The solver and what its checked steps produced."""
    solver = build(app, seed, inp, dev)
    return solver, checked_steps(solver, stage_lr(app), int(traffic["checked_steps"]))


def reference_run(inp, app: dict, traffic: dict, reference, **precision) -> dict:
    """The reference's checked steps from the same inputs; `precision` (mm,
    tf32) lowers it for a control."""
    return reference.adam_steps(inp, app, stage_lr(app), int(traffic["checked_steps"]),
                                **precision)


def readings(prog: dict, ref: dict, inp) -> dict:
    return compare.readings(prog, ref, leaves(inp.params))


def run(ctx) -> dict:
    app, traffic, dev = ctx.app, ctx.traffic, torch.device(ctx.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    lr = stage_lr(app)
    inp = make_inputs(app, ctx.seed, dev)
    # the checked steps: the window's own call on the window's own batch
    solver, prog = prefix(app, traffic, ctx.seed, inp, dev)
    points_per_step = inp.x_f.shape[0] + inp.x_b.shape[0]

    chunk = int(traffic["chunk_steps"])
    solver.run_steps(chunk, lr)  # warm-up
    sync()

    window_start = time.perf_counter()
    steps = failed = 0
    while True:
        m = solver.run_steps(chunk, lr)
        sync()
        steps += chunk
        if not math.isfinite(float(m.total)):
            failed += chunk
        if time.perf_counter() - window_start >= ctx.seconds:
            break
    window_s = time.perf_counter() - window_start
    rate = steps * points_per_step / window_s

    record = None
    if ctx.trace and dev.type == "cuda":
        from benchmark.trace import trace_chunk

        traced = int(traffic["traced_steps"])
        record = trace_chunk(lambda: solver.run_steps(traced, lr))
        record.update(steps=traced, points_per_s=rate, n_f=int(inp.x_f.shape[0]))

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del solver, m
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    values = readings(prog, reference_run(inp, app, traffic, ctx.reference), inp)
    return {"window_start": window_start, "end_to_end": {"adam_points_per_s": rate},
            "attempted": steps, "failed": failed, "record": record,
            "memory_peak_bytes": peak, "compared": compare.judge(values, ctx.limits)}
