"""Precision x backbone throughput matrix of the port (the counterpart of
scripts/perf_matrix.py).

    python -m nsfnet_tpu_torch.tools.perf_matrix [--quick] [--cpu] [--out PATH]

Measures collocation points/s on one card for the flagship ev-NSFnet step
(6x80 + 4x40 EVM, N_f + 2,052 boundary points, Re 2000, Adam) at each
matmul precision name through kernels 1+2 (`mlp/pallas`), for the
streamfunction formulation on the closed-form engine (`sf/xla-closed-form`)
and, on a card, on kernels 5+6 (`sf/pallas`), and for the KAN backbone on
its closed-form engine (`kan/generic`). The method is bench.py's: a warm-up
chunk of Adam steps, then the best of three timed chunks, real points only.
The velocity rows also carry their model FLOP/s (`model_flops_per_point`:
the same count whatever implements the step) and its share of the card's
dense bf16 peak (`mfu`), and `tensor_core_util_pct`, that share times the
bf16 passes the precision name costs.

Each row records the launch counts of the six kernels during its warm-up
and timed chunks: the kernels it timed. On a card, one more chunk of at
most 10 steps runs under torch.profiler for the card's busy time a step
(`device_ms_per_step`) and its share of the timed step (`busy_share`).
A row that raises is recorded with its error and the matrix goes on;
`main` then exits 1. Writes chiprun_out/perf_matrix_torch.json (`--out`),
a markdown table to stderr and one JSON line per row to stdout.

Sizes: N_f 120,000 and 1000-step chunks on a card (the KAN 16,384 and 100);
`--quick`, and the CPU (`--cpu`), take 8,192 and 20 (the KAN 2,048 and 5),
where the `pallas` rows run the kernels' plain versions. Without `--cpu`
and without a card it raises. Run it with no other process on the card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import torch

from nsfnet_tpu_torch.ops import launch_counts

REFERENCE_PTS_PER_SEC = 142_000.0  # 1x P100 (ev-NSFnet/README.md:56)
H100_BF16_PEAK = 989.4e12  # H100 SXM, dense bf16 tensor-core FLOP/s
N_B = 4 * 513  # boundary points of the cavity data

# bf16 tensor-core passes one model FLOP costs at each precision name: the
# kernels' part pairs i + j < parts (ops/fused_residual.PARTS)
PASSES = {"default": 1, "high": 3, "highest": 6}

DEFAULT_OUT = os.path.join("chiprun_out", "perf_matrix_torch.json")
# the longest chunk under the profiler (device_busy): reading its trace back
# in Python takes far longer than the steps themselves
PROFILED_STEPS = 10


def model_flops_per_point(layers=6, hidden=80, layers_1=4, hidden_1=40):
    """Analytic model FLOPs per collocation point per training step.

    The residual engine carries 5 streams (value, d/dx, d/dy, d2/dx2,
    d2/dy2) through every matmul after the analytic first layer: fwd =
    2*2*h + (L-1)*5*(2*h*h) + 5*(2*h*3) for the main net. The EVM net is a
    plain value forward in the loss (no derivative streams). Reverse mode
    costs ~2x the forward, so a step is ~3x fwd. Boundary rows (~2% of the
    points) are counted at the same rate."""

    def fwd(L, h, n_out, streams):
        return (2 * 2 * h + (L - 1) * streams * (2 * h * h)
                + streams * (2 * h * n_out))

    return 3.0 * (fwd(layers, hidden, 3, 5) + fwd(layers_1, hidden_1, 1, 1))


def matrix_sizes(on_card: bool, quick: bool = False):
    """(n_f, steps, kan_n_f, kan_steps) of a run."""
    if on_card and not quick:
        return 120_000, 1000, 16_384, 100
    return 8_192, 20, 2_048, 5


def card_label(device) -> str:
    """`cpu`, or the card's name and power limit as nvidia-smi gives them."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", f"--id={device.index or 0}"],
                             capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(device)}, power limit not read"


def build(n_f, device=None, **kw):
    """The flagship solver (Re 2000, 6x80 + 4x40, alpha_evm 0.05, bc_weight
    10, seed 0; `kw` overrides) on a fresh cavity draw of n_f points,
    ready to step (scripts/perf_matrix.py:78-93)."""
    from nsfnet_tpu_torch.data.cavity import CavityData
    from nsfnet_tpu_torch.training.solver import PINNSolver

    defaults = dict(
        Re=2000, layers=6, layers_1=4, hidden_size=80, hidden_size_1=40,
        N_f=n_f, alpha_evm=0.05, bc_weight=10, eq_weight=1,
        log_interval=10**9, checkpoint_freq=10**9, seed=0)
    defaults.update(kw)
    solver = PINNSolver(**defaults, device=device)
    data = CavityData(N_f=n_f, sort_training_points=False, sdf_enabled=True, seed=0)
    solver.set_boundary_data(X=data.boundary_data())
    solver.set_eq_training_data(X=data.training_data(), weights=data.sdf_weights)
    solver._ensure_ready()
    return solver


def measure(solver, n_f, steps):
    """Adam steps at lr 1e-3 in chunks of `steps`: one warm-up chunk, then
    three timed ones, the card synchronised around each. Returns (points/s
    of the best chunk, its ms per step, every chunk's ms per step, the
    warm-up first); real points only, n_f + 2,052 a step."""
    n_b = int(solver._batch.n_b)
    if n_b != N_B:
        raise ValueError(f"the boundary set holds {n_b} rows, not {N_B}")
    sync = (torch.cuda.synchronize if solver.device.type == "cuda" else lambda: None)
    times = []
    for _ in range(4):
        sync()
        t0 = time.perf_counter()
        m = solver.run_steps(steps, lr=1e-3)
        sync()
        times.append(time.perf_counter() - t0)
    if not math.isfinite(float(m.total)):
        raise FloatingPointError("the benchmark step diverged")
    dt = min(times[1:])
    return steps * (n_f + N_B) / dt, 1e3 * dt / steps, [1e3 * t / steps for t in times]


def device_busy(solver, steps, step_ms):
    """The card's busy time a step over one more chunk of at most
    PROFILED_STEPS of `steps` Adam steps under torch.profiler: the summed
    time of its kernels, copies and fills (the step runs on one stream, so
    they do not overlap); and its share of `step_ms`, the unprofiled step.
    Both None on the CPU, or where the trace holds no device time."""
    none = {"device_ms_per_step": None, "busy_share": None}
    if solver.device.type != "cuda":
        return none
    from torch.profiler import ProfilerActivity, profile

    steps = min(steps, PROFILED_STEPS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        solver.run_steps(steps, lr=1e-3)
        torch.cuda.synchronize()
    dev_us = lambda ev: getattr(ev, "self_device_time_total",
                                getattr(ev, "self_cuda_time_total", 0))
    # the device's rows only; a CPU op's row would count its kernels twice
    us = sum(dev_us(ev) for ev in prof.key_averages()
             if ev.device_type == torch.autograd.DeviceType.CUDA
             and not getattr(ev, "is_user_annotation", False))
    if us <= 0:
        return none
    ms = us / 1e3 / steps
    return {"device_ms_per_step": ms, "busy_share": ms / step_ms}


def _shares(pts, flop_pt, prec, on_card):
    """model TFLOP/s, and on a card its share of the bf16 peak (mfu) and
    that share times the name's passes."""
    model = pts * flop_pt
    return {"model_tflops_per_s": round(model / 1e12, 4),
            "mfu": model / H100_BF16_PEAK if on_card else None,
            "tensor_core_util_pct": (round(100 * model * PASSES[prec] / H100_BF16_PEAK, 2)
                                     if on_card else None)}


def _row(config, fn):
    """One row: fn() -> (solver, n_f, steps, extra); the launch counts of
    its run beside the points/s, or the error it raised."""
    before, timed = launch_counts(), None
    try:
        solver, n_f, steps, extra = fn()
        pts, step_ms, chunk_ms = measure(solver, n_f, steps)
        timed = launch_counts()  # the warm-up and timed chunks', not the profiled one's
        row = {"config": config, **extra(pts), "pts_per_s_per_chip": round(pts, 1),
               "step_ms": step_ms, "chunk_ms_per_step": chunk_ms,
               **device_busy(solver, steps, step_ms),
               "vs_baseline": round(pts / REFERENCE_PTS_PER_SEC, 2)}
    except Exception as e:  # noqa: BLE001 - record it, keep measuring
        row = {"config": config, "error": f"{type(e).__name__}: {str(e)[:300]}"}
    after = timed if timed is not None else launch_counts()
    row["launches"] = {k: after[k] - before[k] for k in after}
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return row


def run(n_f, steps, kan_n_f, kan_steps, device=None, on_row=None):
    """The matrix's rows at these sizes on `device` (None: the card);
    `on_row(row)` is called after each."""
    from nsfnet_tpu_torch.training.solver import resolve_device

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    flop_pt = model_flops_per_point()
    rows = []

    def add(row):
        rows.append(row)
        if on_row is not None:
            on_row(row)

    for prec in ("highest", "high", "default"):
        def mlp(prec=prec):
            solver = build(n_f, dev, matmul_precision=prec, engine="pallas")
            return solver, n_f, steps, lambda pts: {
                "fused_loss": solver._fused_loss_enabled(), **_shares(pts, flop_pt, prec, on_card)}

        add(_row(f"mlp/pallas {prec}", mlp))

    # the streamfunction formulation: the order-3 engines (13 streams); no
    # model-FLOP count (the JAX script has none); its kernel row on a card only
    no_share = lambda pts: {"model_tflops_per_s": None, "mfu": None,
                            "tensor_core_util_pct": None}
    sf_engines = [("xla", "sf/xla-closed-form")] + ([("pallas", "sf/pallas")] if on_card else [])
    for eng, label in sf_engines:
        add(_row(f"{label} high", lambda eng=eng: (
            build(n_f, dev, formulation="streamfunction", engine=eng,
                  matmul_precision="high"), n_f, steps, no_share)))

    # the KAN backbone: no kernel (its closed-form engine); a smaller N_f, its
    # activation footprint per point is much larger than the MLP's
    add(_row("kan/generic high", lambda: (
        build(kan_n_f, dev, backbone="kan", kan_width=(2, 16, 16, 8), kan_grid=5, kan_k=3,
              evm=False, layers_1=None, matmul_precision="high"), kan_n_f, kan_steps, no_share)))
    return rows


def write_table(rows, out=sys.stderr) -> None:
    print("| config | pts/s/card | vs P100 baseline | model TFLOP/s | MFU | tensor-core util "
          "| ms/step | card busy |", file=out)
    print("|---|---|---|---|---|---|---|---|", file=out)
    for r in rows:
        if "error" in r:
            print(f"| {r['config']} | ERROR: {r['error']} | | | | | | |", file=out)
            continue
        tf, mfu, tc = r["model_tflops_per_s"], r["mfu"], r["tensor_core_util_pct"]
        busy = r["busy_share"]
        print(f"| {r['config']} | {r['pts_per_s_per_chip']:,.0f} | {r['vs_baseline']:.1f}x | "
              f"{tf if tf is not None else '-'} | "
              f"{f'{100 * mfu:.2f}%' if mfu is not None else '-'} | "
              f"{f'{tc}%' if tc is not None else '-'} | {r['step_ms']:.3f} | "
              f"{f'{100 * busy:.1f}%' if busy is not None else '-'} |", file=out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Throughput matrix of the port: precision "
                                            "names x backbones, points/s on one card")
    p.add_argument("--quick", action="store_true", help="8,192 points, 20-step chunks")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (the plain versions)")
    p.add_argument("--out", default=DEFAULT_OUT, help="the JSON written")
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else None
    from nsfnet_tpu_torch.training.solver import resolve_device

    dev = resolve_device(device)
    n_f, steps, kan_n_f, kan_steps = matrix_sizes(dev.type == "cuda", args.quick)
    rows = run(n_f, steps, kan_n_f, kan_steps, dev,
               on_row=lambda r: print(json.dumps(r), flush=True))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"platform": dev.type, "device": card_label(dev), "n_f": n_f,
                   "steps": steps, "kan_n_f": kan_n_f, "kan_steps": kan_steps,
                   "rows": rows}, f, indent=1)
    write_table(rows)
    failed = [r["config"] for r in rows if "error" in r]
    if failed:
        print(f"perf_matrix: {len(failed)} row(s) failed: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
