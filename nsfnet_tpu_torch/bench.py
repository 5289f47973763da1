"""Headline benchmark of the port: collocation points/s on one card at Re=2000
(the counterpart of bench.py).

    python -m nsfnet_tpu_torch.bench [--cpu]

The flagship scenario is the reference's production-scale ev-NSFnet step:
main 6x80 + EVM 4x40, N_f = 120,000 collocation + 2,052 boundary points,
full-batch Adam with the EVM freeze gate and the vis_t carry, at "high"
(kernels 1+2 at three bf16 passes). A warm-up chunk of 1000 steps, then
the best of three timed chunks; real points only.

"Per chip" is per card this process uses, which is one: the bench runs one
process on one card (a multi-card step waits on NCCL, which this bench
does not measure). `--cpu` runs 8,192 points in 20-step chunks on the CPU
(the kernels' plain versions): a smoke run, not a measurement of the card.

On a card, before measuring, every live trainer registered under
`.run/*.pid` (the watchdog's registry, relative to the working directory)
is SIGTERMed and waited for, with `.run/pause` held until the bench ends so
the watchdog does not relaunch it; then the card is probed in a subprocess.
`--cpu` does neither. Without a card (and without `--cpu`), or when the
probe fails or hangs, the bench prints its line with value 0.0 and an
`error`, and exits 1.

Prints, before the last line, one JSON object: the launch counts of
kernels 1+2 over the warm-up and timed chunks, each chunk's ms per step
(the warm-up first), and the card's busy time a step and its share of the
best chunk's step (`device_ms_per_step`, `busy_share`: one more chunk of
at most 10 steps under torch.profiler, after the counts are read; null
on the CPU). As its last line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "mfu": x,
   "step_ms": t, "device": "<nvidia-smi name, power limit>" or "cpu"}
`mfu`: model FLOP/s (tools/perf_matrix.model_flops_per_point) over the
card's dense bf16 peak; null on the CPU.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import signal
import subprocess
import sys
import time

METRIC = "collocation_points_per_sec_per_chip_re2000"
UNIT = "points/s/chip"


def _device_healthy(timeout_s: float = 180.0) -> bool:
    """Probe the card in a subprocess with a hard timeout: a product of
    random operands, synchronised. A wedged card blocks inside the driver,
    so the probe is a separate process: the bench prints its line, never
    hangs."""
    code = ("import torch; "
            "g = torch.Generator(device='cuda').manual_seed(0); "
            "x = torch.randn(256, 256, device='cuda', generator=g); "
            "y = (x @ x).sum().item(); "
            "print('ok' if y == y else 'nan')")
    try:
        r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                           timeout=timeout_s)
        return r.returncode == 0 and r.stdout.strip().endswith("ok")
    except subprocess.TimeoutExpired:
        return False


def _alive(pid: int) -> bool:
    """A live process that is not a zombie (0 and below name groups)."""
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    # a SIGTERMed trainer is a zombie until its watchdog reaps it; it no
    # longer holds the card, so it is not waited for
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (OSError, IndexError):
        return True


def _pause_live_trainers(timeout_s: float = 240.0, run_dir: str = None):
    """Never measure while a trainer holds the card. The watchdog
    (tools/watchdog.py) registers its live trainer's PID under
    run_dir/<config>.pid and launches nothing while run_dir/pause exists:
    raise the flag, SIGTERM the registered trainers (each checkpoints and
    exits), wait for them, measure, then let the watchdog resume. Returns
    the cleanup callable that removes the flag."""
    if run_dir is None:
        run_dir = os.path.join(os.getcwd(), ".run")
    flag = os.path.join(run_dir, "pause")

    pids = []
    for pf in glob.glob(os.path.join(run_dir, "*.pid")):
        try:
            with open(pf) as f:
                pid = int(f.read().strip())
        except (ValueError, OSError):
            continue
        if _alive(pid):
            pids.append(pid)
    if not pids:
        return lambda: None
    os.makedirs(run_dir, exist_ok=True)
    open(flag, "w").close()
    for pid in pids:
        try:
            os.kill(pid, signal.SIGTERM)
        except OSError:
            pass
    print(f"bench: paused {len(pids)} live trainer(s) {pids}, waiting for their "
          f"checkpoint and exit", file=sys.stderr, flush=True)
    deadline = time.time() + timeout_s
    while time.time() < deadline and any(_alive(p) for p in pids):
        time.sleep(0.5)
    # a trainer that ignored SIGTERM is inside a hung dispatch; the device
    # probe catches a wedged card either way

    def _cleanup():
        try:
            os.remove(flag)
        except OSError:
            pass

    return _cleanup


def main(argv=None) -> int:
    """On a card: pause the live trainers and probe the card. Build and time
    the flagship step; print the launch line and the result line; let the
    trainers resume."""
    p = argparse.ArgumentParser(description="Points/s of the flagship step on one card")
    p.add_argument("--cpu", action="store_true", help="a smoke run on the CPU")
    args = p.parse_args(argv)
    # a CPU smoke run leaves a campaign on the card alone
    resume_trainers = (lambda: None) if args.cpu else _pause_live_trainers()
    try:
        if not (args.cpu or _device_healthy()):
            print(json.dumps({
                "metric": METRIC, "value": 0.0, "unit": UNIT, "vs_baseline": 0.0,
                "error": "accelerator unavailable (device probe hung/failed)",
            }))
            return 1
        from nsfnet_tpu_torch import ops
        from nsfnet_tpu_torch.tools import perf_matrix as pm
        from nsfnet_tpu_torch.training.solver import resolve_device

        dev = resolve_device("cpu" if args.cpu else None)
        on_card = dev.type == "cuda"
        n_f, steps = pm.matrix_sizes(on_card)[:2]
        solver = pm.build(n_f, dev, matmul_precision="high")
        ops.reset_launch_counts()
        pts, step_ms, chunk_ms = pm.measure(solver, n_f, steps)
        counts = ops.launch_counts()
        print(json.dumps({"launches": {k: counts[k] for k in ("fused_residual_fwd",
                                                              "fused_residual_bwd")},
                          "chunks": 4, "steps_per_chunk": steps,
                          "chunk_ms_per_step": chunk_ms,
                          **pm.device_busy(solver, steps, step_ms)}), flush=True)
        model = pts * pm.model_flops_per_point()
        print(json.dumps({
            "metric": METRIC,
            "value": round(pts, 1),
            "unit": UNIT,
            "vs_baseline": round(pts / pm.REFERENCE_PTS_PER_SEC, 2),
            "mfu": model / pm.H100_BF16_PEAK if on_card else None,
            "step_ms": step_ms,
            "device": pm.card_label(dev),
        }), flush=True)
        return 0
    finally:
        resume_trainers()


if __name__ == "__main__":
    sys.exit(main())
