#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nsfnet_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. the card: torch's name and nvidia-smi's name / power limit;
  2. build every CUDA kernel from nsfnet_tpu_torch/csrc with nvcc (one
     process per source, all at once), and show ptxas's registers / shared
     memory / spills;
  3. hold each kernel against its plain PyTorch version on the card at full
     width, and check that two runs are bitwise equal. Every kernel runs at
     each precision name against the plain version's bf16 passes at the
     same name, and at "high" also against the exact fp32 plain version:
     the fused residual-loss pair (kernels 1+2) at
     the flagship width (6x80 MLP, N_f = 120,000 SDF-weighted points, EVM
     on, Re = 2000); the five-stream engine (kernels 3+4) at that width and
     at the vanilla NSFnet width (4x120 MLP, N_f = 40,000), with random
     cotangents from a seeded generator; the order-3 streamfunction engine
     (kernels 5+6) at the streamfunction flagship width (6x80 MLP with a
     (psi, p) head, N = 120,000), at the small streamfunction net (4x40,
     N = 10,000) and at 4x120 (N = 40,000, the smaller tiles): the thirteen
     raw streams and the assembled (u, v, p) bundle, and the gradient from
     seeded random cotangents with the two unused streams zero and non-zero;
     3a'. kernels 1+2 at the h160 campaign width (6x160, the same 120,000
     points, Re = 4000, "high": tile 16, panel 160) against the plain passes
     and exact fp32, bitwise across runs, timed;
     3a''. the same at the reference v1 recipe's shape (4x120, no EVM,
     N_f = 40,000, "high");
     3d. the streamed plan, which the kernels take where no resident plan
     fits shared memory (the carries in a block-private global scratch,
     K-panels of them through shared memory): each kernel at each name at
     the first such width and at 1024 (3 hidden layers, 4,096 points)
     against its plain version at the bars above; the streamed plan at a
     resident plan's tile, bitwise equal to it; kernels 1+2 at 6x352 (N =
     120,000), 3+4 at 4x352 (N = 40,000) and 5+6 at 6x224 (N = 120,000) at
     "high", checked and timed, and kernels 1+2 at the resident 6x224 and
     6x288, timed;
  4. the paths, each through ConfigManager.from_dict -> build_solver on cuda
     -> train(), with the launch counts set to 0 just before and read just
     after (beside them, the weight ring's counters of kernels 1-4: the
     K-slots of hidden weights staged and those prefetched, here and in
     4f (i) at 6x160):
       4a. the flagship ev-NSFnet config, 30 Adam steps with the EVM gate
           firing, through kernels 1+2; then (4b) cuda against the CPU from
           one seed on a small input;
       4c. the reference v1 config (vanilla NSFnet, loss_mode L2), 30 Adam
           steps through kernels 3+4 at its "high"; then cuda against the CPU
           on a small input;
       4d. the flagship batch and weights with the fused loss off (kernels
           3+4 -> residuals -> masked sums) against the fused loss (kernels
           1+2): the step's metrics and the main-net gradient;
       4e. the streamfunction ev-NSFnet config (configs/re2000_sf_ev.yaml at
           its published widths, its stages cut to one), 30 Adam steps
           through kernels 5+6 at its "high" with eq3 == 0 exactly and a
           divergence-free
           predicted field; then the kernel engine against the closed-form
           engine on the same batch and weights, and cuda against the CPU
           on a small input;
     metrics must be finite, the loss must fall, and each path must have
     launched its kernels once per step and the other pairs not at all;
       4f. the campaign path through the driver's main(), every checkpoint in
           a temporary directory: (i) --resume the committed JAX checkpoint
           artifacts/live_re4000_r4b/latest.ckpt (step 1,240,000, mid-R2) on
           configs/re4000_r4b.yaml with R2 ending 40 steps later and R3 cut
           to 40: the mid-stage entry, R3's redraw, a finite loss, kernels
           1+2 once per step and 3-6 never; checkpoint write and JAX read
           times; (ii) a real SIGTERM to the driver in a child process after
           its step-20 checkpoint (exit 3), then --resume, bitwise equal to
           the uninterrupted run; (iii) --init-from
           artifacts/re4000_gentle/final_state.ckpt on
           configs/re4000_ev_polish_h160.yaml cut to P1 and P2 at 20 steps:
           the widened h160 net within 1e-6 of the h80 donor on a 101x101
           grid, P2's residual-aware redraw (480,000 scored, 60,000 kept,
           timed), and a resume from P2's checkpoint that replays its points
           bitwise without scoring and ends bitwise where the run ended;
       4g. the polish phase through the driver's main(): (i)
           configs/re2000_nsfnet.yaml at its published widths (4x120, N_f =
           40,000, bc_weight 10, MSE, "high"), its five Adam stages cut to 30
           steps (kernels 1+2 once per step, 3-6 never) and its L-BFGS stage
           to 50: the loss falls, evaluations and ms per L-BFGS step; (ii)
           configs/re2000_ev_h288.yaml --init-from
           artifacts/best_re2000_h288.ckpt, its LM stage (3 slices, cg 50) at
           6x288 and N_f = 120,000 cut to 3 steps: the loaded net's equation
           loss, a non-increasing history, seconds per step, peak memory, no
           kernel launched; (iii) on small inputs, L-BFGS cuda against the CPU,
           LM over 3 slices against the full batch from the h288 checkpoint,
           and an Adam run with supervision and the adaptive bc weight cuda
           against the CPU;
      4h. the other backbones, no kernel launched in any run: (i)
          configs/kan_cavity.yaml unedited through the driver's main() (200
          L-BFGS steps of the notebook's KAN at N_f 10,000): a falling loss,
          evaluations and ms per step; (ii) the committed KAN state
          artifacts/kan_cavity/final_state.ckpt, its loss on cuda against
          the CPU, then 20 L-BFGS steps; (iii) the KAN [2,16,16,8] at the
          flagship batch, timed Adam steps; (iv) the flagship ev-NSFnet with
          16 Fourier features, 30 Adam steps on the generic engine and cuda
          against the CPU; (v) the generic engines against the closed forms
          at full width; (vi) LM on both backbones at N_f 10,000 (the KAN
          from the committed state, the Fourier net from its seed), then the
          Gauss-Newton products (residual, J v, J^T r) cuda against the CPU
          on a small input;
      4i. microbatching and data parallelism on configs/re2000_ev.yaml
          (its stages cut to one of 20 steps, evm_update_freq 10): (i)
          microbatches 4 against 1 from one initialisation (kernels 1+2 4x
          per step on 30,000 rows, 3-6 never; the first gradient per tensor,
          the metrics after 20 steps, the peak memory of each); (ii) N_f
          1,200,000 over 10 microbatches, 3 steps; (iii) the driver's main()
          under `python -m torch.distributed.run --standalone
          --nproc_per_node=1` (NCCL, world 1, a checkpoint, kernels 1+2
          launched); (iv) two ranks on the one card (gloo, named: NCCL takes
          one rank per card) for 10 steps on (i)'s weights: bitwise equal
          ranks, against one process, each rank's launches on 60,000 rows,
          rank 0's gathered carry reloaded by both and 2 more steps;
      4j. the tools: (i) train.main --resume artifacts/re4000_live/latest.ckpt
          (a JAX native-sampler state, 6x160, R1 at step 100,000) on
          configs/re4000_r4b.yaml with R1 ending 40 steps later and R2 cut
          to 40: draw 0 replayed on the port's native sampler (its sha256),
          R2's native redraw, a `native: true` final state, kernels 1+2 once
          per step and 3-6 never; the library's build time and the native
          and numpy draws' times at N_f 120,000; (ii) test.py over (i)'s
          checkpoint and artifacts/live_re4000_r4b/latest.ckpt (msgpack)
          against a synthetic DNS field, on the card and with --cpu; (iii)
          the exported predict and residual heads of (i)'s state, loaded on
          cuda and on the CPU, against the solver on 120,000 points, and
          timed; (iv) save_torch / load_torch of the flagship nets; (v)
          --profile over a 20-step flagship stage (the trace names kernels
          1+2); (vi) a 6x289 "high" net, which no resident plan of
          kernels 1-4 fits, 3 Adam steps through kernels 1+2 on the
          streamed plan, and 6x288 on the resident plan; (vii) the watchdog
          under torchrun at world 1, stopped by WATCHDOG_DEADLINE_TS after
          its first checkpoints, then resumed to the end of the stage;
      4k. the capacity ladder's next rung, this slice's path:
          configs/re2000_ev_h288.yaml at hidden_size 352 with one Adam stage
          of 30 steps at lr 1e-6 (N_f 120,000, "high"), built in memory,
          through train.main --init-from artifacts/best_re2000_h288.ckpt
          (the Net2Net widening 288 -> 352, then kernels 1+2 on the
          streamed plan): first, on one batch, the widened net's equation
          loss through kernel 1 against the h288 donor's on the resident
          plan, beside the exact fp32 plain version's own distance; then
          the run twice: 30 + 30 launches of kernels 1+2 and none of 3-6, a
          finite loss at every step, the two runs bitwise equal, ms per step;
      4l. the measurement entry points, this slice's path: (ii)
          tools.perf_matrix.run in process at N_f 120,000 with 100-step
          chunks (the KAN 16,384 and 20): every row without error, kernels
          1+2 launched on the three mlp/pallas rows only, 5+6 on sf/pallas
          only, each row's card busy share (a profiled chunk) in (0, 1.05];
          (i) + (iii) `python -m nsfnet_tpu_torch.bench` as a
          subprocess while tools.watchdog trains the flagship config cut to
          one 2000-step stage: the bench SIGTERMs the registered trainer,
          which checkpoints and exits, holds .run/pause while it measures
          and removes it; its last line (points/s/card, a finite mfu, the
          card's name and power limit) over 4,000 + 4,000 launches of
          kernels 1+2, with the card's busy share; the watchdog relaunches
          after the bench only, resumes from the trainer's checkpoint and
          ends the stage;
  5. times: each kernel, its plain version and its bound (every kernel at
     each precision name, bound at that name's bf16 pass count beside the
     fp32 bound; the tape and partial bytes of kernels 2 and 6 per launch;
     the streamed plan's shapes of 3d; the `kernels` line carries kernels
     1+2 at the bench's shape with its launches, 3+4 at the v1 path, 5+6 at
     the streamfunction path with the matrix's sf/pallas launches),
     and the step time and collocation points/s of the
     three paths and of the 6x160 campaign step, beside the card's name and
     power limit; the profiler's table for each path's step.
Prints a `kernels` JSON line, then, last, the device JSON line. Also writes
everything to chiprun_out/chip_smoke.json.
"""

import base64
import contextlib
import glob
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

FP32_PEAK = 67e12      # H100 SXM, fp32 outside the tensor cores (FLOP/s)
TF32_PEAK = 495e12     # dense tensor-core rates
BF16_PEAK = 989e12
HBM_RATE = 3.35e12     # bytes/s

RE = 2000.0
RE_CAMPAIGN = 4000.0   # configs/re4000_r4b.yaml, configs/re4000_ev_polish_h160.yaml
N_F = 120_000
N_F_V1 = 40_000
N_B = 4 * 513          # boundary points of the cavity data
SLICE_STEPS = 30
TIMED_STEPS = 50
FWD_TOL = 1e-4   # max relative difference of each loss sum / max|diff|/max|plain| per stream
BWD_TOL = 1e-4   # max |diff| / max |plain| of each gradient tensor and of g_e
# kernels 4 and 6 at "default" against the plain version's one pass: rounding-
# edge cascades under random cotangents (PERF.md, section 6)
DEFAULT_BWD_TOL = 1e-3
# kernels 3 and 5: at "default" per stream norm-wise against the plain
# version's one pass, and at "high" their separation from exact fp32, take
# the bars of nsfnet_tpu_torch/ops/pass_checks.py (PERF.md, section 6)
SMALL_TOL = 1e-3  # cuda vs CPU solver on a small input, per logged metric
UNFUSED_TOL = 1e-4  # unfused (kernels 3+4) vs fused (kernels 1+2): metrics, gradient tensors
ENGINE_TOL = 1e-4   # streamfunction step, kernel engine vs closed form: metrics, gradient tensors
# the streamfunction's MSE step on `pallas`: kernel 5, the glue pair, kernel 6
PSI_LOSS_KERNELS = ("psi_streams_fwd", "psi_streams_bwd", "psi_residual_fwd", "psi_residual_bwd")
DIV_TOL = 1e-5      # |u_x + v_y| of the streamfunction field on a grid
LM_SLICE_NF = 8192  # the LM slicing check: the h288 checkpoint on fewer points
LM_PARAM_TOL = 1e-5  # LM over 3 slices vs the full batch: max|diff| / max|w| of the params
# ... and of the loss history: at a converged state each residual is a small
# difference of O(1) terms, so the same loss summed in another slice layout
# moves in fp32 (~5e-5 on the CPU at N_f 2,000); the smoke reads that move on
# the card, the loaded state's loss in both layouts, and prints it beside
# this bar (PERF.md, section 6)
LM_HIST_TOL = 1e-4
WIDEN_TOL = 1e-6    # widened net against its donor (Net2Net: exact zeros out of new units)
KAN_LOAD_TOL = 1e-5  # the committed KAN state's loss, cuda vs CPU (relative)
GENERIC_TOL = 1e-5      # generic jvp engine vs closed form, order 2: max|diff|/max|ref| per stream
GENERIC_PSI_TOL = 1e-4  # order 3, the bar kernels 5+6 are held to against the closed form
N_SF_SMALL = 10_000  # N_f of configs/re100_streamfunction.yaml
LM_BACKBONE_NF = 10_000  # LM on the KAN and the Fourier net: kan_cavity's N_f
LM_BACKBONE_STEPS = 2
PAR_STEPS = 20           # phase 4i (i): Adam steps at microbatches 4 and 1
PAR_TIMED = 20           # ... then timed steps in one chunk
PAR_BIG_STEPS = 3        # (ii): N_f 1,200,000 over 10 microbatches
PAR_DP_STEPS = 10        # (iv): two ranks on the one card
PAR_GRAD_TOL = 1e-5      # (i): first gradient per tensor, 4 slices vs 1 (summation order only)
PAR_METRIC_TOL = 1e-3    # (i): metrics after PAR_STEPS steps
PAR_DP_METRIC_TOL = 1e-4  # (iv): 2 ranks vs 1 process, every logged metric
PAR_DP_PARAM_TOL = 1e-3   # ... and the params, max|diff| / max|p|
R4B_CONFIG = "configs/re4000_r4b.yaml"
LIVE_NATIVE = "artifacts/re4000_live/latest.ckpt"   # native sampler state, 6x160, R1 step 100,000
LIVE_R4B = "artifacts/live_re4000_r4b/latest.ckpt"   # 6x160, msgpack, R2 step 1,240,000
TOOLS_SWEEP_TOL = 1e-5   # 4j (ii): the sweep's error scalars, cuda vs CPU (relative)
TOOLS_EXPORT_TOL = 1e-5  # 4j (iii): exported heads vs the solver, max|diff| / max|ref|
# 4j (iii): the CPU solver against the cuda one on the same state, max|diff| /
# max|ref| per head: fp32 summed in two orders; the residual of the
# re4000_live state read 1.13e-5 on the H100 (PERF.md)
TOOLS_XDEV_TOL = 5e-5
WD_DEADLINE_S = 45       # 4j (vii): the first watchdog call's deadline after its start
# The first width at each name whose block no resident plan fits (the tile
# rules ops/fused_residual.pick_loss_tile, ops/psi_streams.pick_bwd_tile):
# from there the kernels take the streamed plan; phase 3d checks each kernel
# there and at WIDEST
FIRST_STREAMED = {"velocity": {"default": 561, "high": 289, "highest": 193},
                  "streamfunction": {"default": 433, "high": 209, "highest": 145}}
WIDEST = 1024
N_WIDE = 4096            # 3d: points of the checks at those widths (3 hidden layers)
RUNG_H = 352             # 4k: the capacity ladder's next rung from the h288 state
RUNG_STEPS = 30
RUNG_LR = 1e-6           # the rung's polish regime (configs/re2000_ev_h288.yaml)
MATRIX_STEPS = 100       # 4l (ii): steps a chunk of the matrix's rows at N_F
MATRIX_KAN_NF = 16_384   # ... the KAN row's points (the matrix's own size on a card)
MATRIX_KAN_STEPS = 20    # ... and steps a chunk
BENCH_STEPS = 1000       # 4l (i): the bench's chunk on a card (a warm-up, then three)
DRILL_STEPS = 2000       # 4l (iii): the watchdog trainer's one stage
DRILL_TIMEOUT_S = 300    # ... the watchdog's deadline, a bound on the drill

FLAGSHIP = {
    "experiment_name": "chip_smoke_re2000_ev",
    "model_variant": "ev-nsfnet",
    "physics": {"Re": RE, "alpha_evm": 0.05, "bc_weight": 10, "eq_weight": 1},
    "network": {"layers": 6, "layers_1": 4, "hidden_size": 80, "hidden_size_1": 40},
    "training": {
        "N_f": N_F, "log_interval": 10, "sort_training_points": False,
        "sdf_weighting": {"enabled": True, "min_weight": 0.2, "decay": 5.0},
        "matmul_precision": "high", "evm_update_freq": 10, "seed": 0,
        "checkpoint_freq": 10**9, "enable_tensorboard": False,
        "training_stages": [{"alpha": 0.05, "epochs": SLICE_STEPS, "lr": 1e-3,
                             "name": "smoke"}],
    },
}

# The reference v1's own setting (configs/re2000_nsfnet.yaml, NSFnet/train.py:23-77)
# with its un-normalised L2-norm loss.
V1 = {
    "experiment_name": "chip_smoke_re2000_nsfnet_l2",
    "model_variant": "nsfnet",
    "physics": {"Re": RE, "bc_weight": 10, "eq_weight": 1},
    "network": {"layers": 4, "hidden_size": 120},
    "training": {
        "N_f": N_F_V1, "log_interval": 10, "loss_mode": "L2", "seed": 0,
        "checkpoint_freq": 10**9, "enable_tensorboard": False,
        "training_stages": [{"alpha": 0.0, "epochs": SLICE_STEPS, "lr": 1e-3,
                             "name": "smoke"}],
    },
}


# configs/re2000_sf_ev.yaml: its physics, network and training settings at
# their published values; the six 250,000-epoch stall-aware stages are cut to
# the first one at 30 steps, and the EVM gate fires within them.
STREAMFUNCTION = {
    "experiment_name": "chip_smoke_re2000_sf_ev",
    "model_variant": "ev-nsfnet",
    "physics": {"Re": RE, "alpha_evm": 0.05, "bc_weight": 10, "eq_weight": 1},
    "network": {"layers": 6, "layers_1": 4, "hidden_size": 80, "hidden_size_1": 40,
                "formulation": "streamfunction"},
    "training": {
        "N_f": N_F, "log_interval": 10, "sort_training_points": False,
        "sdf_weighting": {"enabled": True, "min_weight": 0.2, "decay": 5.0},
        "stall_threshold": 0.02, "stall_window": 3,
        "evm_update_freq": 10, "seed": 0,
        "checkpoint_freq": 10**9, "enable_tensorboard": False,
        "training_stages": [{"alpha": 0.05, "epochs": SLICE_STEPS, "lr": 1e-3, "name": "S1",
                             "advance_on_stall": True, "stall_min_epochs": 60000}],
    },
}


def cuda_ms(torch, fn, iters, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_steps(torch, run, card, what, n_steps=5):
    """Device time by kernel over `run()`, n_steps steps (torch.profiler),
    and the share of the window's wall time the device was busy."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    dev_us = lambda ev: getattr(ev, "self_device_time_total",
                                getattr(ev, "self_cuda_time_total", 0))
    # kernel rows only (device type CUDA), as torch's own table totals them;
    # the CPU-side op rows would count the same device time twice
    rows = sorted(((ev.key, dev_us(ev) / 1e3 / n_steps) for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(ev, "is_user_annotation", False) and dev_us(ev) > 0),
                  key=lambda r: -r[1])
    busy = sum(ms for _, ms in rows)
    if not rows:
        print(f"profile {what}: no device time in the trace (not measured)")
        return None
    # every launch of kernels 1-6 splits the hidden weights first (split_weights)
    split = [ev for ev in prof.key_averages() if "split_weights" in ev.key
             and ev.device_type == torch.autograd.DeviceType.CUDA]
    split_ms = sum(dev_us(ev) for ev in split) / 1e3 / n_steps
    split_n = sum(ev.count for ev in split) / n_steps
    print(f"profile {what} ({n_steps} steps, under the profiler): "
          f"{wall_ms / n_steps:.3f} ms/step wall, device busy {busy:.3f} ms/step "
          f"({100 * busy * n_steps / wall_ms:.1f}%) — {card}")
    for name, ms in rows[:10]:
        print(f"  {ms:9.4f} ms/step  {name[:90]}")
    print(f"  split_weights: {split_n:g} launches/step, {1e3 * split_ms:.2f} us/step")
    return {"wall_ms_per_step": wall_ms / n_steps, "busy_ms_per_step": busy,
            "split_weights_per_step": split_n, "split_weights_ms_per_step": split_ms,
            "top": rows[:20]}


def rel_sums(a, b):
    return max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))


def write_config(root, src, name, stages, top=None, **training):
    """The config file `src` (a path, or a dict in the config's layout) with
    its stages replaced, `training` settings updated, checkpoints under
    root/name, written to root/name.yaml. eval_data stays unless `top`
    replaces it: its DNS file is not in the repository, and train.py skips
    the evaluation with a warning."""
    from nsfnet_tpu_torch.config import ConfigManager

    raw = (ConfigManager.from_file(src).to_dict() if isinstance(src, str)
           else json.loads(json.dumps(src)))
    raw.update(top or {})
    raw["training"].update(checkpoint_dir=os.path.join(root, name), **training)
    raw["training"]["training_stages"] = stages
    path = os.path.join(root, f"{name}.yaml")
    with open(path, "w") as f:
        json.dump(raw, f)  # YAML reads JSON
    return path


def train_spy(train, seen):
    """PINNSolver.train recording, at each call, the solver, its stage, the
    mid-stage entry and the collocation points it trains on."""
    def spy(self, *a, **kw):
        resume = kw.get("resume_in_stage", False)
        x_f, y_f = self.eq_points()
        seen.append({"solver": self, "stage": self.current_stage, "resume": resume,
                     "entry": self.state.epoch_in_stage if resume else 0,
                     "global_step": self.global_step, "x_f": x_f.copy(), "y_f": y_f.copy()})
        return train(self, *a, **kw)

    return spy


def rel_max(a, b):
    """max|a - b| / max|b| of two tensors."""
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def worst_per_param(unflatten, got, ref, sizes):
    """(the worst rel_max over the (W, b) tensors of two flat gradients, the
    name of that tensor: W<i> / b<i>, layer i from 0)."""
    return max((rel_max(a, r), f"{'Wb'[j]}{i}")
               for i, (pa, pr) in enumerate(zip(unflatten(got, sizes), unflatten(ref, sizes)))
               for j, (a, r) in enumerate(zip(pa, pr)))


def rel_per_param(unflatten, got, ref, sizes):
    """The worst rel_max over the (W, b) tensors of two flat gradients."""
    return worst_per_param(unflatten, got, ref, sizes)[0]


@contextlib.contextmanager
def env_var(name, value):
    """The environment variable `name` set to `value` (None: unset) while a
    solver is built; restored afterwards."""
    old = os.environ.pop(name, None)
    if value is not None:
        os.environ[name] = value
    try:
        yield
    finally:
        os.environ.pop(name, None)
        if old is not None:
            os.environ[name] = old


def phase_tools(torch, np, ctx):
    """4j. the tools on the card: (i) train.main --resume of the native-
    sampler JAX checkpoint; (ii) the checkpoint sweep on cuda against --cpu;
    (iii) the exported predict and residual heads on cuda and on the CPU;
    (iv) .pth save and load; (v) --profile; (vi) 6x289 on the streamed
    plan and 6x288 on the resident one; (vii) the watchdog under torchrun.
    Returns {name: ok} and its record."""
    import hashlib

    import scipy.io

    from nsfnet_tpu_torch import test as sweep_mod
    from nsfnet_tpu_torch import train as train_mod
    from nsfnet_tpu_torch.config import ConfigManager
    from nsfnet_tpu_torch.data import native
    from nsfnet_tpu_torch.data.cavity import CavityData
    from nsfnet_tpu_torch.ops import fused_residual as fr
    from nsfnet_tpu_torch.tools import watchdog
    from nsfnet_tpu_torch.training import checkpoint as ckpt_mod
    from nsfnet_tpu_torch.training.solver import PINNSolver
    from nsfnet_tpu_torch.utils import export as export_mod

    card, reset, read, ready_solver = (ctx["card"], ctx["reset_counts"], ctx["read_counts"],
                                       ctx["ready_solver"])
    t_phase = time.time()
    tdir = tempfile.mkdtemp(prefix="chip_smoke_tools_")
    rec, ok = {}, {}
    seen = []
    orig_train = PINNSolver.train
    PINNSolver.train = train_spy(orig_train, seen)

    def newest(name, pattern="*.ckpt"):
        found = glob.glob(os.path.join(tdir, name, "**", pattern), recursive=True)
        return max(found, key=os.path.getmtime) if found else None

    def flagship(name, epochs, **training):
        stages = [{**FLAGSHIP["training"]["training_stages"][0], "epochs": epochs}]
        return write_config(tdir, FLAGSHIP, name, stages, **training)

    def finite(s):
        return bool(s.loss_history) and all(math.isfinite(v) for _, m in s.loss_history
                                            for v in m)

    try:
        # (i) --resume the native-sampler JAX checkpoint (6x160, R1 at step
        # 100,000) on re4000_r4b: R1 ends 40 steps later, R2 (a native
        # redraw) is cut to 40
        built_here = not native.library_path().exists()
        t0 = time.perf_counter()
        native.build()
        build_s = time.perf_counter() - t0
        stages = ConfigManager.from_file(R4B_CONFIG).to_dict()["training"]["training_stages"][:2]
        stages[0]["epochs"], stages[1]["epochs"] = 100_040, 40
        path = write_config(tdir, R4B_CONFIG, "native", stages)
        cfg = ConfigManager.from_file(path).config
        reset()
        t0 = time.time()
        rc = train_mod.main(["--config", path, "--resume", LIVE_NATIVE])
        torch.cuda.synchronize()
        seconds = time.time() - t0
        launches = read()
        meta = ckpt_mod.load_metadata(newest("native", "model_final.ckpt")) or {}
        solver_n = seen[-1]["solver"]
        entries = [(e["stage"], e["resume"], e["entry"], e["global_step"]) for e in seen]
        # the two draws on their own: the state replayed, then the next draw
        d = train_mod.build_data(cfg)
        d.boundary_data()
        d.set_state(ckpt_mod.load_metadata(LIVE_NATIVE)["sampler"])
        x0, y0 = d.training_data()
        x1, y1 = d.training_data()
        replayed = (len(seen) == 2 and np.array_equal(seen[0]["x_f"], x0)
                    and np.array_equal(seen[0]["y_f"], y0))
        redrawn = (len(seen) == 2 and np.array_equal(seen[1]["x_f"], x1)
                   and np.array_equal(seen[1]["y_f"], y1))
        sha = hashlib.sha256(x0.tobytes() + y0.tobytes()).hexdigest()
        draw_s = {}
        for sort in (False, True):
            for use_native in (True, False):
                dd = CavityData(**{**train_mod.data_kwargs(cfg), "sort_training_points": sort},
                                use_native=use_native)
                dd.boundary_data()
                t0 = time.perf_counter()
                dd.training_data()
                draw_s[f"{'native' if use_native else 'numpy'}{'/sorted' if sort else ''}"] = \
                    time.perf_counter() - t0
        sampler = meta.get("sampler", {})
        ok["i"] = (rc == 0 and finite(solver_n) and d.use_native and replayed and redrawn
                   and entries == [("R1", True, 100_000, 100_000), ("R2", False, 0, 100_040)]
                   and meta.get("global_step") == 100_080 and meta.get("stage") == "R2"
                   and sampler.get("native") is True and sampler.get("draws_next") == 1
                   and launches == {**dict.fromkeys(launches, 0), "fused_residual_fwd": 80,
                                    "fused_residual_bwd": 80})
        print(f"tools (i) --resume {LIVE_NATIVE} (native sampler state) through train.main: "
              f"exit {rc} in {seconds:.1f} s; stage entries {entries}; draw 0 replayed on the "
              f"native path {replayed}, sha256 {sha}; R2's native redraw {redrawn}; final step "
              f"{meta.get('global_step')} stage {meta.get('stage')} sampler native "
              f"{sampler.get('native')} draws_next {sampler.get('draws_next')}; launches "
              f"{launches}; ok {ok['i']}")
        for st, m in solver_n.loss_history:
            print(f"  step {st}: " + " ".join(f"{k}={v:.4e}" for k, v in m._asdict().items()))
        print(f"  native library build (g++ -O3 -march=native) {build_s:.2f} s "
              f"({'built here' if built_here else 'found built'}); one "
              f"draw at N_f 120,000: " + ", ".join(f"{k} {v:.4f} s" for k, v in draw_s.items())
              + f" — {card}")
        rec["native_resume"] = {"rc": rc, "seconds": seconds, "entries": entries,
                                "sha256": sha, "launches": launches, "final_meta": meta,
                                "build_s": build_s, "draw_s": draw_s, "ok": ok["i"],
                                "history": [(st, m._asdict()) for st, m in solver_n.loss_history]}

        # (ii) the sweep of (i)'s checkpoint and of the JAX package's msgpack
        # checkpoint against a synthetic DNS field, on the card and with --cpu
        g = np.linspace(0.0, 1.0, 101)
        X, Y = np.meshgrid(g, g)
        P = np.cos(np.pi * X) * np.sin(np.pi * Y)
        P[0, 0] = np.nan
        mat = os.path.join(tdir, "dns.mat")
        scipy.io.savemat(mat, {"X_ref": X, "Y_ref": Y, "U_ref": np.sin(np.pi * X) * Y,
                               "V_ref": -np.sin(np.pi * Y) * X, "P_ref": P})
        sweep_cfg = write_config(tdir, R4B_CONFIG, "sweep", stages, top={"eval_data": mat})
        ck_dir = os.path.join(tdir, "sweep_ckpts")
        os.makedirs(ck_dir)
        for src, name in ((newest("native", "model_final.ckpt"), "port"), (LIVE_R4B, "jax")):
            for ext in ("", ".json"):
                shutil.copy(src + ext, os.path.join(ck_dir, name + ".ckpt" + ext))
        sweeps, sweep_s = {}, {}
        reset()
        for where in ("cuda", "cpu"):
            out_dir = os.path.join(tdir, f"sweep_{where}")
            t0 = time.time()
            rc_s = sweep_mod.main(["--config", sweep_cfg, "--checkpoints",
                                   os.path.join(ck_dir, "*.ckpt"), "--out", out_dir]
                                  + (["--cpu"] if where == "cpu" else []))
            sweep_s[where] = time.time() - t0
            sweeps[where] = (rc_s, {f: scipy.io.loadmat(os.path.join(out_dir, f))
                                    for f in sorted(os.listdir(out_dir))})
        launches_sw = read()
        files = sorted(sweeps["cuda"][1])
        scal = ("error_u", "error_v", "error_p", "error_p_gauge")
        scalar = lambda where, f, k: np.asarray(sweeps[where][1][f][k]).item()
        err_rel = max(abs(scalar("cuda", f, k) - scalar("cpu", f, k))
                      / max(abs(scalar("cpu", f, k)), 1e-30) for f in files for k in scal)
        field_abs = max(float(np.abs(sweeps["cuda"][1][f][k] - sweeps["cpu"][1][f][k]).max())
                        for f in files for k in ("U_pred", "V_pred", "P_pred", "E_pred"))
        ok["ii"] = (sweeps["cuda"][0] == sweeps["cpu"][0] == 0 and err_rel <= TOOLS_SWEEP_TOL
                    and files == ["cavity_result_loop_100080.mat",
                                  "cavity_result_loop_1240000.mat"]
                    and files == sorted(sweeps["cpu"][1]) and not any(launches_sw.values()))
        errs = {f: {k: scalar("cuda", f, k) for k in scal} for f in files}
        print(f"tools (ii) test.py over (i)'s checkpoint and {LIVE_R4B} (msgpack) against a "
              f"synthetic 101x101 field: exit {sweeps['cuda'][0]} on cuda ({sweep_s['cuda']:.1f} s),"
              f" {sweeps['cpu'][0]} with --cpu ({sweep_s['cpu']:.1f} s); files {files}; errors "
              f"(cuda) {errs}; cuda vs CPU: error scalars max rel diff {err_rel:.3e} (tolerance "
              f"{TOOLS_SWEEP_TOL:g}), fields max |diff| {field_abs:.3e}; ok {ok['ii']}")
        rec["sweep"] = {"errors": errs, "err_rel": err_rel, "field_abs": field_abs,
                        "seconds": sweep_s, "ok": ok["ii"]}

        # (iii) the exported heads of (i)'s state, loaded on cuda and on the CPU,
        # against the solver on the replayed 120,000 points
        pe, pr = os.path.join(tdir, "predict.pt2"), os.path.join(tdir, "qc.pt2")
        t0 = time.time()
        export_mod.export_predict(solver_n, pe)
        export_mod.export_residuals(solver_n, pr)
        export_s = time.time() - t0
        pts = np.concatenate([x0, y0], axis=1)
        # the reference on each device: the solver itself, and the same
        # state in a CPU solver (a residual of this converged state is a
        # small difference of O(1) terms: fp32 on two devices parts by ~1e-5
        # of its max, gated at TOOLS_XDEV_TOL)
        solver_cpu = train_mod.build_solver(cfg, device="cpu")
        solver_cpu.set_params(tuple((w.cpu(), b.cpu()) for w, b in solver_n.params()),
                              tuple((w.cpu(), b.cpu()) for w, b in solver_n.params_evm()))
        solver_cpu.current_re, solver_cpu.alpha_evm = solver_n.current_re, solver_n.alpha_evm
        refs = {s.device.type: (torch.cat(s.predict((x0, y0)), dim=1).cpu(),
                                torch.from_numpy(s.residuals_at(x0, y0)))
                for s in (solver_n, solver_cpu)}
        exp_err = {}
        for where in ("cuda", "cpu"):
            got_p = export_mod.load_predict(pe, device=where)(pts).cpu()
            got_r = export_mod.load_predict(pr, device=where)(pts).cpu()
            ref_p, ref_r = refs[where]
            exp_err[where] = {"predict": rel_max(got_p, ref_p), "residuals": rel_max(got_r, ref_r),
                              "shapes": [list(got_p.shape), list(got_r.shape)]}
        cross = {"predict": rel_max(refs["cpu"][0], refs["cuda"][0]),
                 "residuals": rel_max(refs["cpu"][1], refs["cuda"][1])}
        del solver_cpu
        served = export_mod.load_predict(pe, device="cuda")
        pts_dev = torch.from_numpy(pts).to(ctx["dev"])
        ms_served_host = cuda_ms(torch, lambda: served(pts), 10)
        ms_served_dev = cuda_ms(torch, lambda: served(pts_dev), 10)
        ms_solver = cuda_ms(torch, lambda: solver_n.predict((x0, y0)), 10)
        ok["iii"] = (all(v["predict"] <= TOOLS_EXPORT_TOL and v["residuals"] <= TOOLS_EXPORT_TOL
                         and v["shapes"] == [[120_000, 4], [120_000]] for v in exp_err.values())
                     and all(v <= TOOLS_XDEV_TOL for v in cross.values()))
        print(f"tools (iii) export of (i)'s 6x160 state on the card ({export_s:.1f} s for both "
              f"heads): on 120,000 points, max|diff|/max|ref| against solver.predict / "
              f"solver.residuals_at on the device it was loaded on: {exp_err} (tolerance "
              f"{TOOLS_EXPORT_TOL:g}); the CPU solver against the cuda one: {cross} "
              f"(tolerance {TOOLS_XDEV_TOL:g}); predict "
              f"through the exported program {ms_served_host:.3f} ms from host arrays, "
              f"{ms_served_dev:.3f} ms from a device tensor, solver.predict {ms_solver:.3f} ms "
              f"— {card}; ok {ok['iii']}")
        rec["export"] = {"err": exp_err, "cross_device": cross, "export_s": export_s, "served_host_ms": ms_served_host,
                         "served_dev_ms": ms_served_dev, "solver_ms": ms_solver, "ok": ok["iii"]}
        del served, pts_dev
        torch.cuda.empty_cache()

        # (iv) .pth: the flagship nets written and read back on the card
        fcfg = ConfigManager.from_dict(FLAGSHIP).config
        other = json.loads(json.dumps(FLAGSHIP))
        other["training"]["seed"] = 1
        a, _ = ready_solver(fcfg)
        b, _ = ready_solver(ConfigManager.from_dict(other).config)
        differed = not torch.equal(a.state.params, b.state.params)
        a.save_torch(os.path.join(tdir, "flagship.pth"))
        b.load_torch(os.path.join(tdir, "flagship.pth"))
        ok["iv"] = (differed and torch.equal(a.state.params, b.state.params)
                    and torch.equal(a.state.params_evm, b.state.params_evm)
                    and b.state.params.device.type == "cuda")
        print(f"tools (iv) save_torch / load_torch of the flagship 6x80 + 4x40 nets on the "
              f"card: params and EVM params bitwise equal {ok['iv']} (different before: "
              f"{differed})")
        rec["pth"] = {"ok": ok["iv"]}
        del a, b

        # (v) --profile: the first stage of 20 flagship steps
        prof_dir = os.path.join(tdir, "profile")
        reset()
        rc_p = train_mod.main(["--config", flagship("profile", 20), "--profile", prof_dir])
        launches_p = read()
        traces = glob.glob(os.path.join(prof_dir, "trace_*.json"))
        names = set()
        for tr in traces:
            names |= {ev.get("name", "") for ev in json.load(open(tr)).get("traceEvents", [])}
        kern = {k: sorted(n for n in names if k in n)[:2] for k in ("loss_fwd_kernel",
                                                                    "loss_bwd_kernel")}
        ok["v"] = (rc_p == 0 and len(traces) == 1 and all(kern.values())
                   and launches_p == {**dict.fromkeys(launches_p, 0), "fused_residual_fwd": 20,
                                      "fused_residual_bwd": 20})
        print(f"tools (v) --profile over a 20-step flagship stage: exit {rc_p}, traces "
              f"{[os.path.getsize(t) for t in traces]} B, kernels named {kern}, launches "
              f"{launches_p}; ok {ok['v']}")
        rec["profile"] = {"kernels": kern, "launches": launches_p, "ok": ok["v"]}

        # (vi) the widths at "high": 6x289 fits no resident plan of kernels
        # 1-4, so it trains on the streamed plan; 6x288 keeps the resident
        # plan. Both through the solver, 3 Adam steps each
        widths = {}
        for h in (289, 288):
            cfg_h = json.loads(json.dumps(FLAGSHIP))
            cfg_h["network"]["hidden_size"] = h
            s, _ = ready_solver(ConfigManager.from_dict(cfg_h).config)
            reset()
            s.train(num_epoch=3, lr=1e-3)
            torch.cuda.synchronize()
            widths[h] = {"engine": s.engine, "launches": read(), "finite": finite(s),
                         "plan": tuple(fr.loss_plan(h, s.matmul_precision))}
            del s
            torch.cuda.empty_cache()
        want = {**dict.fromkeys(widths[288]["launches"], 0), "fused_residual_fwd": 3,
                "fused_residual_bwd": 3}
        ok["vi"] = (all(w["engine"] == "pallas" and w["finite"] and w["launches"] == want
                        for w in widths.values())
                    and fr.Plan(*widths[289]["plan"]).streamed
                    and not fr.Plan(*widths[288]["plan"]).streamed)
        print(f"tools (vi) widths at 'high': 6x289 on {widths[289]['plan']}, launches "
              f"{widths[289]['launches']}; 6x288 on {widths[288]['plan']}, launches "
              f"{widths[288]['launches']}; engines {widths[289]['engine']} / "
              f"{widths[288]['engine']}, finite {widths[289]['finite']} / "
              f"{widths[288]['finite']}; ok {ok['vi']}")
        rec["width"] = {str(h): w for h, w in widths.items()}

        # (vii) the watchdog under torchrun at world 1: stopped by
        # WATCHDOG_DEADLINE_TS after its first checkpoints, then a second
        # call resumes from the newest and runs to the end of the stage
        wd_cfg, wd_log = flagship("wd", 10**6, checkpoint_freq=200, log_interval=20), \
            os.path.join(tdir, "wd.log")
        t0 = time.time()
        with env_var("WATCHDOG_DEADLINE_TS", str(t0 + WD_DEADLINE_S)):
            rc_w1 = watchdog.run(wd_cfg, wd_log, torchrun=True, poll=1.0)
        first_s = time.time() - t0
        stop = newest("wd")
        stop_step = (ckpt_mod.load_metadata(stop) or {}).get("global_step", -1) if stop else -1
        cadence = glob.glob(os.path.join(tdir, "wd", "**", "model_cavity_loop*.ckpt"),
                            recursive=True)
        flagship("wd", stop_step + 20, checkpoint_freq=200, log_interval=20)
        t0 = time.time()
        rc_w2 = watchdog.run(wd_cfg, wd_log, torchrun=True, poll=1.0)
        second_s = time.time() - t0
        final = newest("wd", "model_final.ckpt")
        final_step = (ckpt_mod.load_metadata(final) or {}).get("global_step") if final else None
        wlog = open(wd_log).read()
        ok["vii"] = (rc_w1 == 0 and rc_w2 == 0 and bool(cadence) and stop_step >= 200
                     and os.path.basename(stop).startswith("sigterm_step")
                     and "deadline reached - SIGTERM" in wlog
                     and f"launching (resume: {stop})" in wlog
                     and wlog.count("training completed") == 1 and final_step == stop_step + 20
                     and not os.path.exists(os.path.join(".run", "wd.pid")))
        print(f"tools (vii) watchdog (torchrun, world 1): first call exit {rc_w1} after "
              f"{first_s:.1f} s (deadline {WD_DEADLINE_S} s), {len(cadence)} cadence "
              f"checkpoints, stopped at step {stop_step} ({os.path.basename(stop or '')}); "
              f"second call exit {rc_w2} in {second_s:.1f} s, resumed from the newest, final "
              f"step {final_step}; ok {ok['vii']}")
        if not ok["vii"]:
            print(wlog[-4000:])
        rec["watchdog"] = {"rc": [rc_w1, rc_w2], "seconds": [first_s, second_s],
                           "stop_step": stop_step, "final_step": final_step, "ok": ok["vii"]}
    finally:
        PINNSolver.train = orig_train
        shutil.rmtree(tdir, ignore_errors=True)
    rec["seconds"] = time.time() - t_phase
    print(f"tools phase: {rec['seconds']:.1f} s on the card")
    torch.cuda.empty_cache()
    return ok, rec


def phase_rung(torch, np, ctx):
    """4k. the capacity ladder's next rung, this slice's path:
    configs/re2000_ev_h288.yaml at hidden_size RUNG_H with one Adam stage of
    RUNG_STEPS steps at lr RUNG_LR (built in memory), through train.main
    --init-from artifacts/best_re2000_h288.ckpt: the Net2Net widening 288 ->
    352, then Adam steps through kernels 1+2 on the streamed plan. Before
    it, on one batch, the widened net's equation loss through kernel 1
    (streamed plan) against the h288 donor's (resident plan), beside the
    exact fp32 plain version's own 288-vs-352 distance. The run twice:
    launches, a finite loss at every step, the two runs bitwise equal.
    Returns (ok, record)."""
    from nsfnet_tpu_torch import train as train_mod
    from nsfnet_tpu_torch.config import ConfigManager
    from nsfnet_tpu_torch.ops import fused_residual as fr
    from nsfnet_tpu_torch.training.solver import PINNSolver

    card, reset, read, ready_solver = (ctx["card"], ctx["reset_counts"], ctx["read_counts"],
                                       ctx["ready_solver"])
    t_phase = time.time()
    cfg_path, donor_ckpt = "configs/re2000_ev_h288.yaml", "artifacts/best_re2000_h288.ckpt"
    raw = ConfigManager.from_file(cfg_path).to_dict()
    stage = {"alpha": raw["physics"]["alpha_evm"], "epochs": RUNG_STEPS, "lr": RUNG_LR,
             "name": "R352", "optimizer": "adam"}
    precision = raw["training"]["matmul_precision"]
    plan = fr.loss_plan(RUNG_H, precision)
    rec = {"plan": tuple(plan), "donor_plan": tuple(fr.loss_plan(288, precision))}
    print(f"rung: {cfg_path} at 6x{RUNG_H} {precision!r}, kernels 1+2 on {plan} (the donor "
          f"6x288 on {fr.loss_plan(288, precision)})")

    # step 0: the widened net and its donor on one batch
    step0, points = {}, {}
    for h in (288, RUNG_H):
        r = json.loads(json.dumps(raw))
        r["network"]["hidden_size"] = h
        r["training"]["training_stages"] = [stage]
        cfg = ConfigManager.from_dict(r).config
        s, d = ready_solver(cfg)
        train_mod.warm_start(s, cfg, d, donor_ckpt)
        s.set_alpha_evm(stage["alpha"])
        s._ensure_ready()
        a = ((s.state.params, s.state.params_evm), s._batch, s.state.vis_t_minus,
             s._stage_scalars(stage["lr"]))
        with torch.no_grad():
            step0[h] = {"kernel": s._make_loss()(*a)[1][0].equation.item(),
                        "exact": s._loss_fn(*a)[1][0].equation.item()}
        points[h] = s.eq_points()
        del s, d, a
        torch.cuda.empty_cache()
    same_points = all(np.array_equal(u, v) for u, v in zip(points[288], points[RUNG_H]))
    k_rel = abs(step0[RUNG_H]["kernel"] - step0[288]["kernel"]) / abs(step0[288]["kernel"])
    x_rel = abs(step0[RUNG_H]["exact"] - step0[288]["exact"]) / abs(step0[288]["exact"])
    # the bar: the widening is exact (new units feed zero weights), so only
    # the order of fp32 sums may move the loss; the exact fp32 plain
    # version's own 288-vs-352 distance is that order's effect, printed beside
    # it and required to sit inside the bar
    ok_step0 = same_points and k_rel <= WIDEN_TOL and x_rel <= WIDEN_TOL
    print(f"rung step 0, one batch of {int(points[288][0].shape[0]):,} points (the same for both: "
          f"{same_points}): equation loss through kernel 1, the widened 6x{RUNG_H} net "
          f"{step0[RUNG_H]['kernel']!r} vs the h288 donor {step0[288]['kernel']!r}: rel diff "
          f"{k_rel:.3e} (tolerance {WIDEN_TOL:g}); the exact fp32 plain version "
          f"{step0[RUNG_H]['exact']!r} vs {step0[288]['exact']!r}: rel diff {x_rel:.3e}; ok "
          f"{ok_step0}")
    rec["step0"] = {"by_width": step0, "kernel_rel": k_rel, "exact_rel": x_rel,
                    "same_points": same_points, "ok": ok_step0}

    tdir = tempfile.mkdtemp(prefix="chip_smoke_rung_")
    seen, runs = [], []
    orig_train = PINNSolver.train

    def spy(self, *a, **kw):
        seen.append(self)
        return orig_train(self, *a, **kw)

    PINNSolver.train = spy
    try:
        rung = json.loads(json.dumps(raw))
        rung["network"]["hidden_size"] = RUNG_H
        for i in range(2):
            path = write_config(tdir, rung, f"rung{i}", [stage], log_interval=1,
                                checkpoint_freq=10**9, enable_tensorboard=False)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset()
            t0 = time.time()
            rc = train_mod.main(["--config", path, "--init-from", donor_ckpt])
            torch.cuda.synchronize()
            seconds = time.time() - t0
            launches = read()
            sv = seen[-1]
            hist = [m._asdict() for _, m in sv.loss_history]
            runs.append({"rc": rc, "seconds": seconds, "launches": launches,
                         "history": hist, "widths": (sv.layers, sv.hidden_size),
                         "steps": sv.global_step,
                         "params": torch.cat([sv.state.params.detach(),
                                              sv.state.params_evm.detach()]).clone(),
                         "peak_mb": torch.cuda.max_memory_allocated() / 2**20})
        sv = seen[-1]
        sv.run_steps(2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sv.run_steps(10)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / 10
        rec["profile"] = profile_steps(torch, lambda: sv.run_steps(5), card,
                                       f"rung step (6x{RUNG_H}, N_f 120,000, streamed plan)")
    finally:
        PINNSolver.train = orig_train
        shutil.rmtree(tdir, ignore_errors=True)
    want = {**dict.fromkeys(runs[0]["launches"], 0), "fused_residual_fwd": RUNG_STEPS,
            "fused_residual_bwd": RUNG_STEPS}
    finite = all(math.isfinite(v) for r in runs for m in r["history"] for v in m.values())
    bitwise = (torch.equal(runs[0]["params"], runs[1]["params"])
               and runs[0]["history"] == runs[1]["history"])
    ok_run = (all(r["rc"] == 0 and r["launches"] == want and r["widths"] == (6, RUNG_H)
                  and r["steps"] == RUNG_STEPS and len(r["history"]) == RUNG_STEPS
                  for r in runs) and finite and bitwise)
    h0 = runs[0]["history"]
    print(f"rung run: train.main --init-from {donor_ckpt} at 6x{RUNG_H}: exit "
          f"{[r['rc'] for r in runs]} in {[round(r['seconds'], 1) for r in runs]} s, launches "
          f"{runs[0]['launches']} / {runs[1]['launches']}, {len(h0)} logged steps, total loss "
          f"{h0[0]['total']:.6e} -> {h0[-1]['total']:.6e}, equation {h0[0]['equation']:.6e} -> "
          f"{h0[-1]['equation']:.6e}, finite {finite}, the two runs bitwise equal {bitwise}; "
          f"{step_ms:.2f} ms per Adam step at N_f {sv.N_f:,}, peak memory "
          f"{runs[0]['peak_mb']:,.0f} MiB; ok {ok_run} — {card}")
    for r in runs:
        del r["params"]
    rec.update(runs=runs, step_ms=step_ms, n_f=sv.N_f, ok=ok_run,
               seconds=time.time() - t_phase)
    print(f"rung phase: {rec['seconds']:.1f} s on the card")
    del sv, seen
    torch.cuda.empty_cache()
    return ok_step0 and ok_run, rec


def phase_measure(torch, np, ctx):
    """4l. the measurement entry points: (ii) tools.perf_matrix.run in
    process at N_F with MATRIX_STEPS-step chunks (the KAN MATRIX_KAN_NF and
    MATRIX_KAN_STEPS): every row without error, each row's launches those
    of its kernels (kernels 1+2 on the three mlp/pallas rows, 5+6 on
    sf/pallas, none on sf/xla and kan); then (i) + (iii) the bench as a
    subprocess (`python -m nsfnet_tpu_torch.bench`, the real entry point)
    while tools.watchdog trains the flagship config cut to one stage of
    DRILL_STEPS steps: the bench SIGTERMs the registered trainer, which
    checkpoints and exits, holds .run/pause over its measurement and
    removes it; its last line (points/s/card, a finite mfu, the card's
    name) and its launch line (BENCH_STEPS x 4 of kernels 1+2); the
    watchdog relaunches only after the bench, resumes from the trainer's
    checkpoint and ends the stage. Returns ({name: ok}, record)."""
    from nsfnet_tpu_torch.bench import _alive
    from nsfnet_tpu_torch.tools import perf_matrix as pm
    from nsfnet_tpu_torch.tools import watchdog
    from nsfnet_tpu_torch.training import checkpoint as ckpt_mod

    card, reset, read, smi = ctx["card"], ctx["reset_counts"], ctx["read_counts"], ctx["smi"]
    t_phase = time.time()
    tdir = tempfile.mkdtemp(prefix="chip_smoke_measure_")
    rec, ok = {}, {}
    pairs = {"mlp/pallas highest": ("fused_residual_fwd", "fused_residual_bwd"),
             "mlp/pallas high": ("fused_residual_fwd", "fused_residual_bwd"),
             "mlp/pallas default": ("fused_residual_fwd", "fused_residual_bwd"),
             "sf/xla-closed-form high": (),
             "sf/pallas high": PSI_LOSS_KERNELS,
             "kan/generic high": ()}
    th = None  # the watchdog's thread
    flag, reg = os.path.join(".run", "pause"), os.path.join(".run", "drill.pid")
    try:
        # (ii) the matrix
        reset()
        t0 = time.time()
        rows = pm.run(N_F, MATRIX_STEPS, MATRIX_KAN_NF, MATRIX_KAN_STEPS, "cuda",
                      on_row=lambda r: print(f"measure (ii) row {json.dumps(r)}", flush=True))
        matrix_s, totals = time.time() - t0, read()
        bad = []
        for r in rows:
            want = {k: (4 * MATRIX_STEPS if k in pairs.get(r["config"], ()) else 0)
                    for k in totals}
            if "error" in r or r["launches"] != want:
                bad.append(r["config"])
            elif r["config"].startswith("mlp/") and not math.isfinite(r["mfu"] or math.nan):
                bad.append(r["config"])
            elif not 0 < (r["busy_share"] or math.nan) <= 1.05:  # the card's busy share
                bad.append(r["config"])
        ok["ii"] = [r["config"] for r in rows] == list(pairs) and not bad
        pm.write_table(rows, sys.stdout)
        print(f"measure (ii) the matrix at N_f {N_F:,} ({MATRIX_STEPS}-step chunks; KAN "
              f"{MATRIX_KAN_NF:,}, {MATRIX_KAN_STEPS}): {matrix_s:.1f} s, launches in all "
              f"{totals}, rows failing {bad}; ok {ok['ii']} — {card}")
        rec["matrix"] = {"rows": rows, "launches": totals, "seconds": matrix_s}
        torch.cuda.empty_cache()

        # (i) + (iii) the bench while the watchdog trains
        stage = {**FLAGSHIP["training"]["training_stages"][0], "epochs": DRILL_STEPS,
                 "name": "drill"}
        cfg = write_config(tdir, FLAGSHIP, "drill", [stage], checkpoint_freq=10**9,
                           log_interval=100)
        log = os.path.join(tdir, "drill.log")
        for path in (reg, flag):
            if os.path.exists(path):
                os.remove(path)
        wd = {}
        deadline = time.time() + DRILL_TIMEOUT_S
        th = threading.Thread(target=lambda: wd.update(rc=watchdog.run(
            cfg, log, poll=1.0, pause_poll=0.5, restart_delay=0.5, deadline=deadline)),
            daemon=True)
        th.start()
        text = lambda: open(log).read() if os.path.exists(log) else ""
        while time.time() < deadline and "throughput=" not in text() and th.is_alive():
            time.sleep(0.5)
        trainer = int(open(reg).read()) if os.path.exists(reg) else -1
        out_path, err_path = os.path.join(tdir, "bench.out"), os.path.join(tdir, "bench.err")
        t0 = time.time()
        with open(out_path, "w") as out, open(err_path, "w") as err:
            bench = subprocess.Popen([sys.executable, "-m", "nsfnet_tpu_torch.bench"],
                                     stdout=out, stderr=err)
            # between the trainer's exit and the bench's result line (the
            # flag and the watchdog's log read first: a sample taken before
            # that line is printed is inside the measurement)
            t_stop, flag_seen, launches_during = None, [], []
            while bench.poll() is None:
                if t_stop is None and not _alive(trainer):
                    t_stop = time.time() - t0
                held, launched = os.path.exists(flag), text().count("] launching (")
                if t_stop is not None and '"metric"' not in open(out_path).read():
                    flag_seen.append(held)
                    launches_during.append(launched)
                time.sleep(0.2)
        bench_s, bench_rc = time.time() - t0, bench.returncode
        flag_after = os.path.exists(flag)
        th.join(timeout=max(1.0, deadline - time.time() + 60))
        bench_out, bench_err = open(out_path).read(), open(err_path).read()
        lines = bench_out.strip().splitlines()
        try:
            line, launch_line = json.loads(lines[-1]), json.loads(lines[-2])
        except (IndexError, ValueError):
            line, launch_line = {}, {}
        want = {"fused_residual_fwd": 4 * BENCH_STEPS, "fused_residual_bwd": 4 * BENCH_STEPS}
        ok["i"] = (bench_rc == 0 and line.get("value", 0) > 0
                   and math.isfinite(line.get("mfu") or math.nan)
                   and line.get("device") == smi
                   and launch_line.get("launches") == want
                   and launch_line.get("steps_per_chunk") == BENCH_STEPS
                   and 0 < (launch_line.get("busy_share") or math.nan) <= 1.05)
        print(f"measure (i) python -m nsfnet_tpu_torch.bench: exit {bench_rc} in {bench_s:.1f} s; "
              f"launch line {launch_line}; last line {line}; ok {ok['i']}")
        if not ok["i"]:
            print(bench_out[-3000:], bench_err[-3000:])
        stops = glob.glob(os.path.join(tdir, "drill", "**", "sigterm_step*.ckpt"), recursive=True)
        stop = stops[0] if len(stops) == 1 else None
        stop_step = (ckpt_mod.load_metadata(stop) or {}).get("global_step", -1) if stop else -1
        finals = glob.glob(os.path.join(tdir, "drill", "**", "model_final.ckpt"), recursive=True)
        final_step = (ckpt_mod.load_metadata(finals[0]) or {}).get("global_step") if finals else None
        wlog = text()
        ok["iii"] = (trainer > 0 and "bench: paused 1 live trainer(s)" in bench_err
                     and t_stop is not None and 0 < stop_step < DRILL_STEPS
                     and bool(flag_seen) and all(flag_seen) and set(launches_during) == {1}
                     and not flag_after and wd.get("rc") == 0
                     and f"launching (resume: {stop})" in wlog
                     and f"at step {stop_step}" in wlog
                     and wlog.count("training completed") == 1 and final_step == DRILL_STEPS
                     and not os.path.exists(reg))
        stopped = "never" if t_stop is None else f"{t_stop:.1f} s after the bench started"
        print(f"measure (iii) the pause drill: trainer pid {trainer} stopped {stopped}, at {os.path.basename(stop or '')} (step {stop_step}); "
              f".run/pause held in {sum(flag_seen)} of {len(flag_seen)} samples from the stop "
              f"to the bench's result, gone after the bench {not flag_after}; the watchdog's "
              f"launches in those samples {sorted(set(launches_during))}; watchdog exit "
              f"{wd.get('rc')}, resumed from the "
              f"checkpoint, final step {final_step} of {DRILL_STEPS}; ok {ok['iii']}")
        if not ok["iii"]:
            print(wlog[-4000:])
        rec["bench"] = {"rc": bench_rc, "seconds": bench_s, "line": line,
                        "launch_line": launch_line}
        rec["drill"] = {"trainer_stop_s": t_stop, "stop_step": stop_step,
                        "flag_samples": len(flag_seen), "flag_held": all(flag_seen or [False]),
                        "flag_after": flag_after, "watchdog_rc": wd.get("rc"),
                        "final_step": final_step}
    finally:
        if th is not None and th.is_alive():
            # a failed drill: no relaunch, the trainer stopped, the watchdog ends
            open(flag, "w").close()
            if os.path.exists(reg):
                with contextlib.suppress(ValueError, OSError):
                    os.kill(int(open(reg).read()), signal.SIGTERM)
            th.join(timeout=DRILL_TIMEOUT_S)
            with contextlib.suppress(OSError):
                os.remove(flag)
        shutil.rmtree(tdir, ignore_errors=True)
    rec["seconds"] = time.time() - t_phase
    print(f"measure phase: {rec['seconds']:.1f} s on the card")
    torch.cuda.empty_cache()
    return ok, rec


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1

    from nsfnet_tpu_torch.config import ConfigManager
    from nsfnet_tpu_torch.models.mlp import (flatten_params, init_mlp, layer_sizes, mlp_apply,
                                             unflatten_params)
    from nsfnet_tpu_torch import ops
    from nsfnet_tpu_torch.ops import _build
    from nsfnet_tpu_torch.ops import fused_residual as fr
    from nsfnet_tpu_torch.ops import mlp_streams as ms
    from nsfnet_tpu_torch.ops import pass_checks as pc
    from nsfnet_tpu_torch.ops import psi_streams as psi
    from nsfnet_tpu_torch.ops.derivatives import assemble_psi_bundle
    from nsfnet_tpu_torch.train import build_data, build_solver, unsupported

    for name in ("NSFNET_FUSED_LOSS", "NSFNET_PALLAS_PSI"):
        os.environ.pop(name, None)  # the paths below choose them themselves
    record = {}
    dev = torch.device("cuda", 0)

    reset_counts, read_counts = ops.reset_launch_counts, ops.launch_counts

    def weight_ring():
        """The weight ring's counters of kernels 1-4 since the last reset, by
        launched kernel: K-slots staged, those prefetched, their share."""
        return {k: {"slots": n, "prefetched": mod.weight_prefetch[k],
                    "share": round(mod.weight_prefetch[k] / n, 5)}
                for mod in (fr, ms) for k, n in mod.weight_slots.items() if n}

    def ready_solver(cfg, where="cuda"):
        s = build_solver(cfg, device=where)
        d = build_data(cfg)
        s.set_boundary_data(X=d.boundary_data())
        s.set_eq_training_data(X=d.training_data(), weights=d.sdf_weights)
        s.set_coordinate_transform(d.coord_scale)
        return s, d

    # ---- 1. the card
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    card = f"{kind} ({smi})"
    print(f"card: {kind}")
    print(f"nvidia-smi name,power.limit: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    record["card"] = {"name": kind, "nvidia_smi": smi, "torch": torch.__version__}

    # ---- 2. build
    t0 = time.time()
    libs = _build.build_all()
    build_s = time.time() - t0
    print(f"build: {sorted(libs)} in {build_s:.1f} s")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "ptxas info" in line or "spill" in line:
                print(f"  [{name}] {line.strip()}")
    record["build_s"] = build_s
    sizes = layer_sizes(2, 3, 6, 80)
    sizes_v1 = layer_sizes(2, 3, 4, 120)
    for h in (80, 120):
        for name in fr.PRECISIONS:
            tile, panel = ms.pick_bwd_tile(h, name)
            smem = fr.loss_smem_bytes(tile, panel, h, fr.PARTS[name])
            assert ms._lib().nsf_mlp_streams_smem_bytes(tile, panel, h, 3, fr.PARTS[name],
                                                        0) == smem
            print(f"width {h}, kernels 3+4 at {name!r}: tile {tile} points, weight panel "
                  f"{panel}, {smem} B shared memory per block, {fr.LOSS_BLOCKS} blocks")
    for h in (80, 160):
        for name in fr.PRECISIONS:
            tile, panel = fr.pick_loss_tile(h, name)
            smem = fr.loss_smem_bytes(tile, panel, h, fr.PARTS[name])
            assert fr._lib().nsf_fused_loss_smem_bytes(tile, panel, h, 3, fr.PARTS[name],
                                                       0) == smem
            print(f"width {h}, kernels 1+2 at {name!r}: tile {tile} points, weight panel "
                  f"{panel}, {smem} B shared memory per block, {fr.LOSS_BLOCKS} blocks")
    for h in (40, 80, 120):
        for name in fr.PRECISIONS:
            tile, panel = psi.pick_bwd_tile(h, name)
            smem = psi.bwd_smem_bytes(tile, panel, h, fr.PARTS[name])
            assert psi._lib().nsf_psi_streams_smem_bytes(tile, panel, h, 2, fr.PARTS[name],
                                                         0) == smem
            print(f"width {h}, kernels 5+6 at {name!r}: tile {tile} points, weight panel "
                  f"{panel}, {smem} B shared memory per block, {fr.LOSS_BLOCKS} blocks")
    # the streamed plan where no resident plan fits: its shared memory and
    # global regions, the libraries' counts against the Python twins
    for what, plan_of, smem_of, lib_smem, carry_of, lib_carry, k, widths in (
            ("kernels 1-4", fr.loss_plan, fr.loss_smem_bytes, fr._lib().nsf_fused_loss_smem_bytes,
             fr.carry_floats, fr._lib().nsf_fused_loss_carry_floats, 3, FIRST_STREAMED["velocity"]),
            ("kernels 5+6", psi.psi_plan, psi.bwd_smem_bytes, psi._lib().nsf_psi_streams_smem_bytes,
             psi.carry_floats, psi._lib().nsf_psi_streams_carry_floats, 2,
             FIRST_STREAMED["streamfunction"])):
        for name in fr.PRECISIONS:
            for h in (widths[name] - 1, widths[name], WIDEST):
                pl, parts = plan_of(h, name, k), fr.PARTS[name]
                smem = smem_of(pl.tile, pl.panel, h, parts, k, pl.kpanel)
                assert pl.streamed == (h >= widths[name]) and smem <= fr._MAX_SMEM, (what, h, pl)
                assert lib_smem(pl.tile, pl.panel, h, k, parts, pl.kpanel) == smem
                if pl.streamed:
                    assert lib_carry(pl.tile, h, k, parts) == carry_of(pl.tile, h, k, parts)
                print(f"width {h}, {what} at {name!r}: {pl}, {smem} B shared memory per block"
                      + (f", {fr.LOSS_BLOCKS * 4 * carry_of(pl.tile, h, k, parts) / 1e6:.1f} MB "
                         f"of carries in global memory" if pl.streamed else ""))

    # ---- 3. kernel checks at full width
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def padded_points(cfg, n_f):
        """The config's collocation draw, padded like the solver's batch."""
        data = build_data(cfg)
        data.boundary_data()
        xf, yf = data.training_data()
        n = -(-n_f // fr.ROW_ALIGN) * fr.ROW_ALIGN
        x = torch.zeros((n, 2))
        x[:n_f, 0], x[:n_f, 1] = torch.from_numpy(xf[:, 0]), torch.from_numpy(yf[:, 0])
        return data, n, x

    data, n, x = padded_points(ConfigManager.from_dict(FLAGSHIP).config, N_F)
    pad = n - N_F
    eq_w = torch.zeros((n, 1))
    eq_w[:N_F] = torch.from_numpy(data.sdf_weights.reshape(-1, 1))
    gen = torch.Generator().manual_seed(0)
    flat = flatten_params(init_mlp(sizes, gen))
    e = 0.05 * torch.randn((n, 1), generator=gen)
    vis_t = torch.clamp(0.05 * torch.randn((n, 1), generator=gen).abs(), max=20.0 / RE)
    x, eq_w, flat, e, vis_t = (t.to(dev).contiguous() for t in (x, eq_w, flat, e, vis_t))
    ct = torch.tensor([1.0, 1.0, 1.0, 0.1], device=dev) / N_F
    args = (flat, sizes, x, e, vis_t, eq_w, RE)

    # 3a. kernels 1+2 at each precision name, against the plain version's
    # passes at that name; at "high" (the configs' name) also against exact fp32
    params = unflatten_params(flat, sizes)
    pair_chk, graphs = {}, {}
    ok_check = True
    for name in ("high", "highest", "default", None):
        flat_r = flat.clone().requires_grad_(True)
        e_r = e.clone().requires_grad_(True)
        sums_p = fr.plain_residual_sums(unflatten_params(flat_r, sizes), x, e_r, vis_t, eq_w,
                                        RE, 1.0, True, name)
        dflat_p, ge_p = torch.autograd.grad(sums_p, [flat_r, e_r], ct, retain_graph=True)
        if name is None:
            exact = (sums_p.detach(), dflat_p, ge_p)
            del sums_p
            continue
        graphs[name] = (sums_p, flat_r, e_r)
        sums_k = fr.fused_fwd(*args, 1.0, True, name)
        sums_k2 = fr.fused_fwd(*args, 1.0, True, name)
        dflat_k, ge_k = fr.fused_bwd(*args, ct, 1.0, True, name)
        dflat_k2, ge_k2 = fr.fused_bwd(*args, ct, 1.0, True, name)
        torch.cuda.synchronize()
        c = {"fwd_rel": rel_sums(sums_k.tolist(), sums_p.tolist()),
             "fwd_abs": (sums_k - sums_p).abs().max().item(),
             "bwd_rel": rel_per_param(unflatten_params, dflat_k, dflat_p, sizes),
             "ge_rel": rel_max(ge_k, ge_p),
             "ge_norm_rel": ((ge_k - ge_p).norm() / ge_p.norm()).item(),
             "ge_points_over": int(((ge_k - ge_p).abs() > FWD_TOL * ge_p.abs().max()).sum()),
             "bwd_abs": max((dflat_k - dflat_p).abs().max().item(),
                            (ge_k - ge_p).abs().max().item()),
             "fwd_det": torch.equal(sums_k, sums_k2),
             "bwd_det": torch.equal(dflat_k, dflat_k2) and torch.equal(ge_k, ge_k2),
             "kernel": (sums_k, dflat_k, ge_k)}
        pair_chk[name] = c
        print(f"kernel fused_residual_fwd {name!r}: sums {sums_k.tolist()} plain {sums_p.tolist()}")
        print(f"  max rel diff {c['fwd_rel']:.3e} (tolerance {FWD_TOL:g}), max abs "
              f"{c['fwd_abs']:.3e}, bitwise equal across runs: {c['fwd_det']}")
        print(f"kernel fused_residual_bwd {name!r}: max rel diff dW/db {c['bwd_rel']:.3e}, g_e "
              f"{c['ge_rel']:.3e} (tolerance {BWD_TOL:g}, per tensor max|diff|/max|plain|; g_e "
              f"norm-wise {c['ge_norm_rel']:.3e}, {c['ge_points_over']} of {n} points over "
              f"{FWD_TOL:g} of max|g_e|), max abs {c['bwd_abs']:.3e}, bitwise equal across runs: "
              f"{c['bwd_det']}")
        # g_e is per point. With one bf16 pass, a carry whose fp32 value lies on a
        # bf16 rounding edge rounds one way in the kernel and the other in the
        # plain version (their fp32 sums differ in order), which moves that
        # point's g_e by up to ~2^-9 of one term: "default" holds g_e norm-wise.
        ge_err = c["ge_norm_rel"] if name == "default" else c["ge_rel"]
        ok_check = ok_check and (
            c["fwd_rel"] <= FWD_TOL and c["bwd_rel"] <= BWD_TOL and ge_err <= BWD_TOL
            and c["fwd_det"] and c["bwd_det"])
    sums_k, dflat_k, ge_k = pair_chk["high"]["kernel"]
    hi_exact = {"fwd_rel": rel_sums(sums_k.tolist(), exact[0].tolist()),
                "bwd_rel": rel_per_param(unflatten_params, dflat_k, exact[1], sizes),
                "ge_rel": rel_max(ge_k, exact[2])}
    plain_hi = {"fwd_rel": rel_sums(graphs["high"][0].tolist(), exact[0].tolist())}
    print(f"kernels 1+2 at 'high' against the exact fp32 plain version: sums {hi_exact['fwd_rel']:.3e}, "
          f"dW/db {hi_exact['bwd_rel']:.3e}, g_e {hi_exact['ge_rel']:.3e} (tolerance {BWD_TOL:g}; "
          f"the plain version's own 'high' passes: sums {plain_hi['fwd_rel']:.3e})")
    ok_check = (ok_check and hi_exact["fwd_rel"] <= FWD_TOL and hi_exact["bwd_rel"] <= BWD_TOL
                and hi_exact["ge_rel"] <= BWD_TOL)
    for c in pair_chk.values():
        del c["kernel"]
    record["check"] = {"by_precision": pair_chk, "high_vs_exact": hi_exact,
                       "plain_high_vs_exact": plain_hi, "n": n, "pad": pad}
    del exact, sums_k, dflat_k, ge_k

    # 3a'. kernels 1+2 at the h160 campaign width (configs/re4000_r4b.yaml:
    # 6x160, Re = 4000) on the flagship's 120,000 points at "high" (tile 16,
    # panel 160): against the plain passes and exact fp32, bitwise across
    # runs, and timed here (the plain version's graph is not kept)
    sizes160 = layer_sizes(2, 3, 6, 160)
    flat160 = flatten_params(init_mlp(sizes160, torch.Generator().manual_seed(5))).to(dev)
    vis_t160 = vis_t.clamp(max=20.0 / RE_CAMPAIGN)
    args160 = (flat160, sizes160, x, e, vis_t160, eq_w, RE_CAMPAIGN)
    ref160 = {}
    for name in ("high", None):
        flat_r = flat160.clone().requires_grad_(True)
        e_r = e.clone().requires_grad_(True)
        sums_p = fr.plain_residual_sums(unflatten_params(flat_r, sizes160), x, e_r, vis_t160,
                                        eq_w, RE_CAMPAIGN, 1.0, True, name)
        grads = torch.autograd.grad(sums_p, [flat_r, e_r], ct, retain_graph=name == "high")
        ref160[name] = (sums_p.detach(), *grads)
        if name == "high":
            p2_ms = cuda_ms(torch, lambda: torch.autograd.grad(sums_p, [flat_r, e_r], ct,
                                                               retain_graph=True), 3)
        del sums_p, flat_r, e_r
    with torch.no_grad():
        p1_ms = cuda_ms(torch, lambda: fr.plain_residual_sums(
            unflatten_params(flat160, sizes160), x, e, vis_t160, eq_w, RE_CAMPAIGN, 1.0, True,
            "high"), 3)
    runs = [(fr.fused_fwd(*args160, 1.0, True, "high"),
             *fr.fused_bwd(*args160, ct, 1.0, True, "high")) for _ in range(2)]
    torch.cuda.synchronize()
    (sums_k, dflat_k, ge_k), again = runs
    c160 = {"tile_panel": fr.pick_loss_tile(160, "high"), "n": n}
    for tag, (s_r, d_r, g_r) in (("", ref160["high"]), ("exact_", ref160[None])):
        c160[tag + "fwd_rel"] = rel_sums(sums_k.tolist(), s_r.tolist())
        c160[tag + "bwd_rel"], c160[tag + "bwd_worst"] = worst_per_param(
            unflatten_params, dflat_k, d_r, sizes160)
        c160[tag + "ge_rel"] = rel_max(ge_k, g_r)
    # the plain 'high' passes' own distance from exact fp32: where it is the
    # larger, the kernel-vs-plain distance is the plain passes' error
    c160["plain_exact_bwd"], c160["plain_exact_bwd_worst"] = worst_per_param(
        unflatten_params, ref160["high"][1], ref160[None][1], sizes160)
    c160["plain_exact_fwd"] = rel_sums(ref160["high"][0].tolist(), ref160[None][0].tolist())
    c160["fwd_abs"] = (sums_k - ref160["high"][0]).abs().max().item()
    c160["bwd_abs"] = max((dflat_k - ref160["high"][1]).abs().max().item(),
                          (ge_k - ref160["high"][2]).abs().max().item())
    c160["det"] = all(torch.equal(a, b) for a, b in zip(runs[0], again))
    c160["k1_ms"] = cuda_ms(torch, lambda: fr.fused_fwd(*args160, 1.0, True, "high"), 20)
    c160["k2_ms"] = cuda_ms(torch, lambda: fr.fused_bwd(*args160, ct, 1.0, True, "high"), 10)
    c160["p1_ms"], c160["p2_ms"] = p1_ms, p2_ms
    print(f"kernels 1+2 at 6x160, N={n}, Re {RE_CAMPAIGN:g}, 'high', tile/panel "
          f"{c160['tile_panel']}: sums {c160['fwd_rel']:.3e}, dW/db {c160['bwd_rel']:.3e}, g_e "
          f"{c160['ge_rel']:.3e} from the plain passes (tolerance {BWD_TOL:g}); from exact fp32 "
          f"sums {c160['exact_fwd_rel']:.3e}, dW/db {c160['exact_bwd_rel']:.3e}, g_e "
          f"{c160['exact_ge_rel']:.3e}; bitwise equal across runs: {c160['det']}")
    print(f"  worst dW/db tensor: {c160['bwd_worst']} from the plain passes, "
          f"{c160['exact_bwd_worst']} from exact fp32; the plain 'high' passes from exact fp32: "
          f"sums {c160['plain_exact_fwd']:.3e}, dW/db {c160['plain_exact_bwd']:.3e} "
          f"(worst {c160['plain_exact_bwd_worst']})")
    ok_check = (ok_check and c160["det"]
                and max(c160[k] for k in c160 if k.endswith("_rel")) <= BWD_TOL)
    record["check_h160"] = c160
    del ref160, runs, again, sums_k, dflat_k, ge_k
    torch.cuda.empty_cache()

    # 3a''. kernels 1+2 at the reference v1 recipe's shape (configs/re2000_nsfnet.yaml:
    # 4x120, no EVM, N_f = 40,000, MSE, "high"), the polish phase's Adam stages:
    # against the plain passes and exact fp32, bitwise across runs, timed
    _, n_v1, x_v1 = padded_points(ConfigManager.from_dict(V1).config, N_F_V1)
    x_v1 = x_v1.to(dev).contiguous()
    flat_v1 = flatten_params(init_mlp(sizes_v1, torch.Generator().manual_seed(1))).to(dev)
    w_v1 = torch.zeros((n_v1, 1), device=dev)
    w_v1[:N_F_V1] = 1.0
    ct3 = torch.ones(3, device=dev) / N_F_V1
    args_v1 = (flat_v1, sizes_v1, x_v1, None, None, w_v1, RE)
    ref_v1 = {}
    for name in ("high", None):
        flat_r = flat_v1.clone().requires_grad_(True)
        sums_p = fr.plain_residual_sums(unflatten_params(flat_r, sizes_v1), x_v1, None, None,
                                        w_v1, RE, 1.0, False, name)
        (grad,) = torch.autograd.grad(sums_p, [flat_r], ct3, retain_graph=name == "high")
        ref_v1[name] = (sums_p.detach(), grad)
        if name == "high":
            p2_ms = cuda_ms(torch, lambda: torch.autograd.grad(sums_p, [flat_r], ct3,
                                                               retain_graph=True), 5)
        del sums_p, flat_r
    with torch.no_grad():
        p1_ms = cuda_ms(torch, lambda: fr.plain_residual_sums(
            unflatten_params(flat_v1, sizes_v1), x_v1, None, None, w_v1, RE, 1.0, False,
            "high"), 5)
    runs = [(fr.fused_fwd(*args_v1, 1.0, False, "high"),
             fr.fused_bwd(*args_v1, ct3, 1.0, False, "high")[0]) for _ in range(2)]
    torch.cuda.synchronize()
    (sums_k, dflat_k), again = runs
    cv1 = {"tile_panel": fr.pick_loss_tile(120, "high"), "n": n_v1}
    for tag, (s_r, d_r) in (("", ref_v1["high"]), ("exact_", ref_v1[None])):
        cv1[tag + "fwd_rel"] = rel_sums(sums_k.tolist(), s_r.tolist())
        cv1[tag + "bwd_rel"] = rel_per_param(unflatten_params, dflat_k, d_r, sizes_v1)
    # the plain 'high' passes' own distance from exact fp32, printed beside
    # the kernel's: the gate holds the kernel to the plain passes
    cv1["plain_exact_fwd"] = rel_sums(ref_v1["high"][0].tolist(), ref_v1[None][0].tolist())
    cv1["plain_exact_bwd"] = rel_per_param(unflatten_params, ref_v1["high"][1], ref_v1[None][1],
                                           sizes_v1)
    cv1["fwd_abs"] = (sums_k - ref_v1["high"][0]).abs().max().item()
    cv1["bwd_abs"] = (dflat_k - ref_v1["high"][1]).abs().max().item()
    cv1["det"] = all(torch.equal(a, b) for a, b in zip(runs[0], again))
    cv1["k1_ms"] = cuda_ms(torch, lambda: fr.fused_fwd(*args_v1, 1.0, False, "high"), 20)
    cv1["k2_ms"] = cuda_ms(torch, lambda: fr.fused_bwd(*args_v1, ct3, 1.0, False, "high"), 20)
    cv1["p1_ms"], cv1["p2_ms"] = p1_ms, p2_ms
    print(f"kernels 1+2 at 4x120, no EVM, N={n_v1}, 'high', tile/panel {cv1['tile_panel']}: "
          f"sums {cv1['fwd_rel']:.3e}, dW/db {cv1['bwd_rel']:.3e} from the plain passes "
          f"(tolerance {BWD_TOL:g}); from exact fp32 sums {cv1['exact_fwd_rel']:.3e}, dW/db "
          f"{cv1['exact_bwd_rel']:.3e} (the plain 'high' passes from exact fp32: sums "
          f"{cv1['plain_exact_fwd']:.3e}, dW/db {cv1['plain_exact_bwd']:.3e}); bitwise equal "
          f"across runs: {cv1['det']}; kernel 1 "
          f"{cv1['k1_ms']:.4f} ms, kernel 2 {cv1['k2_ms']:.4f} ms, plain {p1_ms:.4f} / "
          f"{p2_ms:.4f} ms — {card}")
    ok_check = (ok_check and cv1["det"] and cv1["fwd_rel"] <= FWD_TOL
                and cv1["bwd_rel"] <= BWD_TOL)
    record["check_v1_mse"] = cv1
    del ref_v1, runs, again, sums_k, dflat_k
    torch.cuda.empty_cache()

    def check_forward(what, name, run, plain, exact, bundle=None, depth=80):
        """A forward at `name` against the plain version's passes at that
        name (`plain(name)`), per stream, two runs bitwise; both against
        exact fp32; with `bundle`, also the streams assembled from the
        kernel's and the plain version's outputs. "default" is held
        norm-wise and "high" also by its separation from exact fp32, at the
        bars of ops/pass_checks.py, each checked to tell the name from the
        next (the separation up to the product depth pc.HIGH_SEP_MAX_K;
        `depth` is the net's hidden width). The witness beside them: the
        plain version with its sums rounded once, its distance from the
        plain version, and the carries whose bf16 parts differ between the
        two."""
        out_k, out_k2 = run(), run()
        with torch.no_grad():
            wit = pc.carry_flips(lambda: plain(name), exact[0].shape[0])
            out_p = wit["fp32"]
            outs = {"": (out_k, out_p)}
            if bundle is not None:
                outs["bundle_"] = (bundle(out_k), bundle(out_p))
            other = {"high": "highest", "default": "high"}.get(name)
            other = None if other is None else plain(other)
        torch.cuda.synchronize()
        f = {"abs": max((a - b).abs().max().item() for a, b in zip(out_k, out_p)),
             "det": all(torch.equal(a, b) for a, b in zip(out_k, out_k2)),
             "exact_rel": max(rel_max(a, b) for a, b in zip(out_k, exact)),
             "plain_exact_rel": max(rel_max(a, b) for a, b in zip(out_p, exact)),
             "plain_exact_norm_rel": max(pc.norm_rels(out_p, exact)),
             "witness_norm_rel": wit["norm_rel"],
             "kernel_witness_norm_rel": max(pc.norm_rels(out_k, wit["rounded_once"])),
             "witness_flips": wit["flips"], "witness_points": wit["points"],
             "witness_share": wit["share"]}
        for tag, (ks, ps) in outs.items():
            f[tag + "rel"] = max(rel_max(a, b) for a, b in zip(ks, ps))
            f[tag + "norm_rel"] = max(pc.norm_rels(ks, ps))
        gate, tol = ("norm_rel", pc.DEFAULT_NORM_TOL) if name == "default" else ("rel", FWD_TOL)
        # at "high" against exact fp32: no closer than the plain "high"
        # passes themselves sit (1.48e-4 for the order-3 streams at 6x224)
        exact_tol = max(FWD_TOL, f["plain_exact_rel"])
        print(f"kernel {what} {name!r}: max rel diff {f['rel']:.3e}, norm-wise "
              f"{f['norm_rel']:.3e}"
              + (f"; assembled bundle {f['bundle_rel']:.3e}, norm-wise {f['bundle_norm_rel']:.3e}"
                 if bundle is not None else "")
              + f" (tolerance {tol:g} per stream at the same name, "
              f"{'||diff||/||plain||' if gate == 'norm_rel' else 'max|diff|/max|plain|'}), max "
              f"abs {f['abs']:.3e}, bitwise equal across runs: {f['det']}; against exact fp32 "
              f"{f['exact_rel']:.3e} (bar at 'high' {exact_tol:.3e}: {FWD_TOL:g} or the plain "
              f"version's own passes, {f['plain_exact_rel']:.3e}, norm-wise "
              f"{f['plain_exact_norm_rel']:.3e})")
        print(f"  witness, the plain version with its sums rounded once: {f['witness_norm_rel']:.3e} "
              f"norm-wise from the plain version, the kernel {f['kernel_witness_norm_rel']:.3e} "
              f"from it; carries whose bf16 parts differ, per product {f['witness_flips']}, on "
              f"{f['witness_points']} of {len(exact[0])} points, which hold "
              f"{100 * f['witness_share']:.4f}% of the squared distance")
        ok = (all(f[tag + gate] <= tol for tag in outs) and f["det"]
              and (name != "high" or f["exact_rel"] <= exact_tol))
        if name == "high":
            f["separation"] = pc.separation(out_k, out_p, exact)
            f["witness_separation"] = pc.separation(wit["rounded_once"], out_p, exact)
            f["highest_separation"] = pc.separation(other, out_p, exact)
            gated = depth <= pc.HIGH_SEP_MAX_K
            print(f"  separation from exact fp32 (||. - plain|| / ||exact - plain||, rms over "
                  f"the streams): kernel {f['separation']:.4f} (bar {pc.HIGH_SEP:g}"
                  + ("" if gated else f", not gated at K = {depth} > {pc.HIGH_SEP_MAX_K}: the "
                     f"accumulation moves an output as far as the passes' truncation")
                  + f"), witness {f['witness_separation']:.4f}; the plain 'highest' passes "
                  f"{f['highest_separation']:.4f} and exact fp32 1 must miss it")
            ok = (ok and (f["separation"] <= pc.HIGH_SEP or not gated)
                  and f["highest_separation"] > pc.HIGH_SEP)
        if name == "default":
            f["high_vs_default_norm_rel"] = max(pc.norm_rels(other, out_p))
            print(f"  the plain 'high' passes sit {f['high_vs_default_norm_rel']:.3e} norm-wise "
                  f"from the plain one pass (must miss the bar {pc.DEFAULT_NORM_TOL:g})")
            ok = ok and f["high_vs_default_norm_rel"] > pc.DEFAULT_NORM_TOL
        return f, ok

    def check_backward(what, name, run, plain, sz, exact):
        """A tensor-core backward at `name` against the plain version's
        passes at that name, two runs bitwise; both against exact fp32."""
        d_k, d_k2 = run(), run()
        d_p = plain()
        torch.cuda.synchronize()
        b = {"rel": rel_per_param(unflatten_params, d_k, d_p, sz),
             "abs": (d_k - d_p).abs().max().item(), "det": torch.equal(d_k, d_k2),
             "exact_rel": rel_per_param(unflatten_params, d_k, exact, sz),
             "plain_exact_rel": rel_per_param(unflatten_params, d_p, exact, sz)}
        # one bf16 pass: a carry whose fp32 value lies on a rounding edge rounds
        # one way in the kernel and the other in the plain version (their fp32
        # sums differ in order); the flip moves the point's later carries by
        # ~2^-8 and can flip more of them, so "default" has its own bar
        tol = DEFAULT_BWD_TOL if name == "default" else BWD_TOL
        print(f"kernel {what} {name!r}: max rel diff dW/db {b['rel']:.3e} (tolerance {tol:g}, "
              f"per tensor max|diff|/max|plain| at the same name), max abs {b['abs']:.3e}, "
              f"bitwise equal across runs: {b['det']}; against exact fp32 {b['exact_rel']:.3e} "
              f"(the plain version's own passes {b['plain_exact_rel']:.3e})")
        ok = (b["rel"] <= tol and b["det"]
              and (name != "high" or b["exact_rel"] <= BWD_TOL))
        return b, ok

    # 3b. kernels 3+4 at both widths, at each precision name
    stream_cases = {"4x120": (flat_v1, sizes_v1, x_v1), "6x80": (flat, sizes, x)}
    stream_cts, stream_chk = {}, {}
    for name, (fl, sz, xx) in stream_cases.items():
        g = torch.Generator().manual_seed(2)
        cts = [torch.randn((xx.shape[0], 3), generator=g).to(dev) for _ in range(5)]
        stream_cts[name] = cts
        c = {"n": xx.shape[0], "fwd": {}, "bwd": {}}
        with torch.no_grad():
            exact = ms.plain_mlp_streams(fl, sz, xx)
        for prec in ("high", "highest", "default"):
            tile, panel = ms.pick_bwd_tile(sz[1], prec)
            c["fwd"][prec], ok = check_forward(
                f"mlp_streams_fwd {name} N={c['n']} tile {tile} panel {panel}", prec,
                lambda: ms.streams_fwd(fl, sz, xx, prec),
                lambda at: ms.plain_mlp_streams(fl, sz, xx, at), exact)
            ok_check = ok_check and ok
        exact = ms.plain_mlp_streams_bwd(fl, sz, xx, cts)
        for prec in ("high", "highest", "default"):
            c["bwd"][prec], ok = check_backward(
                f"mlp_streams_bwd {name} N={c['n']}", prec,
                lambda: ms.streams_bwd(fl, sz, xx, cts, prec),
                lambda: ms.plain_mlp_streams_bwd(fl, sz, xx, cts, prec), sz, exact)
            ok_check = ok_check and ok
        stream_chk[name] = c
        del exact
        torch.cuda.empty_cache()
    record["check_streams"] = stream_chk

    # 3c. kernels 5+6 at each precision name: raw streams, bundle, gradient
    # (streams 3-4 zero / non-zero)
    sizes_sf = layer_sizes(2, 2, 6, 80)
    sizes_sf_small, sizes_sf_wide = layer_sizes(2, 2, 4, 40), layer_sizes(2, 2, 4, 120)
    g = torch.Generator().manual_seed(3)
    x_small = (2.0 * torch.rand((N_SF_SMALL, 2), generator=g) - 1.0).to(dev)
    psi_cases = {
        "6x80": (flatten_params(init_mlp(sizes_sf, g)).to(dev), sizes_sf, x),
        "4x40": (flatten_params(init_mlp(sizes_sf_small, g)).to(dev), sizes_sf_small, x_small),
        "4x120": (flatten_params(init_mlp(sizes_sf_wide, g)).to(dev), sizes_sf_wide, x_v1),
    }
    psi_cts, psi_chk = {}, {}
    for name, (fl, sz, xx) in psi_cases.items():
        g = torch.Generator().manual_seed(4)
        cts = [torch.randn((xx.shape[0], 2), generator=g).to(dev) for _ in range(13)]
        cts_used = [torch.zeros_like(c) if q in (3, 4) else c for q, c in enumerate(cts)]
        psi_cts[name] = cts
        c = {"n": xx.shape[0], "fwd": {}, "bwd": {}}
        with torch.no_grad():
            exact = psi.plain_psi_streams(fl, sz, xx)
        for prec in ("high", "highest", "default"):
            tile, panel = psi.pick_bwd_tile(sz[1], prec)
            c["fwd"][prec], ok = check_forward(
                f"psi_streams_fwd {name} N={c['n']} tile {tile} panel {panel}", prec,
                lambda: psi.psi_fwd(fl, sz, xx, prec),
                lambda at: psi.plain_psi_streams(fl, sz, xx, at), exact,
                bundle=lambda raw: assemble_psi_bundle(raw, 1.0))
            ok_check = ok_check and ok
        del exact
        torch.cuda.empty_cache()
        for tag, cc in (("all13", cts), ("zero34", cts_used)):
            exact = psi.plain_psi_streams_bwd(fl, sz, xx, cc)
            for prec in ("high", "highest", "default"):
                tile, panel = psi.pick_bwd_tile(sz[1], prec)
                c["bwd"][f"{prec}/{tag}"], ok = check_backward(
                    f"psi_streams_bwd {name} N={c['n']} tile {tile} panel {panel} "
                    f"({'all 13 cotangents' if tag == 'all13' else 'streams 3-4 zero'})", prec,
                    lambda: psi.psi_bwd(fl, sz, xx, cc, prec),
                    lambda: psi.plain_psi_streams_bwd(fl, sz, xx, cc, prec), sz, exact)
                ok_check = ok_check and ok
            del exact
            torch.cuda.empty_cache()
        psi_chk[name] = c
    record["check_psi"] = psi_chk
    torch.cuda.empty_cache()

    # 3d. the streamed plan (the carries in a block-private global scratch,
    # K-panels of them through shared memory), which the kernels take where
    # no resident plan fits: each kernel against its plain version at each
    # name, at the first such width and at WIDEST (3 hidden layers, N_WIDE
    # points), at the bars above; at equal tiles the streamed plan gives the
    # resident plan's outputs bitwise; then this slice's shapes at "high",
    # timed for phase 5: kernels 1+2 at 6x352 (N = 120,000), 3+4 at 4x352
    # (N = 40,000), 5+6 at 6x224 (N = 120,000), and kernels 1+2 at the
    # resident 6x224 and 6x288
    def seeded_flat(sz):
        return flatten_params(init_mlp(sz, torch.Generator().manual_seed(sz[1]))).to(dev)

    def check_pair(what, sz, a, ctn, name, fl):
        """Kernels 1+2 at `name` against the plain passes (at "high" also
        exact fp32), two runs bitwise, at 3a's bars."""
        runs = [(fr.fused_fwd(*a, 1.0, True, name), *fr.fused_bwd(*a, ctn, 1.0, True, name))
                for _ in range(2)]
        refs = {}
        for at in (name, None) if name == "high" else (name,):
            fl_r, e_r = fl.clone().requires_grad_(True), a[3].clone().requires_grad_(True)
            sums_p = fr.plain_residual_sums(unflatten_params(fl_r, sz), a[2], e_r, a[4], a[5],
                                            a[6], 1.0, True, at)
            refs[at] = (sums_p.detach(), *torch.autograd.grad(sums_p, [fl_r, e_r], ctn))
            del sums_p, fl_r, e_r
        torch.cuda.synchronize()
        (sk, dk, gk), again = runs
        sp, dp_, gp = refs[name]
        c = {"plan": tuple(fr.loss_plan(sz[1], name)), "fwd_rel": rel_sums(sk.tolist(), sp.tolist()),
             "bwd_rel": rel_per_param(unflatten_params, dk, dp_, sz), "ge_rel": rel_max(gk, gp),
             "ge_norm_rel": ((gk - gp).norm() / gp.norm()).item(),
             "fwd_abs": (sk - sp).abs().max().item(),
             "bwd_abs": max((dk - dp_).abs().max().item(), (gk - gp).abs().max().item()),
             "det": all(torch.equal(u, v) for u, v in zip(runs[0], again))}
        ge_err, ge_tol = c["ge_rel"], BWD_TOL
        extra = ""
        if name == "default":
            # one bf16 pass: a carry on a rounding edge flips between two sum
            # orders and moves its point's g_e by ~2^-9 of a term; a deeper
            # net has more carries a point and more such points, so g_e is
            # held norm-wise at the "default" backward bar of kernels 4 and
            # 6, beside the plain version's own distance from itself with
            # its sums rounded once (the witness)
            fl_r, e_r = fl.clone().requires_grad_(True), a[3].clone().requires_grad_(True)
            with fr.sums_rounded_once():
                sums_w = fr.plain_residual_sums(unflatten_params(fl_r, sz), a[2], e_r, a[4],
                                                a[5], a[6], 1.0, True, name)
                gw = torch.autograd.grad(sums_w, [fl_r, e_r], ctn)[1]
            c["ge_witness_norm_rel"] = ((gw - gp).norm() / gp.norm()).item()
            ge_err, ge_tol = c["ge_norm_rel"], DEFAULT_BWD_TOL
            extra = (f"; g_e norm-wise {ge_err:.3e} (tolerance {ge_tol:g}), the witness's "
                     f"{c['ge_witness_norm_rel']:.3e}")
            del sums_w, fl_r, e_r
        ok = (c["fwd_rel"] <= FWD_TOL and c["bwd_rel"] <= BWD_TOL and ge_err <= ge_tol
              and c["det"])
        if name == "high":
            se, de, ge = refs[None]
            c["exact_fwd_rel"] = rel_sums(sk.tolist(), se.tolist())
            c["exact_bwd_rel"] = max(rel_per_param(unflatten_params, dk, de, sz), rel_max(gk, ge))
            ok = ok and c["exact_fwd_rel"] <= FWD_TOL and c["exact_bwd_rel"] <= BWD_TOL
            extra = (f"; from exact fp32 sums {c['exact_fwd_rel']:.3e}, dW/db and g_e "
                     f"{c['exact_bwd_rel']:.3e}")
        print(f"kernels 1+2 {what} {name!r} on {fr.loss_plan(sz[1], name)}: sums "
              f"{c['fwd_rel']:.3e}, dW/db {c['bwd_rel']:.3e}, g_e {c['ge_rel']:.3e} (norm-wise "
              f"{c['ge_norm_rel']:.3e}) from the plain passes (tolerance {BWD_TOL:g}){extra}; "
              f"bitwise equal across runs: {c['det']}")
        return c, ok

    t_3d = time.time()
    g = torch.Generator().manual_seed(6)
    x_wide = (2.0 * torch.rand((N_WIDE, 2), generator=g) - 1.0).to(dev)
    e_wide = (0.05 * torch.randn((N_WIDE, 1), generator=g)).to(dev)
    vt_wide = (0.01 * torch.rand((N_WIDE, 1), generator=g)).to(dev)
    w_wide = (0.2 + torch.rand((N_WIDE, 1), generator=g)).to(dev)
    ct_wide = torch.tensor([1.0, 1.0, 1.0, 0.1], device=dev) / N_WIDE
    streamed_chk = {}
    for name in fr.PRECISIONS:
        for h in (FIRST_STREAMED["velocity"][name], WIDEST):
            sz = layer_sizes(2, 3, 3, h)
            fl = seeded_flat(sz)
            c, ok = check_pair(f"3x{h}, N={N_WIDE}", sz,
                               (fl, sz, x_wide, e_wide, vt_wide, w_wide, RE), ct_wide, name, fl)
            ok_check = ok_check and ok
            cts = [torch.randn((N_WIDE, 3), generator=g).to(dev) for _ in range(5)]
            with torch.no_grad():
                exact = ms.plain_mlp_streams(fl, sz, x_wide)
            c["streams_fwd"], ok = check_forward(
                f"mlp_streams_fwd 3x{h} N={N_WIDE} on {fr.loss_plan(h, name)}", name,
                lambda: ms.streams_fwd(fl, sz, x_wide, name),
                lambda at: ms.plain_mlp_streams(fl, sz, x_wide, at), exact, depth=h)
            ok_check = ok_check and ok
            c["streams_bwd"], ok = check_backward(
                f"mlp_streams_bwd 3x{h} N={N_WIDE}", name,
                lambda: ms.streams_bwd(fl, sz, x_wide, cts, name),
                lambda: ms.plain_mlp_streams_bwd(fl, sz, x_wide, cts, name), sz,
                ms.plain_mlp_streams_bwd(fl, sz, x_wide, cts))
            ok_check = ok_check and ok
            streamed_chk[f"velocity/{name}/{h}"] = c
        for h in (FIRST_STREAMED["streamfunction"][name], WIDEST):
            sz = layer_sizes(2, 2, 3, h)
            fl = seeded_flat(sz)
            cts = [torch.randn((N_WIDE, 2), generator=g).to(dev) for _ in range(13)]
            with torch.no_grad():
                exact = psi.plain_psi_streams(fl, sz, x_wide)
            c = {"plan": tuple(psi.psi_plan(h, name))}
            c["psi_fwd"], ok = check_forward(
                f"psi_streams_fwd 3x{h} N={N_WIDE} on {psi.psi_plan(h, name)}", name,
                lambda: psi.psi_fwd(fl, sz, x_wide, name),
                lambda at: psi.plain_psi_streams(fl, sz, x_wide, at), exact,
                bundle=lambda raw: assemble_psi_bundle(raw, 1.0), depth=h)
            ok_check = ok_check and ok
            c["psi_bwd"], ok = check_backward(
                f"psi_streams_bwd 3x{h} N={N_WIDE}", name,
                lambda: psi.psi_bwd(fl, sz, x_wide, cts, name),
                lambda: psi.plain_psi_streams_bwd(fl, sz, x_wide, cts, name), sz,
                psi.plain_psi_streams_bwd(fl, sz, x_wide, cts))
            ok_check = ok_check and ok
            streamed_chk[f"streamfunction/{name}/{h}"] = c
        torch.cuda.empty_cache()
    # the streamed plan at a resident plan's tile: the same k order, so the
    # same outputs, bitwise
    same = {}
    sz = layer_sizes(2, 3, 6, 160)
    fl = seeded_flat(sz)
    a = (fl, sz, x_wide, e_wide, vt_wide, w_wide, RE)
    pl = fr.Plan(16, 160, 64)
    same["kernels 1+2, 6x160 'high'"] = all(torch.equal(u, v) for u, v in zip(
        (fr.fused_fwd(*a, 1.0, True, "high"), *fr.fused_bwd(*a, ct_wide, 1.0, True, "high")),
        (fr.fused_fwd(*a, 1.0, True, "high", plan=pl),
         *fr.fused_bwd(*a, ct_wide, 1.0, True, "high", plan=pl))))
    sz = layer_sizes(2, 3, 4, 120)
    fl = seeded_flat(sz)
    cts = [torch.randn((N_WIDE, 3), generator=g).to(dev) for _ in range(5)]
    pl = fr.Plan(32, 80, 48)
    same["kernels 3+4, 4x120 'high'"] = all(torch.equal(u, v) for u, v in zip(
        (*ms.streams_fwd(fl, sz, x_wide, "high"), ms.streams_bwd(fl, sz, x_wide, cts, "high")),
        (*ms.streams_fwd(fl, sz, x_wide, "high", plan=pl),
         ms.streams_bwd(fl, sz, x_wide, cts, "high", plan=pl))))
    sz = layer_sizes(2, 2, 6, 80)
    fl = seeded_flat(sz)
    cts = [torch.randn((N_WIDE, 2), generator=g).to(dev) for _ in range(13)]
    pl = fr.Plan(16, 80, 32)
    same["kernels 5+6, 6x80 'high'"] = all(torch.equal(u, v) for u, v in zip(
        (*psi.psi_fwd(fl, sz, x_wide, "high"), psi.psi_bwd(fl, sz, x_wide, cts, "high")),
        (*psi.psi_fwd(fl, sz, x_wide, "high", plan=pl),
         psi.psi_bwd(fl, sz, x_wide, cts, "high", plan=pl))))
    print(f"the streamed plan at the resident plan's tile, bitwise equal to it: {same}")
    ok_check = ok_check and all(same.values())
    streamed_chk["same_as_resident"] = same

    def time_pair(sz, a, ctn):
        """Kernels 1+2 at "high" and their plain version (forward; forward
        graph + autograd), in ms."""
        fl = a[0]
        t = {"k1_ms": cuda_ms(torch, lambda: fr.fused_fwd(*a, 1.0, True, "high"), 5),
             "k2_ms": cuda_ms(torch, lambda: fr.fused_bwd(*a, ctn, 1.0, True, "high"), 3)}
        with torch.no_grad():
            t["p1_ms"] = cuda_ms(torch, lambda: fr.plain_residual_sums(
                unflatten_params(fl, sz), *a[2:], 1.0, True, "high"), 2, warmup=1)
        fl_r, e_r = fl.clone().requires_grad_(True), a[3].clone().requires_grad_(True)
        sums_p = fr.plain_residual_sums(unflatten_params(fl_r, sz), a[2], e_r, *a[4:], 1.0, True,
                                        "high")
        t["p2_ms"] = cuda_ms(torch, lambda: torch.autograd.grad(sums_p, [fl_r, e_r], ctn,
                                                                retain_graph=True), 2, warmup=1)
        del sums_p
        torch.cuda.empty_cache()
        return t

    wide_times = {}
    sz = layer_sizes(2, 3, 6, RUNG_H)
    fl = seeded_flat(sz)
    a = (fl, sz, x, e, vis_t, eq_w, RE)
    c, ok = check_pair(f"6x{RUNG_H}, N={n}", sz, a, ct, "high", fl)
    ok_check = ok_check and ok and fr.loss_plan(RUNG_H, "high").streamed
    wide_times[f"pair/6x{RUNG_H}"] = {**c, **time_pair(sz, a, ct), "n": n}
    for h in (224, 288):  # resident, the ladder's rungs below
        sz_h = layer_sizes(2, 3, 6, h)
        a_h = (seeded_flat(sz_h), sz_h, x, e, vis_t, eq_w, RE)
        wide_times[f"pair/6x{h}"] = {"plan": tuple(fr.loss_plan(h, "high")),
                                     **time_pair(sz_h, a_h, ct), "n": n}
    # the streamed plan where the resident one fits, at 6x288 (its resident
    # weight panel is 16 units): timed beside it, not taken by the plan
    pl = fr.Plan(16, fr.streamed_panel(288, 160), 128)
    t = wide_times["pair/6x288"]
    t["streamed"] = {"plan": tuple(pl), "k1_ms": cuda_ms(
        torch, lambda: fr.fused_fwd(*a_h, 1.0, True, "high", plan=pl), 5), "k2_ms": cuda_ms(
        torch, lambda: fr.fused_bwd(*a_h, ct, 1.0, True, "high", plan=pl), 3)}
    print(f"kernels 1+2 at 6x288 'high', N={n}: resident {fr.loss_plan(288, 'high')} "
          f"{t['k1_ms']:.4f} / {t['k2_ms']:.4f} ms, streamed {pl} {t['streamed']['k1_ms']:.4f} / "
          f"{t['streamed']['k2_ms']:.4f} ms — {card}")
    sz = layer_sizes(2, 3, 4, RUNG_H)
    fl = seeded_flat(sz)
    cts = [torch.randn((n_v1, 3), generator=g).to(dev) for _ in range(5)]
    with torch.no_grad():
        exact = ms.plain_mlp_streams(fl, sz, x_v1)
    c = {"plan": tuple(fr.loss_plan(RUNG_H, "high")), "n": n_v1}
    c["fwd"], ok = check_forward(
        f"mlp_streams_fwd 4x{RUNG_H} N={n_v1} on {fr.loss_plan(RUNG_H, 'high')}", "high",
        lambda: ms.streams_fwd(fl, sz, x_v1, "high"),
        lambda at: ms.plain_mlp_streams(fl, sz, x_v1, at), exact, depth=RUNG_H)
    ok_check = ok_check and ok
    exact = ms.plain_mlp_streams_bwd(fl, sz, x_v1, cts)
    c["bwd"], ok = check_backward(f"mlp_streams_bwd 4x{RUNG_H} N={n_v1}", "high",
                                  lambda: ms.streams_bwd(fl, sz, x_v1, cts, "high"),
                                  lambda: ms.plain_mlp_streams_bwd(fl, sz, x_v1, cts, "high"),
                                  sz, exact)
    ok_check = ok_check and ok
    c["k3_ms"] = cuda_ms(torch, lambda: ms.streams_fwd(fl, sz, x_v1, "high"), 10)
    with torch.no_grad():
        c["p3_ms"] = cuda_ms(torch, lambda: ms.plain_mlp_streams(fl, sz, x_v1, "high"), 3)
    c["k4_ms"] = cuda_ms(torch, lambda: ms.streams_bwd(fl, sz, x_v1, cts, "high"), 5)
    c["p4_ms"] = cuda_ms(torch, lambda: ms.plain_mlp_streams_bwd(fl, sz, x_v1, cts, "high"), 2,
                         warmup=1)
    wide_times[f"streams/4x{RUNG_H}"] = c
    del exact
    torch.cuda.empty_cache()
    sz = layer_sizes(2, 2, 6, 224)
    fl = seeded_flat(sz)
    cts = [torch.randn((n, 2), generator=g).to(dev) for _ in range(13)]
    with torch.no_grad():
        exact = psi.plain_psi_streams(fl, sz, x)
    c = {"plan": tuple(psi.psi_plan(224, "high")), "n": n}
    c["fwd"], ok = check_forward(
        f"psi_streams_fwd 6x224 N={n} on {psi.psi_plan(224, 'high')}", "high",
        lambda: psi.psi_fwd(fl, sz, x, "high"),
        lambda at: psi.plain_psi_streams(fl, sz, x, at), exact,
        bundle=lambda raw: assemble_psi_bundle(raw, 1.0), depth=224)
    ok_check = ok_check and ok
    del exact
    torch.cuda.empty_cache()
    exact = psi.plain_psi_streams_bwd(fl, sz, x, cts)
    c["bwd"], ok = check_backward(f"psi_streams_bwd 6x224 N={n}", "high",
                                  lambda: psi.psi_bwd(fl, sz, x, cts, "high"),
                                  lambda: psi.plain_psi_streams_bwd(fl, sz, x, cts, "high"),
                                  sz, exact)
    ok_check = ok_check and ok and psi.psi_plan(224, "high").streamed
    del exact
    torch.cuda.empty_cache()
    c["k5_ms"] = cuda_ms(torch, lambda: psi.psi_fwd(fl, sz, x, "high"), 5)
    with torch.no_grad():
        c["p5_ms"] = cuda_ms(torch, lambda: psi.plain_psi_streams(fl, sz, x, "high"), 2, warmup=1)
    c["k6_ms"] = cuda_ms(torch, lambda: psi.psi_bwd(fl, sz, x, cts, "high"), 3)
    c["p6_ms"] = cuda_ms(torch, lambda: psi.plain_psi_streams_bwd(fl, sz, x, cts, "high"), 2,
                         warmup=1)
    wide_times["psi/6x224"] = c
    del cts, fl
    torch.cuda.empty_cache()
    streamed_s = time.time() - t_3d
    print(f"streamed-plan checks (3d): {streamed_s:.1f} s on the card")
    record["check_streamed"] = {"by_width": streamed_chk, "slice_shapes": wide_times,
                                "seconds": streamed_s}

    # ---- 4. the paths, through the port's entry points
    def drive(cfg, name, expect):
        """train() for the config's stage with the counts reset just before
        and read just after; returns the solver and whether the path held."""
        solver, sdata = ready_solver(cfg)
        st = cfg.training.training_stages[0]
        solver.set_alpha_evm(st.alpha)
        reset_counts()
        t0 = time.time()
        solver.train(num_epoch=st.epochs, lr=st.lr, advance_on_stall=st.advance_on_stall,
                     stall_threshold=cfg.training.stall_threshold,
                     stall_window=cfg.training.stall_window,
                     stall_min_epochs=st.resolved_stall_min(),
                     stall_metric=cfg.training.stall_metric)
        torch.cuda.synchronize()
        seconds = time.time() - t0
        launches, ring = read_counts(), weight_ring()
        hist = [(s, m._asdict()) for s, m in solver.loss_history]
        finite = all(math.isfinite(v) for _, m in hist for v in m.values())
        first, last = hist[0][1]["total"], hist[-1][1]["total"]
        bx, by = sdata.boundary_data()[:2]
        preds = solver.predict((bx[:1000], by[:1000]))
        pred_ok = all(t.shape == (1000, 1) and torch.isfinite(t).all().item() for t in preds)
        print(f"{name}: {st.epochs} Adam steps in {seconds:.2f} s (first step builds), "
              f"launches {launches}; weight ring {ring}")
        for s, m in hist:
            print(f"  step {s}: " + " ".join(f"{k}={val:.4e}" for k, val in m.items()))
        print(f"  finite {finite}, total loss {first:.4e} -> {last:.4e}, predict ok {pred_ok}")
        record[name] = {"history": hist, "launches": launches, "weight_ring": ring,
                        "seconds": seconds}
        ok = (finite and last < first and pred_ok
              and all(launches[k] == (st.epochs if k in expect else 0) for k in launches))
        return solver, launches, ok

    def cuda_vs_cpu(base, what, **training):
        small = json.loads(json.dumps(base))
        small["training"].update(N_f=512, log_interval=1, **training)
        scfg = ConfigManager.from_dict(small).config
        runs = {}
        for where in ("cuda", "cpu"):
            s, _ = ready_solver(scfg, where)
            s.set_alpha_evm(scfg.training.training_stages[0].alpha)
            s.train(num_epoch=3, lr=1e-3)
            runs[where] = [m for _, m in s.loss_history]
        rel = max(abs(a - b) / max(abs(b), 1e-30)
                  for ma, mb in zip(runs["cuda"], runs["cpu"])
                  for a, b in zip(ma, mb) if b != 0.0)
        print(f"small input ({what}, N_f=512, 3 steps): cuda vs CPU max rel diff of the "
              f"metrics {rel:.3e} (tolerance {SMALL_TOL:g})")
        return rel

    # 4a/4b. the flagship slice: kernels 1+2
    fcfg = ConfigManager.from_dict(FLAGSHIP).config
    solver, launches, ok_slice = drive(fcfg, "slice", ("fused_residual_fwd",
                                                       "fused_residual_bwd"))
    record["small_rel"] = small_rel = cuda_vs_cpu(FLAGSHIP, "6x80 ev-nsfnet",
                                                  evm_update_freq=2)
    ok_small = small_rel <= SMALL_TOL

    # 4c. the v1 L2 slice: kernels 3+4
    vcfg = ConfigManager.from_dict(V1).config
    solver_v1, launches_v1, ok_v1 = drive(vcfg, "slice_v1_l2", ("mlp_streams_fwd",
                                                               "mlp_streams_bwd"))
    record["small_rel_v1"] = small_rel_v1 = cuda_vs_cpu(V1, "4x120 nsfnet L2")
    ok_small = ok_small and small_rel_v1 <= SMALL_TOL

    # 4d. unfused against fused on the flagship batch and the trained weights
    sides = {}
    for side, env in (("fused", None), ("unfused", "0")):
        with env_var("NSFNET_FUSED_LOSS", env):
            s, _ = ready_solver(fcfg)
            s.set_params(solver.params(), solver.params_evm())
            s._ensure_ready()
            reset_counts()
            total, (metrics, _) = s._make_loss()(
                (s.state.params, s.state.params_evm), s._batch, s.state.vis_t_minus,
                s._stage_scalars(1e-3))
            (grad,) = torch.autograd.grad(total, [s.state.params])
            torch.cuda.synchronize()
            sides[side] = (metrics.to_host(), grad, read_counts())
    m_rel = rel_sums(list(sides["unfused"][0]), list(sides["fused"][0]))
    g_rel = rel_per_param(unflatten_params, sides["unfused"][1], sides["fused"][1], sizes)
    none = dict.fromkeys(read_counts(), 0)
    routed = (sides["fused"][2] == {**none, "fused_residual_fwd": 1, "fused_residual_bwd": 1}
              and sides["unfused"][2] == {**none, "mlp_streams_fwd": 1, "mlp_streams_bwd": 1})
    print(f"unfused (kernels 3+4 -> residuals -> masked sums) vs fused (kernels 1+2), "
          f"flagship batch: metrics max rel diff {m_rel:.3e}, main-net gradient "
          f"{g_rel:.3e} (tolerance {UNFUSED_TOL:g}), each side through its own kernels: "
          f"{routed}")
    record["unfused_vs_fused"] = {"metrics_rel": m_rel, "grad_rel": g_rel, "routed": routed}
    ok_unfused = m_rel <= UNFUSED_TOL and g_rel <= UNFUSED_TOL and routed
    del sides, s

    # 4e. the streamfunction slice: kernels 5+6
    sfcfg = ConfigManager.from_dict(STREAMFUNCTION).config
    assert unsupported(sfcfg) == [], unsupported(sfcfg)
    solver_sf, launches_sf, ok_sf = drive(sfcfg, "slice_sf", PSI_LOSS_KERNELS)
    eq3_zero = all(m["eq3"] == 0.0 for _, m in record["slice_sf"]["history"])
    grid = torch.linspace(0.0, 1.0, 101)
    gx, gy = (t.reshape(-1, 1).numpy() for t in torch.meshgrid(grid, grid, indexing="ij"))
    div = solver_sf.divergence(gx, gy).abs().max().item()
    print(f"  eq3 == 0 exactly at every logged step: {eq3_zero}; max |u_x + v_y| on a 101x101 "
          f"grid {div:.3e} (tolerance {DIV_TOL:g})")
    ok_sf = ok_sf and eq3_zero and div <= DIV_TOL
    record["slice_sf"].update(eq3_zero=eq3_zero, divergence=div)
    record["small_rel_sf"] = small_rel_sf = cuda_vs_cpu(STREAMFUNCTION, "6x80 streamfunction",
                                                        evm_update_freq=2)
    ok_small = ok_small and small_rel_sf <= SMALL_TOL

    sides = {}
    for side, env in (("pallas", None), ("xla", "0")):
        with env_var("NSFNET_PALLAS_PSI", env):
            s, _ = ready_solver(sfcfg)
        assert s.engine == side, (s.engine, side)
        s.set_params(solver_sf.params(), solver_sf.params_evm())
        s._ensure_ready()
        reset_counts()
        total, (metrics, _) = s._make_loss()(
            (s.state.params, s.state.params_evm), s._batch, s.state.vis_t_minus,
            s._stage_scalars(1e-3))
        (grad,) = torch.autograd.grad(total, [s.state.params])
        torch.cuda.synchronize()
        sides[side] = (metrics.to_host(), grad, read_counts())
    m_rel_sf = rel_sums(list(sides["pallas"][0]), list(sides["xla"][0]))
    g_rel_sf = rel_per_param(unflatten_params, sides["pallas"][1], sides["xla"][1], sizes_sf)
    routed_sf = (sides["pallas"][2] == {**dict.fromkeys(read_counts(), 0),
                                        **dict.fromkeys(PSI_LOSS_KERNELS, 1)}
                 and not any(sides["xla"][2].values()))
    print(f"streamfunction step, kernel engine (kernels 5+6) vs closed form, the path's batch "
          f"and trained weights: metrics max rel diff {m_rel_sf:.3e}, main-net gradient "
          f"{g_rel_sf:.3e} (tolerance {ENGINE_TOL:g}), kernels launched on the kernel side "
          f"only: {routed_sf}")
    record["psi_vs_closed_form"] = {"metrics_rel": m_rel_sf, "grad_rel": g_rel_sf,
                                    "routed": routed_sf}
    ok_engine = m_rel_sf <= ENGINE_TOL and g_rel_sf <= ENGINE_TOL and routed_sf
    del sides, s
    torch.cuda.empty_cache()

    # ---- 4f. the campaign path: configs/re4000_r4b.yaml and
    # configs/re4000_ev_polish_h160.yaml at their widths (6x160 + 4x40 EVM,
    # N_f = 120,000, Re = 4000, "high") through the driver's main(), their
    # stages cut, every checkpoint under a temporary directory
    from nsfnet_tpu_torch import train as train_mod
    from nsfnet_tpu_torch.data.cavity import CavityData
    from nsfnet_tpu_torch.training import checkpoint as ckpt_mod
    from nsfnet_tpu_torch.training.solver import PINNSolver

    campaign_dir = tempfile.mkdtemp(prefix="chip_smoke_campaign_")
    seen, timings = [], {"residuals_at": [], "rar": []}
    orig = (PINNSolver.train, PINNSolver.residuals_at, CavityData.rar_training_data)

    spy_train = train_spy(orig[0], seen)

    def spy_scores(self, x, y, chunk=32768):
        t0 = time.perf_counter()
        out = orig[1](self, x, y, chunk)  # returns host arrays: synchronised
        timings["residuals_at"].append((len(out), time.perf_counter() - t0))
        return out

    def spy_rar(self, *a, **kw):
        t0 = time.perf_counter()
        out = orig[2](self, *a, **kw)
        timings["rar"].append(time.perf_counter() - t0)
        return out

    def campaign_config(src, name, stages, **training):
        return write_config(campaign_dir, src, name, stages, **training)

    def ckpt_in(name, pattern):
        found = sorted(glob.glob(os.path.join(campaign_dir, name, "**", pattern),
                                 recursive=True))
        return found[-1] if found else None

    def same_state(a, b):
        sa, sb = (torch.load(p, map_location="cpu", weights_only=True) for p in (a, b))
        return (all(torch.equal(sa[k], sb[k]) for k in ("params", "params_evm", "vis_t_minus"))
                and all(torch.equal(sa[o][m], sb[o][m]) for o in ("opt_main", "opt_evm")
                        for m in ("mu", "nu")))

    r4b_cfg, polish_cfg = "configs/re4000_r4b.yaml", "configs/re4000_ev_polish_h160.yaml"
    r4b_ckpt = "artifacts/live_re4000_r4b/latest.ckpt"
    gentle_ckpt = "artifacts/re4000_gentle/final_state.ckpt"
    camp = {}
    PINNSolver.train, PINNSolver.residuals_at = spy_train, spy_scores
    CavityData.rar_training_data = spy_rar
    child = None
    try:
        # (i) --resume the committed JAX checkpoint (step 1,240,000, 410,000
        # steps into R2): R2 ends 40 steps later, R3 (redrawn) is cut to 40
        stages = ConfigManager.from_file(r4b_cfg).to_dict()["training"]["training_stages"]
        stages[1]["epochs"] = 1_240_040 - stages[0]["epochs"]
        stages[2]["epochs"] = 40
        path = campaign_config(r4b_cfg, "r4b", stages)
        reset_counts()
        t0 = time.time()
        rc = train_mod.main(["--config", path, "--resume", r4b_ckpt])
        torch.cuda.synchronize()
        seconds = time.time() - t0
        launches_campaign, ring_campaign = read_counts(), weight_ring()
        meta = ckpt_mod.load_metadata(ckpt_in("r4b", "model_final.ckpt")) or {}
        solver_c = seen[-1]["solver"]
        hist = [(st, m._asdict()) for st, m in solver_c.loss_history]
        finite = bool(hist) and all(math.isfinite(v) for _, m in hist for v in m.values())
        entries = [(e["stage"], e["resume"], e["entry"], e["global_step"]) for e in seen]
        redrawn = len(seen) == 2 and not np.array_equal(seen[0]["x_f"], seen[1]["x_f"])
        print(f"campaign (i) --resume {r4b_ckpt} through train.main: exit {rc} in {seconds:.1f} s; "
              f"stage entries (stage, mid-stage, entry epoch, global step) {entries}; final "
              f"step {meta.get('global_step')} stage {meta.get('stage')} sampler draws_next "
              f"{meta.get('sampler', {}).get('draws_next')}; R3 redrawn {redrawn}; launches "
              f"{launches_campaign}; weight ring {ring_campaign}")
        for st, m in hist:
            print(f"  step {st}: " + " ".join(f"{k}={val:.4e}" for k, val in m.items()))
        ok_i = (rc == 0 and finite and redrawn
                and entries == [("R2", True, 410_000, 1_240_000), ("R3", False, 0, 1_240_040)]
                and meta.get("global_step") == 1_240_080 and meta.get("stage") == "R3"
                and meta.get("sampler", {}).get("draws_next") == 2
                and launches_campaign == {**dict.fromkeys(launches_campaign, 0),
                                          "fused_residual_fwd": 80, "fused_residual_bwd": 80})
        t0 = time.perf_counter()
        solver_c.save("write_timing.ckpt", directory=campaign_dir)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        solver_c.load(r4b_ckpt)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        print(f"  checkpoint write (torch.save + sidecar + fsync, 6x160 + carry) {write_s:.3f} s; "
              f"JAX checkpoint read ({os.path.getsize(r4b_ckpt):,} B, decode + install) "
              f"{read_s:.3f} s — {card}")
        camp["resume"] = {"rc": rc, "seconds": seconds, "entries": entries, "history": hist,
                          "launches": launches_campaign, "weight_ring": ring_campaign,
                          "final_meta": meta, "ok": ok_i,
                          "write_s": write_s, "read_s": read_s}

        # (ii) on the card: a real SIGTERM to the driver in a child process,
        # then --resume, against the uninterrupted run (fresh weights, seed)
        sig_stages = [{"alpha": 0.002, "epochs": 10**6, "lr": 1e-4, "name": "T1"}]
        sig_kw = dict(log_interval=1, checkpoint_freq=20)
        path = campaign_config(r4b_cfg, "sigterm", sig_stages, **sig_kw)
        root = os.path.dirname(os.path.abspath(__file__))
        with open(os.path.join(campaign_dir, "sigterm.log"), "w") as log:
            child = subprocess.Popen([sys.executable, "-m", "nsfnet_tpu_torch.train",
                                      "--config", path], cwd=campaign_dir, stdout=log,
                                     stderr=subprocess.STDOUT,
                                     env=dict(os.environ, PYTHONPATH=root))
            deadline = time.time() + 300
            while (not ckpt_in("sigterm", "model_cavity_loop20.ckpt")
                   and child.poll() is None and time.time() < deadline):
                time.sleep(0.02)
            child.send_signal(signal.SIGTERM)
            child_rc = child.wait(timeout=300)
        if child_rc != 3:
            with open(os.path.join(campaign_dir, "sigterm.log")) as log:
                print("  the child's log ends:\n" + log.read()[-3000:])
        stop = ckpt_in("sigterm", "sigterm_step*.ckpt")
        stop_step = (ckpt_mod.load_metadata(stop) or {}).get("global_step", -1) if stop else -1
        total = max(40, stop_step + 10)
        finals = {}
        for name, extra in (("sigterm_whole", []), ("sigterm_resumed", ["--resume", str(stop)])):
            sig_stages[0]["epochs"] = total
            rc_ = train_mod.main(["--config", campaign_config(r4b_cfg, name, sig_stages, **sig_kw),
                                  *extra])
            finals[name] = (rc_, ckpt_in(name, "model_final.ckpt"))
        equal = all(rc_ == 0 and f for rc_, f in finals.values()) and same_state(
            finals["sigterm_whole"][1], finals["sigterm_resumed"][1])
        print(f"campaign (ii) SIGTERM to the driver after its step-20 checkpoint: exit "
              f"{child_rc}, stopped at step {stop_step}; resumed to step {total} against "
              f"{total} uninterrupted steps: params, Adam moments and carry bitwise equal: {equal}")
        ok_ii = child_rc == 3 and stop_step >= 20 and equal
        camp["sigterm"] = {"rc": child_rc, "stop_step": stop_step, "total": total,
                           "equal": equal, "ok": ok_ii}

        # (iii) --init-from the h80 JAX checkpoint on re4000_ev_polish_h160
        # cut to P1 and P2 at 20 steps each: the widened net against the
        # donor, then P2's entry redraws residual-aware (4 x 120,000 scored,
        # 60,000 kept), and a resume from P2's checkpoint replays its points
        pol_stages = ConfigManager.from_file(polish_cfg).to_dict()["training"]["training_stages"][:2]
        for st in pol_stages:
            st["epochs"] = 20
        path = campaign_config(polish_cfg, "polish", pol_stages, checkpoint_freq=10)
        pcfg = ConfigManager.from_file(path).config
        wide, pdata = ready_solver(pcfg)
        train_mod.warm_start(wide, pcfg, pdata, gentle_ckpt)
        donor = PINNSolver(Re=4000, layers=6, layers_1=4, hidden_size=80, hidden_size_1=40,
                           N_f=pcfg.training.N_f, device="cuda")
        donor.load(gentle_ckpt)
        g = np.linspace(0.0, 1.0, 101, dtype=np.float32)
        gx, gy = (a.reshape(-1, 1) for a in np.meshgrid(g, g))
        widen_err = max((a - b).abs().max().item()
                        for a, b in zip(wide.predict((gx, gy)), donor.predict((gx, gy))))
        del wide, donor
        seen.clear()
        timings["residuals_at"].clear()
        rc = train_mod.main(["--config", path, "--init-from", gentle_ckpt])
        meta = ckpt_mod.load_metadata(ckpt_in("polish", "model_final.ckpt")) or {}
        rar = meta.get("sampler", {}).get("rar") or {}
        kept = len(base64.b64decode(rar.get("keep_idx", ""))) // 4
        scored = list(timings["residuals_at"])
        p2_points = [e["x_f"] for e in seen if e["stage"] == "P2"]
        p2_ckpt = next((c for c in glob.glob(os.path.join(campaign_dir, "polish", "**", "*.ckpt"),
                                             recursive=True)
                        if (ckpt_mod.load_metadata(c) or {}).get("global_step") == 30), None)
        seen.clear()
        timings["residuals_at"].clear()
        rc2 = train_mod.main(["--config", campaign_config(polish_cfg, "polish_resumed",
                                                          pol_stages, checkpoint_freq=10),
                              "--resume", str(p2_ckpt)])
        replayed = (len(p2_points) == 1 and len(seen) == 1 and seen[0]["stage"] == "P2"
                    and np.array_equal(seen[0]["x_f"], p2_points[0]))
        resumed_equal = rc2 == 0 and same_state(ckpt_in("polish", "model_final.ckpt"),
                                                ckpt_in("polish_resumed", "model_final.ckpt"))
        print(f"campaign (iii) --init-from {gentle_ckpt}: h80 -> h160 widened net against the "
              f"donor on a 101x101 grid, max |diff| of u, v, p, e {widen_err:.3e} (tolerance "
              f"{WIDEN_TOL:g}); exit {rc}; P2 entry scored {[n for n, _ in scored]} points in "
              f"{[round(t, 4) for _, t in scored]} s (residuals_at), the whole RAR redraw "
              f"{[round(t, 4) for t in timings['rar']]} s, kept {kept} (pool_mult "
              f"{rar.get('pool_mult')}) — {card}")
        print(f"  resume from the P2 checkpoint at step 30: exit {rc2}, P2's points replayed "
              f"bitwise without scoring: {replayed} (residuals_at calls "
              f"{len(timings['residuals_at'])}); final state bitwise equal: {resumed_equal}")
        ok_iii = (widen_err <= WIDEN_TOL and rc == 0 and kept == 60_000
                  and rar.get("pool_mult") == 4 and [n for n, _ in scored] == [480_000]
                  and replayed and not timings["residuals_at"] and resumed_equal)
        camp["init_from"] = {"widen_err": widen_err, "rc": rc, "scored": scored,
                             "rar_s": list(timings["rar"]), "kept": kept, "rc_resume": rc2,
                             "replayed": replayed, "resumed_equal": resumed_equal, "ok": ok_iii}
    finally:
        PINNSolver.train, PINNSolver.residuals_at, CavityData.rar_training_data = orig
        if child is not None and child.poll() is None:
            child.kill()
            child.wait()
        shutil.rmtree(campaign_dir, ignore_errors=True)
    record["campaign"] = camp
    ok_campaign = ok_i and ok_ii and ok_iii
    torch.cuda.empty_cache()

    # ---- 4g. the polish phase, through the driver's main(), every checkpoint
    # in a temporary directory: (i) the reference v1 recipe at its published
    # widths and settings, Adam stages through kernels 1+2 then the L-BFGS
    # polish; (ii) the h288 LM stage from the committed JAX checkpoint; (iii)
    # small-input checks of L-BFGS, LM slicing, supervision and the adaptive
    # boundary weight on the card
    polish_t0 = time.time()
    polish_dir = tempfile.mkdtemp(prefix="chip_smoke_polish_")
    polished, eq_before, pol = [], [], {}

    def spy_polish(self, *a, **kw):
        polished.append(self)
        if kw.get("optimizer") == "lm":  # the loaded net's equation loss, the stage's own loss
            self._ensure_ready()
            with torch.no_grad():
                _, (m, _) = self._loss_fn((self.state.params, self.state.params_evm), self._batch,
                                          self.state.vis_t_minus, self._stage_scalars(1.0))
            eq_before.append(m.equation.item())
        return orig[0](self, *a, **kw)

    v1_cfg, h288_cfg = "configs/re2000_nsfnet.yaml", "configs/re2000_ev_h288.yaml"
    h288_ckpt = "artifacts/best_re2000_h288.ckpt"
    PINNSolver.train = spy_polish
    try:
        # (i) re2000_nsfnet: its five Adam stages cut to 30 steps in all, its
        # lbfgs-polish stage to 50 (one chunk)
        stages = ConfigManager.from_file(v1_cfg).to_dict()["training"]["training_stages"]
        for st in stages[:5]:
            st["epochs"] = 6
        stages[5]["epochs"] = 50
        path = write_config(polish_dir, v1_cfg, "v1", stages, enable_tensorboard=False)
        reset_counts()
        t0 = time.time()
        rc = train_mod.main(["--config", path])
        torch.cuda.synchronize()
        seconds = time.time() - t0
        launches_polish = read_counts()
        sv = polished[-1]
        ps = sv.polish_stats
        hist, evals = ps["history"], ps["evaluations"]
        lbfgs_ms = 1e3 * ps["seconds"] / ps["steps"]
        print(f"polish (i) {v1_cfg} ({sv.layers}x{sv.hidden_size}, EVM {sv.evm}, N_f "
              f"{sv.N_f:,}, loss {sv.loss_mode}, {sv.matmul_precision!r}) through train.main: exit "
              f"{rc} in {seconds:.1f} s; launches {launches_polish}; L-BFGS {ps['steps']} steps, "
              f"loss {hist[0]:.6e} -> {hist[-1]:.6e}, value-and-grad evaluations per step mean "
              f"{np.mean(evals):.2f} max {max(evals)}, {lbfgs_ms:.3f} ms per L-BFGS step — {card}")
        ok_p1 = (rc == 0 and sv.global_step == 80 and ps["optimizer"] == "lbfgs"
                 and (sv.layers, sv.hidden_size, sv.evm, sv.loss_mode) == (4, 120, False, "MSE")
                 and all(math.isfinite(v) for v in hist) and hist[-1] < hist[0]
                 and launches_polish == {**dict.fromkeys(launches_polish, 0),
                                         "fused_residual_fwd": 30, "fused_residual_bwd": 30})
        pol["v1"] = {"rc": rc, "seconds": seconds, "launches": launches_polish,
                     "history": hist, "evaluations": evals, "lbfgs_ms_per_step": lbfgs_ms,
                     "ok": ok_p1}
        # where an L-BFGS step's time goes: 5 more steps from the polished state
        pol["v1"]["profile"] = profile_steps(torch, lambda: sv.train_lbfgs(5), card,
                                             "L-BFGS step (re2000_nsfnet, 4x120, N_f 40,000)")
        pol["v1"]["profile_evaluations"] = sv.polish_stats["evaluations"]
        print(f"  value-and-grad evaluations of the 5 profiled L-BFGS steps: "
              f"{sv.polish_stats['evaluations']}")
        del sv
        polished.clear()
        torch.cuda.empty_cache()

        # (ii) re2000_ev_h288 --init-from the committed checkpoint: P1 (LM,
        # lm_microbatches 3, cg_iters 50) at 6x288, N_f = 120,000, cut to 3 steps
        stages = ConfigManager.from_file(h288_cfg).to_dict()["training"]["training_stages"]
        stages[0]["epochs"] = 3
        path = write_config(polish_dir, h288_cfg, "h288", stages)
        torch.cuda.synchronize()
        base_mb = torch.cuda.memory_allocated(dev) / 2**20
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        t0 = time.time()
        rc = train_mod.main(["--config", path, "--init-from", h288_ckpt])
        torch.cuda.synchronize()
        seconds = time.time() - t0
        peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
        launches_lm = read_counts()
        sh = polished[-1]
        ps = sh.polish_stats
        hist, lam = ps["history"], ps["lam"]
        lm_s = ps["seconds"] / ps["steps"]
        widths = (sh.layers, sh.hidden_size, sh.layers_1, sh.hidden_size_1)
        print(f"polish (ii) {h288_cfg} --init-from {h288_ckpt} through train.main: exit {rc} in "
              f"{seconds:.1f} s; loaded widths {widths}, N_f {sh.N_f:,}, LM microbatches "
              f"{ps['microbatches']}, cg_iters {ps['cg_iters']}; equation loss of the loaded net "
              f"{eq_before[-1] if eq_before else float('nan'):.4e}; LM loss history "
              f"{[f'{v:.6e}' for v in hist]}, lam {lam:.3e}; {lm_s:.3f} s per LM step; peak "
              f"memory {peak_mb:,.0f} MiB ({peak_mb - base_mb:,.0f} MiB over the "
              f"{base_mb:,.0f} MiB held before); launches {launches_lm} — {card}")
        ok_p2 = (rc == 0 and widths == (6, 288, 4, 40) and sh.N_f == 120_000
                 and ps["optimizer"] == "lm" and ps["microbatches"] == 3 and len(hist) == 3
                 and all(math.isfinite(v) for v in hist) and math.isfinite(lam)
                 and all(b <= a for a, b in zip(hist, hist[1:]))
                 and len(eq_before) == 1 and math.isfinite(eq_before[0]) and eq_before[0] < 1e-4
                 and not any(launches_lm.values()))
        pol["h288"] = {"rc": rc, "seconds": seconds, "widths": widths, "history": hist,
                       "lam": lam, "s_per_step": lm_s, "peak_mb": peak_mb, "base_mb": base_mb,
                       "eq_before": eq_before[-1] if eq_before else None,
                       "launches": launches_lm, "ok": ok_p2}
        # where an LM step's time goes: one step with 3 CG iterations (its
        # products are the step's, 50 of them in the real one)
        pol["h288"]["profile"] = profile_steps(
            torch, lambda: sh.train_lm(1, cg_iters=3), card,
            "LM step with cg_iters 3 (re2000_ev_h288, 6x288, N_f 120,000, 3 slices)", n_steps=1)
        del sh
        polished.clear()
        torch.cuda.empty_cache()
    finally:
        PINNSolver.train = orig[0]
        shutil.rmtree(polish_dir, ignore_errors=True)

    # (iii) small inputs on the card: L-BFGS against the CPU; LM with the
    # Gauss-Newton products over 3 slices against the full batch; an Adam run
    # with supervision (one NaN p target) and the adaptive bc weight against the CPU
    small = json.loads(json.dumps(V1))
    small["training"].update(N_f=512, loss_mode="MSE")
    scfg = ConfigManager.from_dict(small).config
    hists = {}
    for where in ("cuda", "cpu"):
        s, _ = ready_solver(scfg, where)
        s.train(num_epoch=3, optimizer="lbfgs")
        hists[where] = s.polish_stats["history"]
    lbfgs_rel = max(abs(a - b) / abs(b) for a, b in zip(hists["cuda"], hists["cpu"]))
    print(f"small input (4x120 nsfnet MSE, N_f=512): L-BFGS 3 steps, cuda vs CPU max rel diff "
          f"of the loss history {lbfgs_rel:.3e} (tolerance {SMALL_TOL:g})")

    hraw = ConfigManager.from_file(h288_cfg).to_dict()
    hraw["training"].update(N_f=LM_SLICE_NF)
    hcfg = ConfigManager.from_dict(hraw).config
    lm_runs, loss_at_start = {}, {}
    for k in (1, 3):
        s, d = ready_solver(hcfg)
        train_mod.warm_start(s, hcfg, d, h288_ckpt)
        s.set_alpha_evm(hcfg.training.training_stages[0].alpha)
        # the loaded state's loss in this slice layout: with no CG iteration
        # the step is zero and the history entry is the loss at the start
        # (the params are unchanged: w + 0)
        s.train_lm(1, cg_iters=0, microbatches=k)
        loss_at_start[k] = s.polish_stats["history"][0]
        s.train_lm(2, cg_iters=10, microbatches=k)
        lm_runs[k] = (s.polish_stats["history"], torch.cat([s.state.params.detach(),
                                                            s.state.params_evm.detach()]))
    lm_hist_rel = max(abs(a - b) / abs(b) for a, b in zip(lm_runs[3][0], lm_runs[1][0]))
    lm_par_rel = rel_max(lm_runs[3][1], lm_runs[1][1])
    lm_layout_rel = abs(loss_at_start[3] - loss_at_start[1]) / abs(loss_at_start[1])
    print(f"LM on the card from {h288_ckpt} (N_f {LM_SLICE_NF:,}, 2 steps, cg 10): 3 slices vs "
          f"the full batch, loss history {lm_runs[3][0]} vs {lm_runs[1][0]}: max rel diff "
          f"{lm_hist_rel:.3e} (tolerance {LM_HIST_TOL:g}), params {lm_par_rel:.3e} (tolerance "
          f"{LM_PARAM_TOL:g}, max|diff|/max|w|); the loaded state's loss in the two layouts "
          f"{loss_at_start[3]!r} vs {loss_at_start[1]!r}: rel diff {lm_layout_rel:.3e}")
    del lm_runs, s, d

    small = json.loads(json.dumps(FLAGSHIP))
    small["training"].update(N_f=512, log_interval=1, evm_update_freq=2, adaptive_bc_weight=True)
    scfg = ConfigManager.from_dict(small).config
    g = np.random.default_rng(7)
    sup_xy = g.uniform(0.0, 1.0, (2, 64, 1)).astype(np.float32)
    sup_uvp = (0.1 * g.standard_normal((3, 64, 1))).astype(np.float32)
    sup_uvp[2, 5] = np.nan
    runs = {}
    for where in ("cuda", "cpu"):
        s, _ = ready_solver(scfg, where)
        s.set_alpha_evm(scfg.training.training_stages[0].alpha)
        s.set_supervised_data((*sup_xy, *sup_uvp))
        s.set_supervised_loss_weight(1.0)
        s.train(num_epoch=3, lr=1e-3)
        runs[where] = ([m for _, m in s.loss_history], s.current_alpha_b)
    sup_rel = max(abs(a - b) / max(abs(b), 1e-30) for ma, mb in zip(runs["cuda"][0], runs["cpu"][0])
                  for a, b in zip(ma, mb) if b != 0.0)
    ab_rel = abs(runs["cuda"][1] - runs["cpu"][1]) / runs["cpu"][1]
    sup_vals = [m.supervised for m in runs["cuda"][0]]
    print(f"small input (6x80 ev-nsfnet, N_f=512, 3 Adam steps, supervision with a NaN p target, "
          f"adaptive bc weight): cuda vs CPU metrics max rel diff {sup_rel:.3e}, alpha_b "
          f"{runs['cuda'][1]:.6f} vs {runs['cpu'][1]:.6f} ({ab_rel:.3e}; tolerance {SMALL_TOL:g}), "
          f"supervised loss {sup_vals}")
    ok_p3 = (lbfgs_rel <= SMALL_TOL and lm_hist_rel <= LM_HIST_TOL and lm_par_rel <= LM_PARAM_TOL
             and sup_rel <= SMALL_TOL and ab_rel <= SMALL_TOL and runs["cuda"][1] != scfg.physics.bc_weight
             and all(math.isfinite(v) and v > 0.0 for v in sup_vals))
    pol["small"] = {"lbfgs_rel": lbfgs_rel, "lm_hist_rel": lm_hist_rel, "lm_param_rel": lm_par_rel,
                    "lm_layout_rel": lm_layout_rel, "lm_loss_at_start": loss_at_start,
                    "sup_rel": sup_rel, "alpha_b": [runs["cuda"][1], runs["cpu"][1]],
                    "supervised": sup_vals, "ok": ok_p3}
    polish_s = time.time() - polish_t0
    print(f"polish phase: {polish_s:.1f} s on the card (builds excluded: the kernels were built)")
    pol["seconds"] = polish_s
    record["polish"] = pol
    ok_polish = ok_p1 and ok_p2 and ok_p3
    del runs, s
    torch.cuda.empty_cache()

    # ---- 4h. the other backbones, every checkpoint in a temporary directory:
    # (i) configs/kan_cavity.yaml through train.py's main(); (ii) the
    # committed JAX KAN state on cuda and on the CPU, then 20 L-BFGS steps;
    # (iii) the notebook's KAN at the flagship batch, timed Adam steps; (iv) a
    # Fourier-feature flagship net on the generic engine; (v) the generic
    # engines against the closed forms at full width. No kernel may launch.
    # (in a function: its names stay out of phase 5's)
    def run_backbones():
        from nsfnet_tpu_torch.models.kan import KAN
        from nsfnet_tpu_torch.ops import derivatives as D
        from nsfnet_tpu_torch.training.step import make_residual_fn

        other_t0 = time.time()
        other_dir = tempfile.mkdtemp(prefix="chip_smoke_backbones_")
        kan_cfg, kan_ckpt = "configs/kan_cavity.yaml", "artifacts/kan_cavity/final_state.ckpt"
        oth, driven = {}, []

        def spy_other(self, *a, **kw):
            driven.append(self)
            return orig[0](self, *a, **kw)

        def no_launches(counts):
            return not any(counts.values())

        def with_n_f(raw, n_f):
            return ConfigManager.from_dict({**raw, "training": {**raw["training"],
                                                                "N_f": n_f}}).config

        def lm_products(raw):
            """max|diff|/max|ref| over the LM residual r(w0), J v and J^T r,
            cuda against the CPU, on the config's net at N_f 512 (exact fp32)."""
            out = {}
            for where in ("cuda", "cpu"):
                s, _ = ready_solver(with_n_f(raw, 512), where)
                s._ensure_ready()
                res = make_residual_fn(
                    engine=s._engine("xla"), apply_main=s._uvp_apply(),
                    apply_evm=s._apply_evm() if s.evm else None, coord_scale=s.coord_scale,
                    alpha_e=s.alpha_e, alpha_s=s.alpha_s,
                    entropy_weight=s.entropy_residual_weight, evm=s.evm)
                w0, split = s._flat_state()
                sc = s._stage_scalars(1.0)
                f = lambda w: res(split(w), s._batch, s.state.vis_t_minus, sc)
                v = torch.from_numpy(np.random.default_rng(5).standard_normal(
                    w0.numel()).astype(np.float32)).to(w0.device)
                r, jv = torch.func.jvp(f, (w0,), (v,))
                (jtr,) = torch.func.vjp(f, w0)[1](r)
                out[where] = [t.detach().cpu() for t in (r, jv, jtr)]
            return max(rel_max(a, b) for a, b in zip(out["cuda"], out["cpu"]))

        PINNSolver.train = spy_other
        try:
            # (i) kan_cavity, its stage as published (200 L-BFGS steps, N_f 10,000)
            stages = ConfigManager.from_file(kan_cfg).to_dict()["training"]["training_stages"]
            path = write_config(other_dir, kan_cfg, "kan", stages)
            reset_counts()
            t0 = time.time()
            rc = train_mod.main(["--config", path])
            torch.cuda.synchronize()
            seconds = time.time() - t0
            launches_kan = read_counts()
            sk = driven[-1]
            ps = sk.polish_stats
            hist, evals = ps["history"], ps["evaluations"]
            kan_lbfgs_ms = 1e3 * ps["seconds"] / ps["steps"]
            print(f"backbones (i) {kan_cfg} (KAN {list(sk.net.width)}, grid {sk.net.grid}, k "
                  f"{sk.net.k}, N_f {sk.N_f:,}, engine {sk.engine}) through train.main: exit {rc} in "
                  f"{seconds:.1f} s; launches {launches_kan}; L-BFGS {ps['steps']} steps, loss "
                  f"{hist[0]:.6e} -> {hist[-1]:.6e} (the JAX package on the CPU from its own "
                  f"initialisation: 3.20e-1 -> 8.46e-3, VALIDATION.md:682; not gated), "
                  f"value-and-grad evaluations per step mean {np.mean(evals):.2f} max {max(evals)}, "
                  f"{kan_lbfgs_ms:.3f} ms per L-BFGS step — {card}")
            ok_o1 = (rc == 0 and sk.backbone == "kan" and sk.engine == "xla" and not sk.evm
                     and ps["optimizer"] == "lbfgs" and ps["steps"] == 200
                     and all(math.isfinite(v) for v in hist) and hist[-1] < hist[0]
                     and no_launches(launches_kan))
            oth["kan_cavity"] = {"rc": rc, "seconds": seconds, "launches": launches_kan,
                                 "history": hist, "evaluations": evals,
                                 "lbfgs_ms_per_step": kan_lbfgs_ms, "ok": ok_o1}
            oth["kan_cavity"]["profile"] = profile_steps(
                torch, lambda: sk.train_lbfgs(5), card, "KAN L-BFGS step (kan_cavity, N_f 10,000)")
            oth["kan_cavity"]["profile_evaluations"] = sk.polish_stats["evaluations"]
            print(f"  value-and-grad evaluations of the 5 profiled L-BFGS steps: "
                  f"{sk.polish_stats['evaluations']}")
            del sk
            driven.clear()
        finally:
            PINNSolver.train = orig[0]
            shutil.rmtree(other_dir, ignore_errors=True)

        # (ii) the committed JAX state (200 L-BFGS steps of the notebook's KAN) on
        # the config's seeded points, on cuda and on the CPU; then 20 L-BFGS steps
        kcfg = ConfigManager.from_file(kan_cfg).config
        loaded = {}
        for where in ("cuda", "cpu"):
            s, _ = ready_solver(kcfg, where)
            s.load(kan_ckpt)
            s._ensure_ready()
            with torch.no_grad():
                loaded[where] = s._loss_fn((s.state.params, None), s._batch, None,
                                           s._stage_scalars(1.0))[0].item()
            if where == "cuda":
                reset_counts()
                s.train(num_epoch=20, optimizer="lbfgs")
                torch.cuda.synchronize()
                launches_ld = read_counts()
                ld_hist = s.polish_stats["history"]
            del s
        ld_rel = abs(loaded["cuda"] - loaded["cpu"]) / abs(loaded["cpu"])
        print(f"backbones (ii) {kan_ckpt} on {kcfg.training.N_f:,} seeded points: loss cuda "
              f"{loaded['cuda']:.8e} vs CPU {loaded['cpu']:.8e}, rel diff {ld_rel:.3e} (tolerance "
              f"{KAN_LOAD_TOL:g}); 20 L-BFGS steps on cuda {ld_hist[0]:.6e} -> {ld_hist[-1]:.6e}; "
              f"launches {launches_ld}")
        ok_o2 = (ld_rel <= KAN_LOAD_TOL and math.isfinite(loaded["cuda"])
                 and all(math.isfinite(v) for v in ld_hist) and ld_hist[-1] <= ld_hist[0]
                 and no_launches(launches_ld))
        oth["kan_loaded"] = {"loss": loaded, "rel": ld_rel, "history": ld_hist,
                             "launches": launches_ld, "ok": ok_o2}

        # (iii) the notebook's KAN [2,16,16,8], no EVM, at the flagship batch
        # (N_f 120,000, as scripts/perf_matrix.py:152-155 builds it): Adam steps
        kraw = json.loads(json.dumps(FLAGSHIP))
        kraw["model_variant"] = "kan"
        kraw["network"].update(backbone="kan", kan_width=[2, 16, 16, 8], kan_grid=5, kan_k=3)
        kraw["experiment_name"] = "chip_smoke_kan_flagship_batch"
        kbcfg = ConfigManager.from_dict(kraw).config
        sk, _ = ready_solver(kbcfg)
        torch.cuda.synchronize()
        base_mb = torch.cuda.memory_allocated(dev) / 2**20
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        sk.run_steps(5, 1e-3)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = sk.run_steps(TIMED_STEPS, 1e-3)
        torch.cuda.synchronize()
        kan_ms = 1e3 * (time.perf_counter() - t0) / TIMED_STEPS
        launches_kb = read_counts()
        peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
        m = m.to_host()
        kan_pts = (sk._batch.n_f + sk._batch.n_b) / (kan_ms / 1e3)
        print(f"backbones (iii) KAN [2,16,16,8] no EVM, N_f {sk.N_f:,} + {int(sk._batch.n_b):,} "
              f"boundary points, engine {sk.engine}: {kan_ms:.3f} ms per Adam step "
              f"({TIMED_STEPS} after 5 warm-up), {kan_pts:,.0f} collocation points/s, peak "
              f"{peak_mb:,.0f} MiB ({peak_mb - base_mb:,.0f} over the {base_mb:,.0f} held "
              f"before), loss {m.total:.4e}, launches {launches_kb} — {card}")
        ok_o3 = math.isfinite(m.total) and no_launches(launches_kb) and sk.engine == "xla"
        oth["kan_step"] = {"ms_per_step": kan_ms, "pts_per_s": kan_pts, "peak_mb": peak_mb,
                           "base_mb": base_mb, "loss": m.total, "launches": launches_kb,
                           "ok": ok_o3}
        oth["kan_step"]["profile"] = profile_steps(
            torch, lambda: sk.run_steps(5), card, "KAN Adam step ([2,16,16,8], N_f 120,000)")
        del sk
        torch.cuda.empty_cache()

        # (iv) the flagship ev-NSFnet with 16 random Fourier features (sigma 3):
        # 30 Adam steps on the generic engine, then cuda against the CPU
        fraw = json.loads(json.dumps(FLAGSHIP))
        fraw["network"].update(fourier_features=16, fourier_sigma=3.0)
        fraw["experiment_name"] = "chip_smoke_fourier"
        frcfg = ConfigManager.from_dict(fraw).config
        sfr, launches_fr, ok_fr = drive(frcfg, "slice_fourier", ())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sfr.run_steps(10, 1e-3)
        torch.cuda.synchronize()
        fourier_ms = 1e3 * (time.perf_counter() - t0) / 10
        print(f"backbones (iv) Fourier 6x80 + 4x40 EVM (m 16, sigma 3, first fan_in "
              f"{sfr.net.sizes[0]}), N_f {sfr.N_f:,}, engine {sfr.engine}: {fourier_ms:.3f} ms per "
              f"Adam step (10 timed after the 30) — {card}")
        oth["fourier"] = {"ms_per_step": fourier_ms, "launches": launches_fr,
                          "profile": profile_steps(torch, lambda: sfr.run_steps(5), card,
                                                   "Fourier Adam step (6x80 m 16, N_f 120,000)")}
        del sfr
        torch.cuda.empty_cache()
        fr_rel = cuda_vs_cpu(fraw, "6x80 ev-nsfnet, 16 Fourier features", evm_update_freq=2)
        ok_o4 = ok_fr and fr_rel <= SMALL_TOL
        oth["fourier"].update(small_rel=fr_rel, ok=ok_o4)

        # (vi) LM on both backbones (training/lm.py through the solver's
        # train_lm; for the Fourier net each Gauss-Newton product is a third
        # level of forward mode over the generic engine), then the products
        # themselves cuda against the CPU on a small input
        lm_runs = {}
        for what, raw, start in (("KAN", ConfigManager.from_file(kan_cfg).to_dict(), kan_ckpt),
                                 ("Fourier", fraw, None)):
            s, _ = ready_solver(with_n_f(raw, LM_BACKBONE_NF))
            if start:
                s.load(start)
            reset_counts()
            s.train_lm(LM_BACKBONE_STEPS)
            torch.cuda.synchronize()
            st = s.polish_stats
            lm_runs[what] = {"history": st["history"], "lam": st["lam"],
                             "s_per_step": st["seconds"] / st["steps"], "launches": read_counts(),
                             "params": s.net.flat.numel() + (s.net_1.flat.numel() if s.evm else 0),
                             "products_rel": lm_products(raw)}
            del s
            r = lm_runs[what]
            print(f"backbones (vi) LM on the {what} net ({r['params']:,} parameters, N_f "
                  f"{LM_BACKBONE_NF:,}{', from ' + start if start else ''}), cg 50: "
                  f"{LM_BACKBONE_STEPS} steps, history "
                  + " ".join(f"{v:.6e}" for v in r["history"])
                  + f", lam {r['lam']:.1e}, {r['s_per_step']:.3f} s per step, launches "
                  f"{r['launches']}; Gauss-Newton products cuda vs CPU (N_f 512) max|diff|/max|ref| "
                  f"of r, J v, J^T r {r['products_rel']:.3e} (tolerance {SMALL_TOL:g}) — {card}")
        ok_o6 = all(all(math.isfinite(v) for v in r["history"]) and no_launches(r["launches"])
                    and r["products_rel"] <= SMALL_TOL for r in lm_runs.values())
        ok_o6 = ok_o6 and lm_runs["KAN"]["history"][-1] <= loaded["cuda"]
        oth["lm"] = {**lm_runs, "ok": ok_o6}
        torch.cuda.empty_cache()

        # (v) the generic engines against the closed forms, exact fp32, N = 120,000
        gen = torch.Generator().manual_seed(11)
        x = (torch.rand((N_F, 2), generator=gen) * 2 - 1).to(dev)
        stream_rel = lambda got, ref: max(rel_max(a, b) for a, b in zip(got, ref))
        with torch.no_grad():
            p = tuple((w.to(dev), b.to(dev)) for w, b in init_mlp(layer_sizes(2, 3, 6, 80), gen))
            g_mlp = stream_rel(D.derivatives_2d(lambda z: mlp_apply(p, z), x),
                               D.mlp_derivatives_2d(p, x))
            p = tuple((w.to(dev), b.to(dev)) for w, b in init_mlp(layer_sizes(2, 2, 6, 80), gen))
            g_psi = stream_rel(D.psi_p_derivatives_2d(lambda z: mlp_apply(p, z), x, 2.0),
                               D.mlp_psi_derivatives_2d(p, x, 2.0))
            net = KAN((2, 16, 16, 8), 5, 3, gen, dev)
            kp = net.params()
            g_kan = stream_rel(D.derivatives_2d(lambda z: net.apply_params(kp, z), x),
                               D.make_kan_derivatives_2d(net)(kp, x))
        print(f"backbones (v) generic vs closed form at N {N_F:,}, exact fp32, max over streams of "
              f"max|diff|/max|ref|: derivatives_2d 6x80 MLP {g_mlp:.3e} (tolerance "
              f"{GENERIC_TOL:g}); psi_p_derivatives_2d 6x80 (psi, p) {g_psi:.3e} (tolerance "
              f"{GENERIC_PSI_TOL:g}); derivatives_2d KAN [2,16,16,8] {g_kan:.3e} (tolerance "
              f"{GENERIC_TOL:g})")
        ok_o5 = g_mlp <= GENERIC_TOL and g_psi <= GENERIC_PSI_TOL and g_kan <= GENERIC_TOL
        oth["generic_vs_closed"] = {"mlp": g_mlp, "psi": g_psi, "kan": g_kan, "ok": ok_o5}
        torch.cuda.empty_cache()
        other_s = time.time() - other_t0
        print(f"backbones phase: {other_s:.1f} s on the card")
        oth["seconds"] = other_s
        record["backbones"] = oth
        return ok_o1, ok_o2, ok_o3, ok_o4, ok_o5, ok_o6

    ok_o1, ok_o2, ok_o3, ok_o4, ok_o5, ok_o6 = run_backbones()
    ok_other = ok_o1 and ok_o2 and ok_o3 and ok_o4 and ok_o5 and ok_o6

    # ---- 4i. microbatching and data parallelism, configs/re2000_ev.yaml at
    # its widths (6x80 + 4x40 EVM, N_f = 120,000, "high") with its stages cut
    # to one: (i) microbatches 4 against 1 from one initialisation; (ii) N_f
    # 1,200,000 over 10 microbatches; (iii) the driver under torchrun with
    # NCCL; (iv) two ranks on the one card (gloo, asked for by name: NCCL
    # takes one rank per card), against one process
    def run_parallel():
        from nsfnet_tpu_torch.parallel import mesh as pmesh
        from nsfnet_tpu_torch.tools import dist_worker
        from nsfnet_tpu_torch.training.step import make_grad_fn

        par_t0 = time.time()
        par_dir = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
        par = {}
        raw = ConfigManager.from_file("configs/re2000_ev.yaml").to_dict()
        raw["training"].update(evm_update_freq=10, log_interval=10, checkpoint_freq=10**9,
                               enable_tensorboard=False, matmul_precision="high")
        raw["training"]["training_stages"] = raw["training"]["training_stages"][:1]
        raw["training"]["training_stages"][0]["epochs"] = PAR_STEPS
        raw["eval_data"] = None

        def flagship(**training):
            cfg_ = json.loads(json.dumps(raw))
            cfg_["training"].update(**training)
            return ConfigManager.from_dict(cfg_).config

        def first_grads(s):
            s._ensure_ready()
            st = s.state
            leaves = [st.params.detach().clone().requires_grad_(True),
                      st.params_evm.detach().clone().requires_grad_(True)]
            grads, _, _ = make_grad_fn(s._make_loss(), s.microbatches)(
                tuple(leaves), leaves, s._batch, st.vis_t_minus, s._stage_scalars(1e-3))
            return grads

        def run_timed(s, st, n_steps, timed, what):
            """train() for one stage of n_steps with the counts reset just
            before and read just after, the peak memory over it, then
            `timed` timed steps (one chunk, no host sync)."""
            s.set_alpha_evm(st.alpha)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            reset_counts()
            t0 = time.time()
            s.train(num_epoch=n_steps, lr=st.lr)
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches, rows = read_counts(), dict(fr.launch_rows)
            peak = torch.cuda.max_memory_allocated(dev)
            hist = [m._asdict() for _, m in s.loss_history]
            t0 = time.perf_counter()
            s.run_steps(timed)
            torch.cuda.synchronize()
            step_ms = 1e3 * (time.perf_counter() - t0) / timed
            finite = all(math.isfinite(v) for m in hist for v in m.values())
            # the step's device busy share: the host issues every slice's ops
            prof = profile_steps(torch, lambda: s.run_steps(5), card, f"parallel {what}")
            print(f"parallel {what}: {n_steps} Adam steps in {wall:.2f} s, launches {launches}, "
                  f"rows per launch of kernel 1 "
                  f"{rows['fused_residual_fwd'] / max(launches['fused_residual_fwd'], 1):,.0f}; "
                  f"peak {peak / 2**20:,.0f} MiB ({(peak - base) / 2**20:,.0f} MiB above the "
                  f"run's start); {step_ms:.3f} ms/step over {timed} more steps; loss "
                  f"{hist[0]['total']:.4e} -> {hist[-1]['total']:.4e} — {card}")
            return {"launches": launches, "rows": rows, "peak_mib": peak / 2**20, "profile": prof,
                    "peak_above_start_mib": (peak - base) / 2**20, "step_ms": step_ms,
                    "seconds": wall, "history": hist, "finite": finite}

        def ready(cfg_):
            return ready_solver(cfg_)[0], cfg_.training.training_stages[0]

        try:
            # (i) microbatches 4 against 1 from the same initialisation (the
            # config's seed): the first gradient per tensor, then PAR_STEPS steps
            runs, grads = {}, {}
            for m in (4, 1):
                s, st = ready(flagship(microbatches=m))
                grads[m] = first_grads(s)
                runs[m] = run_timed(s, st, PAR_STEPS, PAR_TIMED, f"(i) flagship, microbatches {m}")
                del s
                torch.cuda.empty_cache()
            sizes_evm = layer_sizes(2, 1, 4, 40)
            g_main = worst_per_param(unflatten_params, grads[4][0], grads[1][0], sizes)
            g_evm = worst_per_param(unflatten_params, grads[4][1], grads[1][1], sizes_evm)
            last = lambda r: [r["history"][-1][k] for k in sorted(r["history"][-1])]
            m_rel = rel_sums(last(runs[4]), last(runs[1]))
            n_f_pad = pmesh.padded_size(N_F, 1, 4 * fr.ROW_ALIGN)
            none = dict.fromkeys(read_counts(), 0)
            want = lambda n: {**none, "fused_residual_fwd": n, "fused_residual_bwd": n}
            ok_p1 = (g_main[0] <= PAR_GRAD_TOL and g_evm[0] <= PAR_GRAD_TOL
                     and m_rel <= PAR_METRIC_TOL and runs[4]["finite"] and runs[1]["finite"]
                     and runs[4]["launches"] == want(4 * PAR_STEPS)
                     and runs[1]["launches"] == want(PAR_STEPS)
                     and runs[4]["rows"]["fused_residual_fwd"] == PAR_STEPS * n_f_pad
                     and runs[4]["peak_mib"] < runs[1]["peak_mib"])
            print(f"parallel (i): microbatches 4 vs 1, first gradient worst per tensor "
                  f"{g_main[0]:.3e} ({g_main[1]}) main, {g_evm[0]:.3e} ({g_evm[1]}) EVM "
                  f"(tolerance {PAR_GRAD_TOL:g}); metrics after {PAR_STEPS} steps max rel diff "
                  f"{m_rel:.3e} (tolerance {PAR_METRIC_TOL:g}); peak {runs[4]['peak_mib']:,.0f} "
                  f"vs {runs[1]['peak_mib']:,.0f} MiB; {runs[4]['step_ms']:.3f} vs "
                  f"{runs[1]['step_ms']:.3f} ms/step; ok {ok_p1}")
            par["micro4"] = {**runs[4], "grad_rel": g_main, "grad_rel_evm": g_evm,
                             "metrics_rel": m_rel}
            par["micro1"] = runs[1]
            par["ok_i"] = ok_p1

            # (ii) the scaling axis: N_f 1,200,000 over 10 microbatches
            s, st = ready(flagship(N_f=10 * N_F, microbatches=10))
            big = run_timed(s, st, PAR_BIG_STEPS, PAR_BIG_STEPS,
                            f"(ii) N_f {10 * N_F:,}, microbatches 10")
            del s
            torch.cuda.empty_cache()
            ok_p2 = (big["finite"] and big["launches"] == want(10 * PAR_BIG_STEPS)
                     and big["rows"]["fused_residual_fwd"] == PAR_BIG_STEPS * 10 * N_F)
            print(f"parallel (ii): {big['step_ms']:.3f} ms/step at N_f {10 * N_F:,} "
                  f"({big['step_ms'] / runs[4]['step_ms']:.2f}x (i)'s microbatched step), peak "
                  f"{big['peak_mib']:,.0f} MiB; ok {ok_p2}")
            par["big"] = big
            par["ok_ii"] = ok_p2

            # (iii) the driver under torchrun with NCCL: one process on the card
            path = write_config(par_dir, "configs/re2000_ev.yaml", "torchrun",
                                raw["training"]["training_stages"], evm_update_freq=10,
                                log_interval=10, checkpoint_freq=10**9,
                                enable_tensorboard=True,
                                tb_log_dir=os.path.join(par_dir, "tb"))
            out_json = os.path.join(par_dir, "torchrun.json")
            t0 = time.time()
            proc = subprocess.run(
                [sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc_per_node=1", "-m", "nsfnet_tpu_torch.tools.dist_worker", "train",
                 out_json, "--config", path], capture_output=True, text=True, timeout=300)
            tr_s = time.time() - t0
            got = json.load(open(out_json)) if os.path.exists(out_json) else {}
            finals = glob.glob(os.path.join(par_dir, "torchrun", "**", "model_final.ckpt"),
                               recursive=True)
            scalars = glob.glob(os.path.join(par_dir, "tb", "**", "scalars.jsonl"),
                                recursive=True)
            launches_tr = got.get("launches", {})
            ok_p3 = (proc.returncode == 0 and got.get("rc") == 0
                     and got.get("backend") == "nccl" and got.get("world") == 1
                     and len(finals) == 1 and len(scalars) == 1
                     and launches_tr == want(PAR_STEPS))
            print(f"parallel (iii): torch.distributed.run --standalone --nproc_per_node=1 -m "
                  f"nsfnet_tpu_torch.tools.dist_worker train (train.main): exit "
                  f"{proc.returncode}, backend {got.get('backend')}, world {got.get('world')}, "
                  f"checkpoint {finals}, scalars {len(scalars)}, launches {launches_tr}, "
                  f"{tr_s:.1f} s with start-up; ok {ok_p3}")
            if not ok_p3:
                print(proc.stdout[-3000:], proc.stderr[-6000:], sep="\n")
            par["torchrun"] = {"rc": proc.returncode, **got, "seconds": tr_s, "ok": ok_p3}
            par["ok_iii"] = ok_p3

            # (iv) two ranks on the one card over gloo, from (i)'s weights
            cfg1 = flagship(microbatches=1)
            s, _ = ready(cfg1)
            weights = os.path.join(par_dir, "weights.npz")
            np.savez(weights, params=s.state.params.detach().cpu().numpy(),
                     params_evm=s.state.params_evm.detach().cpu().numpy())
            del s
            spec = {"solver": {**train_mod.solver_kwargs(cfg1),
                               "checkpoint_path": os.path.join(par_dir, "ck")},
                    "data": train_mod.data_kwargs(cfg1), "device": "cuda", "backend": "gloo",
                    "weights": weights, "steps": PAR_DP_STEPS, "microbatches": [1],
                    "ckpt_dir": os.path.join(par_dir, "shared"), "continue_steps": 2}
            with open(os.path.join(par_dir, "spec.json"), "w") as f:
                json.dump(spec, f)
            sock = __import__("socket").socket()
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
            sock.close()
            outs = [os.path.join(par_dir, f"rank{r}.npz") for r in (0, 1)]
            procs = []
            t0 = time.time()
            for r in (0, 1):
                env = dict(os.environ, RANK=str(r), LOCAL_RANK="0", WORLD_SIZE="2",
                           MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "nsfnet_tpu_torch.tools.dist_worker", "dp",
                     os.path.join(par_dir, "spec.json"), outs[r]], env=env,
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            try:
                logs = [p.communicate(timeout=300)[0] for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            dp_s = time.time() - t0
            one = dist_worker.run_dp({**spec, "ckpt_dir": os.path.join(par_dir, "one")})
            done = all(p.returncode == 0 for p in procs) and all(os.path.exists(o) for o in outs)
            if not done:
                for log in logs:
                    print(log[-4000:])
            a, b = (dict(np.load(o)) for o in outs) if done else ({}, {})
            keys = sorted(k for k in a if "/" in k)
            bitwise = done and all(np.array_equal(a[k], b[k]) for k in keys)
            rel = lambda x, y: float(np.abs(x - y).max() / max(np.abs(y).max(), 1e-30))
            h_rel = rel(a["m1/history"], one["m1/history"]) if done else math.inf
            p_rel = rel(a["m1/params"], one["m1/params"]) if done else math.inf
            carry = torch.load(os.path.join(par_dir, "shared", "dist.ckpt"),
                               map_location="cpu", weights_only=True)["vis_t_minus"] \
                if done else None
            ok_p4 = bool(done and bitwise and str(a["backend"]) == "gloo" and int(a["world"]) == 2
                     and h_rel <= PAR_DP_METRIC_TOL and p_rel <= PAR_DP_PARAM_TOL
                     and list(a["m1/launches"]) == [PAR_DP_STEPS] * 2
                     and list(a["m1/rows"]) == [PAR_DP_STEPS * N_F // 2] * 2
                     and int(a["m1/other_launches"]) == 0
                     and tuple(carry.shape) == (N_F, 1)
                     and bool(a["reload/params_equal"]) and bool(b["reload/carry_equal"])
                     and np.isfinite(a["reload/history"]).all())
            print(f"parallel (iv): 2 ranks (gloo on CUDA tensors, one card) x {PAR_DP_STEPS} "
                  f"steps in {dp_s:.1f} s with start-up: bitwise equal across ranks {bitwise} "
                  f"({len(keys)} arrays); vs 1 process: metrics {h_rel:.3e} (tolerance "
                  f"{PAR_DP_METRIC_TOL:g}), params {p_rel:.3e} (tolerance {PAR_DP_PARAM_TOL:g}); "
                  f"kernels 1+2 per rank {a['m1/launches'].tolist() if done else None} launches "
                  f"on {a['m1/rows'].tolist() if done else None} rows; gathered carry "
                  f"{None if carry is None else tuple(carry.shape)}, reloaded on both ranks "
                  f"and 2 more steps; {float(a.get('m1_seconds', math.nan)):.3f} s for the "
                  f"{PAR_DP_STEPS} steps on rank 0 vs {float(one['m1_seconds']):.3f} s in one "
                  f"process; ok {ok_p4}")
            par["dp"] = {"bitwise": bitwise, "metrics_rel": h_rel, "params_rel": p_rel,
                         "launches": a.get("m1/launches", np.zeros(0)).tolist(),
                         "rows": a.get("m1/rows", np.zeros(0)).tolist(),
                         "seconds_rank0": float(a.get("m1_seconds", math.nan)),
                         "seconds_one": float(one["m1_seconds"]), "wall_s": dp_s, "ok": ok_p4}
            par["ok_iv"] = ok_p4
        finally:
            shutil.rmtree(par_dir, ignore_errors=True)
        par_s = time.time() - par_t0
        print(f"parallel phase: {par_s:.1f} s on the card")
        par["seconds"] = par_s
        record["parallel"] = par
        torch.cuda.empty_cache()
        return par

    par = run_parallel()
    ok_parallel = par["ok_i"] and par["ok_ii"] and par["ok_iii"] and par["ok_iv"]

    # ---- 4j. the tools: the native-sampler resume, the sweep, export, .pth,
    # --profile, the width refusal, the watchdog
    tools_ctx = {"card": card, "dev": dev, "reset_counts": reset_counts,
                 "read_counts": read_counts, "ready_solver": ready_solver}
    ok_tools_by, record["tools"] = phase_tools(torch, np, tools_ctx)
    ok_tools = all(ok_tools_by.values()) and len(ok_tools_by) == 7

    # ---- 4k. the capacity ladder's next rung, 6x352 from the committed h288
    # state, through kernels 1+2 on the streamed plan (this slice's path)
    ok_rung, record["rung"] = phase_rung(torch, np, tools_ctx)
    launches_rung = record["rung"]["runs"][0]["launches"]

    # ---- 4l. the measurement entry points: the matrix, the bench while the
    # watchdog trains (this slice's path)
    ok_measure_by, record["measure"] = phase_measure(torch, np, {**tools_ctx, "smi": smi})
    ok_measure = all(ok_measure_by.values()) and len(ok_measure_by) == 3

    # ---- 5. times
    kernels, work = [], {}

    def add_kernel(name, source, line, launched, ms_, plain_ms, err, rel, flops, nbytes, shape,
                   passes, keep=True):
        """One row: the bound at `passes` bf16 tensor-core products per fp32
        product (every kernel runs the name's passes), the fp32 bound beside it."""
        t_fp32, t_bytes = flops / FP32_PEAK, nbytes / HBM_RATE
        t_ops = passes * flops / BF16_PEAK
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": line,
            "launches": launched, "max_abs_err": err, "max_rel_err": rel, "ms": ms_,
            "plain_ms": plain_ms, "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "shape": shape}
        if keep:
            kernels.append(row)
        achieved = passes * flops / ms_ / 1e9
        print(f"time {name} [{shape}]: {ms_:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{1e3 * max(t_ops, t_bytes):.4f} ms ({passes} bf16 passes at "
              f"{BF16_PEAK / 1e12:g} TFLOP/s; fp32 bound {1e3 * t_fp32:.4f} ms; bytes "
              f"{1e3 * t_bytes:.4f} ms), {achieved:.1f} TFLOP/s achieved — {card}")
        # worked out from the shapes, not measured: kept out of the kernels line
        return {"flops": flops, "passes": passes, "bytes": nbytes,
                "bound_fp32_ms": 1e3 * t_fp32, "bound_tf32_ms": 1e3 * flops / TF32_PEAK,
                "bound_bf16_ms": 1e3 * flops / BF16_PEAK, "row": row}

    # kernels 1+2 at each name; the `kernels` line carries "high", the bench's
    # name, with the bench's launches (phase 4l (i)); kernels 5+6 carry the
    # matrix's sf/pallas row's launches (4l (ii))
    zero6 = dict.fromkeys(read_counts(), 0)
    launches_bench = {**zero6, **(record["measure"].get("bench", {}).get("launch_line", {})
                                  .get("launches") or {})}
    launches_matrix_sf = next((r["launches"] for r in record["measure"].get("matrix", {})
                               .get("rows", []) if r["config"] == "sf/pallas high"), zero6)
    flops, nbytes = fr.flop_counts(sizes, n), fr.byte_counts(sizes, n, True)
    src = "nsfnet_tpu_torch/csrc/fused_residual.cu"
    pair_times = {}
    for name in ("high", "highest", "default"):
        c = pair_chk[name]
        k1_ms = cuda_ms(torch, lambda: fr.fused_fwd(*args, 1.0, True, name), 20)
        k2_ms = cuda_ms(torch, lambda: fr.fused_bwd(*args, ct, 1.0, True, name), 20)
        with torch.no_grad():
            p1_ms = cuda_ms(torch, lambda: fr.plain_residual_sums(
                params, x, e, vis_t, eq_w, RE, 1.0, True, name), 5)
        sums_r, flat_r, e_r = graphs[name]
        p2_ms = cuda_ms(torch, lambda: torch.autograd.grad(
            sums_r, [flat_r, e_r], ct, retain_graph=True), 5)
        del graphs[name], sums_r
        shape = f"6x80, N={n}, EVM, {name!r}"
        bench = name == "high"
        launched = launches_bench if bench else launches
        w1 = add_kernel("fused_residual_fwd", src, "nsfnet_tpu/ops/pallas_residual.py:100",
                        launched["fused_residual_fwd"], k1_ms, p1_ms, c["fwd_abs"], c["fwd_rel"],
                        flops[0], nbytes[0], shape, fr.passes(name), keep=bench)
        w2 = add_kernel("fused_residual_bwd", src, "nsfnet_tpu/ops/pallas_residual.py:128",
                        launched["fused_residual_bwd"], k2_ms, p2_ms, c["bwd_abs"],
                        max(c["bwd_rel"], c["ge_rel"]), flops[1], nbytes[1], shape,
                        fr.passes(name), keep=bench)
        pair_times[name] = [w1.pop("row"), w2.pop("row")]
        work[f"fused_residual_fwd@{name}"], work[f"fused_residual_bwd@{name}"] = w1, w2
        torch.cuda.empty_cache()
    # kernels 1+2 at the 6x352 rung (streamed plan; the launches: phase 4k's
    # run), and at the resident rungs below it, timed in phase 3d
    for h in (RUNG_H, 224, 288):
        t = wide_times[f"pair/6x{h}"]
        sz_h = layer_sizes(2, 3, 6, h)
        flops, nbytes = fr.flop_counts(sz_h, n), fr.byte_counts(sz_h, n, True)
        shape = f"6x{h}, N={n}, EVM, 'high', plan {fr.Plan(*t['plan'])}"
        rung = h == RUNG_H
        launched = launches_rung if rung else dict.fromkeys(launches_rung, 0)
        w1 = add_kernel("fused_residual_fwd", src, "nsfnet_tpu/ops/pallas_residual.py:100",
                        launched["fused_residual_fwd"], t["k1_ms"], t["p1_ms"],
                        t.get("fwd_abs"), t.get("fwd_rel"), flops[0], nbytes[0], shape,
                        fr.passes("high"), keep=False)
        w2 = add_kernel("fused_residual_bwd", src, "nsfnet_tpu/ops/pallas_residual.py:128",
                        launched["fused_residual_bwd"], t["k2_ms"], t["p2_ms"],
                        t.get("bwd_abs"), max(t["bwd_rel"], t["ge_rel"]) if rung else None,
                        flops[1], nbytes[1], shape, fr.passes("high"), keep=False)
        pair_times[f"h{h}/high"] = [w1.pop("row"), w2.pop("row")]
        work[f"fused_residual_fwd@h{h}"], work[f"fused_residual_bwd@h{h}"] = w1, w2
    traffic = fr.bwd_traffic(layer_sizes(2, 3, 6, RUNG_H), n, "high")
    carries = fr.LOSS_BLOCKS * 4 * fr.carry_floats(16, RUNG_H, 3, fr.PARTS["high"])
    print(f"kernel 2 at 6x{RUNG_H} 'high' (from the shapes): tape written "
          f"{traffic['tape_written'] / 1e9:.3f} GB per launch, the streamed plan's carries "
          f"{carries / 1e6:.1f} MB in global memory ({fr.LOSS_BLOCKS} blocks)")
    work[f"fused_residual_bwd_traffic@h{RUNG_H}"] = {**traffic, "carry_bytes": carries}
    # kernels 1+2 at the per-launch shapes of phase 4i: a microbatch of the
    # flagship (N = 30,000, (i)) and a rank's block (N = 60,000, (iv)); (ii)'s
    # slices are the path's N = 120,000 above
    par_rows = []
    for n_sub, launched in ((N_F // 4, par["micro4"]["launches"]),
                            (N_F // 2, dict(zip(("fused_residual_fwd", "fused_residual_bwd"),
                                                par["dp"]["launches"] or [0, 0])))):
        sub = (flat, sizes, x[:n_sub], e[:n_sub], vis_t[:n_sub], eq_w[:n_sub], RE)
        k1_ms = cuda_ms(torch, lambda: fr.fused_fwd(*sub, 1.0, True, "high"), 20)
        k2_ms = cuda_ms(torch, lambda: fr.fused_bwd(*sub, ct, 1.0, True, "high"), 20)
        flat_r = flat.clone().requires_grad_(True)
        e_r = e[:n_sub].clone().requires_grad_(True)
        sums_r = fr.plain_residual_sums(unflatten_params(flat_r, sizes), x[:n_sub], e_r,
                                        vis_t[:n_sub], eq_w[:n_sub], RE, 1.0, True, "high")
        with torch.no_grad():
            p1_ms = cuda_ms(torch, lambda: fr.plain_residual_sums(
                params, x[:n_sub], e[:n_sub], vis_t[:n_sub], eq_w[:n_sub], RE, 1.0, True,
                "high"), 5)
        p2_ms = cuda_ms(torch, lambda: torch.autograd.grad(
            sums_r, [flat_r, e_r], ct, retain_graph=True), 5)
        del sums_r
        flops, nbytes = fr.flop_counts(sizes, n_sub), fr.byte_counts(sizes, n_sub, True)
        shape = f"6x80, N={n_sub}, EVM, 'high' (phase 4i)"
        for i, name in enumerate(("fused_residual_fwd", "fused_residual_bwd")):
            w = add_kernel(name, src, ("nsfnet_tpu/ops/pallas_residual.py:100",
                                       "nsfnet_tpu/ops/pallas_residual.py:128")[i],
                           launched[name], (k1_ms, k2_ms)[i], (p1_ms, p2_ms)[i], None, None,
                           flops[i], nbytes[i], shape, fr.passes("high"), keep=False)
            par_rows.append(w.pop("row"))
            work[f"{name}@N{n_sub}"] = w
        torch.cuda.empty_cache()
    # kernels 1+2 at the campaign width, timed in phase 3a' (the launches:
    # phase 4f (i)'s run)
    flops, nbytes = fr.flop_counts(sizes160, n), fr.byte_counts(sizes160, n, True)
    shape = f"6x160, N={n}, EVM, 'high', tile {c160['tile_panel'][0]}, panel {c160['tile_panel'][1]}"
    w1 = add_kernel("fused_residual_fwd", src, "nsfnet_tpu/ops/pallas_residual.py:100",
                    launches_campaign["fused_residual_fwd"], c160["k1_ms"], c160["p1_ms"],
                    c160["fwd_abs"], c160["fwd_rel"], flops[0], nbytes[0], shape,
                    fr.passes("high"), keep=False)
    w2 = add_kernel("fused_residual_bwd", src, "nsfnet_tpu/ops/pallas_residual.py:128",
                    launches_campaign["fused_residual_bwd"], c160["k2_ms"], c160["p2_ms"],
                    c160["bwd_abs"], max(c160["bwd_rel"], c160["ge_rel"]), flops[1], nbytes[1],
                    shape, fr.passes("high"), keep=False)
    pair_times["h160/high"] = [w1.pop("row"), w2.pop("row")]
    work["fused_residual_fwd@h160"], work["fused_residual_bwd@h160"] = w1, w2
    # kernels 1+2 at the reference v1 recipe's shape, checked and timed in
    # phase 3a'' (the launches: phase 4g (i)'s run)
    flops, nbytes = fr.flop_counts(sizes_v1, n_v1), fr.byte_counts(sizes_v1, n_v1, False)
    shape = (f"4x120, N={n_v1}, no EVM, 'high', tile {cv1['tile_panel'][0]}, panel "
             f"{cv1['tile_panel'][1]}")
    w1 = add_kernel("fused_residual_fwd", src, "nsfnet_tpu/ops/pallas_residual.py:100",
                    launches_polish["fused_residual_fwd"], cv1["k1_ms"], cv1["p1_ms"],
                    cv1["fwd_abs"], cv1["fwd_rel"], flops[0], nbytes[0], shape,
                    fr.passes("high"), keep=False)
    w2 = add_kernel("fused_residual_bwd", src, "nsfnet_tpu/ops/pallas_residual.py:128",
                    launches_polish["fused_residual_bwd"], cv1["k2_ms"], cv1["p2_ms"],
                    cv1["bwd_abs"], cv1["bwd_rel"], flops[1], nbytes[1], shape,
                    fr.passes("high"), keep=False)
    pair_times["v1_mse/high"] = [w1.pop("row"), w2.pop("row")]
    work["fused_residual_fwd@v1_mse"], work["fused_residual_bwd@v1_mse"] = w1, w2
    traffic = fr.bwd_traffic(sizes, n, "high")
    print("kernel 2 traffic per launch at 'high' (from the shapes): tape written "
          f"{traffic['tape_written'] / 1e9:.3f} GB, read {traffic['tape_read'] / 1e9:.3f} GB, "
          f"gradient partial read+written by the L2's reductions {traffic['partial_rmw'] / 1e9:.3f} "
          f"GB, split weights staged {traffic['weights_staged'] / 1e9:.3f} GB; the CUDA-core "
          f"design's scratch {traffic['cuda_core_scratch_written'] / 1e9:.3f} GB each way, "
          f"partial {traffic['cuda_core_partial_rmw'] / 1e9:.3f} GB")
    work["fused_residual_bwd_traffic"] = traffic

    # kernels 3+4: the `kernels` line carries the v1 path's shape at its name
    # "high"; the flagship width and the other names are timed beside them
    src = "nsfnet_tpu_torch/csrc/mlp_streams.cu"
    stream_times = {}
    for name, (fl, sz, xx) in stream_cases.items():
        cts, c = stream_cts[name], stream_chk[name]
        main = name == "4x120"
        flops, nbytes = ms.flop_counts(sz, xx.shape[0]), ms.byte_counts(sz, xx.shape[0])
        shape = f"{name}, N={xx.shape[0]}"
        rows = []
        for prec in ("high", "highest", "default"):
            f = c["fwd"][prec]
            tile, panel = ms.pick_bwd_tile(sz[1], prec)
            k3_ms = cuda_ms(torch, lambda: ms.streams_fwd(fl, sz, xx, prec), 20)
            with torch.no_grad():
                p3_ms = cuda_ms(torch, lambda: ms.plain_mlp_streams(fl, sz, xx, prec), 10)
            w3 = add_kernel("mlp_streams_fwd", src, "nsfnet_tpu/ops/pallas_mlp.py:183",
                            launches_v1["mlp_streams_fwd"], k3_ms, p3_ms, f["abs"], f["rel"],
                            flops[0], nbytes[0], f"{shape}, {prec!r}, tile {tile}, panel {panel}",
                            fr.passes(prec), keep=main and prec == "high")
            rows.append(w3.pop("row"))
            work[f"mlp_streams_fwd@{name}/{prec}"] = w3
        for prec in ("high", "highest", "default"):
            b = c["bwd"][prec]
            k4_ms = cuda_ms(torch, lambda: ms.streams_bwd(fl, sz, xx, cts, prec), 10)
            # the plain backward is the whole function: forward graph + autograd, same passes
            p4_ms = cuda_ms(torch, lambda: ms.plain_mlp_streams_bwd(fl, sz, xx, cts, prec), 5)
            w4 = add_kernel("mlp_streams_bwd", src, "nsfnet_tpu/ops/pallas_mlp.py:313",
                            launches_v1["mlp_streams_bwd"], k4_ms, p4_ms, b["abs"], b["rel"],
                            flops[1], nbytes[1],
                            f"{shape}, {prec!r}", fr.passes(prec), keep=main and prec == "high")
            rows.append(w4.pop("row"))
            work[f"mlp_streams_bwd@{name}/{prec}"] = w4
        stream_times[name] = rows
        torch.cuda.empty_cache()
    # kernels 3+4 at 4x352 (streamed plan), checked and timed in phase 3d
    t = wide_times[f"streams/4x{RUNG_H}"]
    sz_h = layer_sizes(2, 3, 4, RUNG_H)
    flops, nbytes = ms.flop_counts(sz_h, t["n"]), ms.byte_counts(sz_h, t["n"])
    shape = f"4x{RUNG_H}, N={t['n']}, 'high', plan {fr.Plan(*t['plan'])}"
    w3 = add_kernel("mlp_streams_fwd", src, "nsfnet_tpu/ops/pallas_mlp.py:183", 0, t["k3_ms"],
                    t["p3_ms"], t["fwd"]["abs"], t["fwd"]["rel"], flops[0], nbytes[0], shape,
                    fr.passes("high"), keep=False)
    w4 = add_kernel("mlp_streams_bwd", src, "nsfnet_tpu/ops/pallas_mlp.py:313", 0, t["k4_ms"],
                    t["p4_ms"], t["bwd"]["abs"], t["bwd"]["rel"], flops[1], nbytes[1], shape,
                    fr.passes("high"), keep=False)
    stream_times[f"4x{RUNG_H}"] = [w3.pop("row"), w4.pop("row")]
    work[f"mlp_streams_fwd@4x{RUNG_H}"], work[f"mlp_streams_bwd@4x{RUNG_H}"] = w3, w4

    # kernels 5+6: the `kernels` line carries the streamfunction path's shape
    # at its name "high"
    src = "nsfnet_tpu_torch/csrc/psi_streams.cu"
    psi_times = {}
    for name, (fl, sz, xx) in psi_cases.items():
        cts, c = psi_cts[name], psi_chk[name]
        main = name == "6x80"
        flops, nbytes = psi.flop_counts(sz, xx.shape[0]), psi.byte_counts(sz, xx.shape[0])
        shape = f"{name} K=2, N={xx.shape[0]}"
        rows = []
        for prec in ("high", "highest", "default"):
            f = c["fwd"][prec]
            tile, panel = psi.pick_bwd_tile(sz[1], prec)
            k5_ms = cuda_ms(torch, lambda: psi.psi_fwd(fl, sz, xx, prec), 10)
            with torch.no_grad():
                p5_ms = cuda_ms(torch, lambda: psi.plain_psi_streams(fl, sz, xx, prec), 5)
            launched = launches_matrix_sf if main else launches_sf
            w5 = add_kernel("psi_streams_fwd", src, "nsfnet_tpu/ops/pallas_psi.py:176",
                            launched["psi_streams_fwd"], k5_ms, p5_ms, f["abs"],
                            max(f["rel"], f["bundle_rel"]), flops[0], nbytes[0],
                            f"{shape}, {prec!r}, tile {tile}, panel {panel}", fr.passes(prec),
                            keep=main and prec == "high")
            rows.append(w5.pop("row"))
            work[f"psi_streams_fwd@{name}/{prec}"] = w5
            torch.cuda.empty_cache()
        for prec in ("high", "highest", "default"):
            b1, b2 = c["bwd"][f"{prec}/all13"], c["bwd"][f"{prec}/zero34"]
            tile, panel = psi.pick_bwd_tile(sz[1], prec)
            k6_ms = cuda_ms(torch, lambda: psi.psi_bwd(fl, sz, xx, cts, prec), 5)
            # the plain backward is the whole function: forward graph + autograd, same passes
            p6_ms = cuda_ms(torch, lambda: psi.plain_psi_streams_bwd(fl, sz, xx, cts, prec), 3)
            launched = launches_matrix_sf if main else launches_sf
            w6 = add_kernel("psi_streams_bwd", src, "nsfnet_tpu/ops/pallas_psi.py:223",
                            launched["psi_streams_bwd"], k6_ms, p6_ms,
                            max(b1["abs"], b2["abs"]),
                            max(b1["rel"], b2["rel"]), flops[1], nbytes[1],
                            f"{shape}, {prec!r}, tile {tile}, panel {panel}", fr.passes(prec),
                            keep=main and prec == "high")
            rows.append(w6.pop("row"))
            work[f"psi_streams_bwd@{name}/{prec}"] = w6
            torch.cuda.empty_cache()
        psi_times[name] = rows
    # kernels 5+6 at 6x224 (streamed plan), checked and timed in phase 3d
    t = wide_times["psi/6x224"]
    sz_h = layer_sizes(2, 2, 6, 224)
    flops, nbytes = psi.flop_counts(sz_h, t["n"]), psi.byte_counts(sz_h, t["n"])
    shape = f"6x224 K=2, N={t['n']}, 'high', plan {fr.Plan(*t['plan'])}"
    w5 = add_kernel("psi_streams_fwd", src, "nsfnet_tpu/ops/pallas_psi.py:176", 0, t["k5_ms"],
                    t["p5_ms"], t["fwd"]["abs"], max(t["fwd"]["rel"], t["fwd"]["bundle_rel"]),
                    flops[0], nbytes[0], shape, fr.passes("high"), keep=False)
    w6 = add_kernel("psi_streams_bwd", src, "nsfnet_tpu/ops/pallas_psi.py:223", 0, t["k6_ms"],
                    t["p6_ms"], t["bwd"]["abs"], t["bwd"]["rel"], flops[1], nbytes[1], shape,
                    fr.passes("high"), keep=False)
    psi_times["6x224"] = [w5.pop("row"), w6.pop("row")]
    work["psi_streams_fwd@6x224"], work["psi_streams_bwd@6x224"] = w5, w6
    traffic6 = psi.bwd_traffic(sizes_sf, n, "high")
    print("kernel 6 traffic per launch at 'high', 6x80 (from the shapes): tape written "
          f"{traffic6['tape_written'] / 1e9:.3f} GB, read {traffic6['tape_read'] / 1e9:.3f} GB, "
          f"gradient partial read+written by the L2's reductions {traffic6['partial_rmw'] / 1e9:.3f} "
          f"GB; the CUDA-core design's scratch {traffic6['cuda_core_scratch_written'] / 1e9:.3f} GB "
          "each way")
    work["psi_streams_bwd_traffic"] = traffic6

    def time_steps(s, what, n_f):
        s.run_steps(5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.run_steps(TIMED_STEPS)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        step_ms, pts_s = 1e3 * dt / TIMED_STEPS, TIMED_STEPS * (n_f + N_B) / dt
        print(f"time {what} step: {step_ms:.3f} ms/step, {pts_s:,.0f} collocation points/s "
              f"(N_f {n_f:,} + {N_B:,} boundary, {TIMED_STEPS} steps) — {card}")
        return step_ms, pts_s

    step_ms, pts_s = time_steps(solver, "slice (flagship ev-NSFnet, kernels 1+2)", N_F)
    bench_ms = record["measure"].get("bench", {}).get("line", {}).get("step_ms")
    if bench_ms:
        print(f"bench (4l (i)) {bench_ms:.3f} ms/step, the best of three {BENCH_STEPS}-step "
              f"chunks, against this {TIMED_STEPS}-step window's {step_ms:.3f} "
              f"({100 * (bench_ms / step_ms - 1):+.1f}%) — {card}")
    v1_ms, v1_pts = time_steps(solver_v1, "slice (v1 NSFnet L2, kernels 3+4)", N_F_V1)
    sf_ms, sf_pts = time_steps(solver_sf, "slice (streamfunction ev-NSFnet, kernels 5+6)", N_F)
    camp_ms, camp_pts = time_steps(solver_c, "campaign (re4000_r4b 6x160 ev-NSFnet, kernels 1+2)",
                                   N_F)
    record["times"] = {"kernels": kernels, "pair_by_precision": pair_times,
                       "pair_phase_4i": par_rows,
                       "streams_by_width": stream_times,
                       "psi_by_width": psi_times, "work": work,
                       "step_ms": step_ms, "points_per_s": pts_s,
                       "v1_step_ms": v1_ms, "v1_points_per_s": v1_pts,
                       "sf_step_ms": sf_ms, "sf_points_per_s": sf_pts,
                       "campaign_step_ms": camp_ms, "campaign_points_per_s": camp_pts,
                       "peak_mem_mb": torch.cuda.max_memory_allocated(dev) / 2**20}
    record["profile"] = profile_steps(torch, lambda: solver.run_steps(5), card, "flagship step")
    record["profile_v1"] = profile_steps(torch, lambda: solver_v1.run_steps(5), card,
                                         "v1 L2 step")
    record["profile_sf"] = profile_steps(torch, lambda: solver_sf.run_steps(5), card,
                                         "streamfunction step")
    record["profile_campaign"] = profile_steps(torch, lambda: solver_c.run_steps(5), card,
                                               "campaign 6x160 step")
    # the host side of each launch's weight split: its workspace allocation
    lib, reps = ms._lib(), 1000
    t0 = time.perf_counter()
    for _ in range(reps):
        ms._weight_split(lib, sizes_v1, fr.PARTS["high"], dev)
    alloc_us = 1e6 * (time.perf_counter() - t0) / reps
    print(f"split workspace allocation (host, caching allocator): {alloc_us:.2f} us per launch")
    record["split_alloc_us"] = alloc_us

    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        # numpy scalars (the dist worker's arrays) as Python numbers
        json.dump(record, f, indent=1,
                  default=lambda o: o.item() if hasattr(o, "item") else repr(o))

    if not (ok_check and ok_slice and ok_v1 and ok_sf and ok_small and ok_unfused
            and ok_engine and ok_campaign and ok_polish and ok_other and ok_parallel
            and ok_tools and ok_rung and ok_measure):
        print(f"chip_smoke: FAILED (kernel check {ok_check}, flagship slice {ok_slice}, "
              f"v1 L2 slice {ok_v1}, streamfunction slice {ok_sf}, small-input reference "
              f"{ok_small}, unfused vs fused {ok_unfused}, kernel engine vs closed form "
              f"{ok_engine}, campaign resume / SIGTERM / init-from {ok_i} / {ok_ii} / "
              f"{ok_iii}, polish v1 L-BFGS / h288 LM / small inputs {ok_p1} / {ok_p2} / "
              f"{ok_p3}, backbones kan_cavity / KAN state / KAN step / Fourier / generic "
              f"engines / LM {ok_o1} / {ok_o2} / {ok_o3} / {ok_o4} / {ok_o5} / {ok_o6}, "
              f"parallel microbatched / N_f 1.2M / torchrun NCCL / 2 ranks {par['ok_i']} / "
              f"{par['ok_ii']} / {par['ok_iii']} / {par['ok_iv']}, tools (i)-(vii) "
              f"{ok_tools_by}, the 6x{RUNG_H} rung {ok_rung}, the measurement entry points "
              f"(i)-(iii) {ok_measure_by})",
              file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
