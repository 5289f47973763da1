#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nsfnet_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. the card: torch's name and nvidia-smi's name / power limit;
  2. build every CUDA kernel from nsfnet_tpu_torch/csrc with nvcc, and show
     ptxas's registers / shared memory / spills;
  3. hold each kernel against its plain PyTorch version on the card at the
     flagship width (6x80 MLP, N_f = 120,000 SDF-weighted points, EVM on,
     Re = 2000), and check that two runs are bitwise equal;
  4. the slice: the flagship ev-NSFnet config through ConfigManager.from_dict
     -> PINNSolver on cuda -> 30 Adam steps with the EVM gate firing; the
     metrics must be finite and the loss must fall, and every kernel must
     have been launched by that run; then the same solver code on cuda and
     on the CPU from the same seed must agree on a small input;
  5. times: each kernel, its plain version and its bound, and the step time
     and collocation points/s of the slice, beside the card's name and
     power limit.
Prints a `kernels` JSON line, then, last, the device JSON line. Also writes
everything to chiprun_out/chip_smoke.json.
"""

import json
import math
import os
import subprocess
import sys
import time

FP32_PEAK = 67e12      # H100 SXM, fp32 outside the tensor cores (FLOP/s)
TF32_PEAK = 495e12     # dense tensor-core rates
BF16_PEAK = 989e12
HBM_RATE = 3.35e12     # bytes/s

RE = 2000.0
N_F = 120_000
SLICE_STEPS = 30
FWD_TOL = 1e-4   # max relative difference of each loss sum
BWD_TOL = 1e-4   # max |diff| / max |plain| of each gradient tensor and of g_e
SMALL_TOL = 1e-3  # cuda vs CPU solver on a small input, per logged metric

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


def profile_steps(torch, solver, card, n_steps=5):
    """Device time by kernel over a few slice steps (torch.profiler), and the
    share of the window's wall time the device was busy."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.run_steps(n_steps)
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
        print("profile: no device time in the trace (not measured)")
        return None
    print(f"profile ({n_steps} steps, under the profiler): {wall_ms / n_steps:.3f} ms/step "
          f"wall, device busy {busy:.3f} ms/step ({100 * busy * n_steps / wall_ms:.1f}%) "
          f"— {card}")
    for name, ms in rows[:10]:
        print(f"  {ms:9.4f} ms/step  {name[:90]}")
    return {"wall_ms_per_step": wall_ms / n_steps, "busy_ms_per_step": busy,
            "top": rows[:20]}


def rel_sums(a, b):
    return max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1

    from nsfnet_tpu_torch.config import ConfigManager
    from nsfnet_tpu_torch.models.mlp import (flatten_params, init_mlp, layer_sizes,
                                             unflatten_params)
    from nsfnet_tpu_torch.ops import _build
    from nsfnet_tpu_torch.ops import fused_residual as fr
    from nsfnet_tpu_torch.train import build_data, build_solver

    record = {}
    dev = torch.device("cuda", 0)

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
    tile = fr.pick_tile(80)
    c_smem = fr._lib().nsf_fused_loss_smem_bytes(tile, 80, 3)
    assert c_smem == fr.smem_bytes(tile, 80), (c_smem, fr.smem_bytes(tile, 80))
    print(f"tile {tile} points, {c_smem} B shared memory per block, "
          f"{fr.PARTIAL_BLOCKS} blocks")

    # ---- 3. kernel check at full width
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data = build_data(ConfigManager.from_dict(FLAGSHIP).config)
    data.boundary_data()
    xf, yf = data.training_data()
    n = -(-N_F // fr.ROW_ALIGN) * fr.ROW_ALIGN
    pad = n - N_F
    x = torch.zeros((n, 2))
    x[:N_F, 0], x[:N_F, 1] = torch.from_numpy(xf[:, 0]), torch.from_numpy(yf[:, 0])
    eq_w = torch.zeros((n, 1))
    eq_w[:N_F] = torch.from_numpy(data.sdf_weights.reshape(-1, 1))
    gen = torch.Generator().manual_seed(0)
    flat = flatten_params(init_mlp(sizes, gen))
    e = 0.05 * torch.randn((n, 1), generator=gen)
    vis_t = torch.clamp(0.05 * torch.randn((n, 1), generator=gen).abs(), max=20.0 / RE)
    x, eq_w, flat, e, vis_t = (t.to(dev).contiguous() for t in (x, eq_w, flat, e, vis_t))
    ct = torch.tensor([1.0, 1.0, 1.0, 0.1], device=dev) / N_F
    args = (flat, sizes, x, e, vis_t, eq_w, RE)

    sums_k = fr.fused_fwd(*args, 1.0, True)
    sums_k2 = fr.fused_fwd(*args, 1.0, True)
    params = unflatten_params(flat, sizes)
    with torch.no_grad():
        sums_p = fr.plain_residual_sums(params, x, e, vis_t, eq_w, RE, 1.0, True)
    torch.cuda.synchronize()
    fwd_rel = rel_sums(sums_k.tolist(), sums_p.tolist())
    fwd_abs = (sums_k - sums_p).abs().max().item()
    fwd_det = torch.equal(sums_k, sums_k2)
    print(f"kernel fused_residual_fwd: sums {sums_k.tolist()} plain {sums_p.tolist()}")
    print(f"  max rel diff {fwd_rel:.3e} (tolerance {FWD_TOL:g}), max abs {fwd_abs:.3e}, "
          f"bitwise equal across runs: {fwd_det}")

    dflat_k, ge_k = fr.fused_bwd(*args, ct, 1.0, True)
    dflat_k2, ge_k2 = fr.fused_bwd(*args, ct, 1.0, True)
    flat_r = flat.clone().requires_grad_(True)
    e_r = e.clone().requires_grad_(True)
    sums_r = fr.plain_residual_sums(unflatten_params(flat_r, sizes), x, e_r, vis_t, eq_w,
                                    RE, 1.0, True)
    dflat_p, ge_p = torch.autograd.grad(sums_r, [flat_r, e_r], ct, retain_graph=True)
    torch.cuda.synchronize()
    bwd_rel, off = 0.0, 0
    for w, b in params:
        for t in (w, b):
            a, r = dflat_k[off:off + t.numel()], dflat_p[off:off + t.numel()]
            bwd_rel = max(bwd_rel, ((a - r).abs().max() / r.abs().max()).item())
            off += t.numel()
    ge_rel = ((ge_k - ge_p).abs().max() / ge_p.abs().max()).item()
    bwd_abs = max((dflat_k - dflat_p).abs().max().item(), (ge_k - ge_p).abs().max().item())
    bwd_det = torch.equal(dflat_k, dflat_k2) and torch.equal(ge_k, ge_k2)
    print(f"kernel fused_residual_bwd: max rel diff dW/db {bwd_rel:.3e}, g_e {ge_rel:.3e} "
          f"(tolerance {BWD_TOL:g}, per tensor max|diff|/max|plain|), max abs {bwd_abs:.3e}, "
          f"bitwise equal across runs: {bwd_det}")
    record["check"] = {"fwd_rel": fwd_rel, "fwd_abs": fwd_abs, "fwd_det": fwd_det,
                       "bwd_rel": bwd_rel, "ge_rel": ge_rel, "bwd_abs": bwd_abs,
                       "bwd_det": bwd_det, "n": n, "pad": pad}
    ok_check = (fwd_rel <= FWD_TOL and bwd_rel <= BWD_TOL and ge_rel <= BWD_TOL
                and fwd_det and bwd_det)

    # ---- 4. the slice, through the port's entry points
    cfg = ConfigManager.from_dict(FLAGSHIP).config
    solver = build_solver(cfg, device="cuda")
    sdata = build_data(cfg)
    solver.set_boundary_data(X=sdata.boundary_data())
    solver.set_eq_training_data(X=sdata.training_data(), weights=sdata.sdf_weights)
    solver.set_coordinate_transform(sdata.coord_scale)
    st = cfg.training.training_stages[0]
    solver.set_alpha_evm(st.alpha)
    fr.reset_launch_counts()
    t0 = time.time()
    solver.train(num_epoch=st.epochs, lr=st.lr)
    torch.cuda.synchronize()
    slice_s = time.time() - t0
    launches = dict(fr.launch_counts)
    hist = [(s, m._asdict()) for s, m in solver.loss_history]
    finite = all(math.isfinite(v) for _, m in hist for v in m.values())
    first, last = hist[0][1]["total"], hist[-1][1]["total"]
    u, v, p_, e_pred = solver.predict((sdata.boundary_data()[0][:1000],
                                       sdata.boundary_data()[1][:1000]))
    pred_ok = all(t.shape == (1000, 1) and torch.isfinite(t).all().item()
                  for t in (u, v, p_, e_pred))
    print(f"slice: {st.epochs} Adam steps in {slice_s:.2f} s (first step builds), "
          f"launches {launches}")
    for s, m in hist:
        print(f"  step {s}: " + " ".join(f"{k}={val:.4e}" for k, val in m.items()))
    print(f"  finite {finite}, total loss {first:.4e} -> {last:.4e}, predict ok {pred_ok}")
    record["slice"] = {"history": hist, "launches": launches, "seconds": slice_s}
    ok_slice = (finite and last < first and pred_ok
                and all(launches[k] > 0 for k in launches))

    # ---- 4b. the same solver code on cuda and on the CPU, small input
    small = json.loads(json.dumps(FLAGSHIP))
    small["training"].update(N_f=512, log_interval=1, evm_update_freq=2)
    scfg = ConfigManager.from_dict(small).config
    runs = {}
    for where in ("cuda", "cpu"):
        s = build_solver(scfg, device=where)
        d = build_data(scfg)
        s.set_boundary_data(X=d.boundary_data())
        s.set_eq_training_data(X=d.training_data(), weights=d.sdf_weights)
        s.set_alpha_evm(0.05)
        s.train(num_epoch=3, lr=1e-3)
        runs[where] = [m for _, m in s.loss_history]
    small_rel = max(abs(a - b) / max(abs(b), 1e-30)
                    for ma, mb in zip(runs["cuda"], runs["cpu"])
                    for a, b in zip(ma, mb) if b != 0.0)
    print(f"small input (6x80, N_f=512, 3 steps): cuda vs CPU max rel diff of the "
          f"metrics {small_rel:.3e} (tolerance {SMALL_TOL:g})")
    record["small_rel"] = small_rel
    ok_small = small_rel <= SMALL_TOL

    # ---- 5. times
    k1_ms = cuda_ms(torch, lambda: fr.fused_fwd(*args, 1.0, True), 20)
    k2_ms = cuda_ms(torch, lambda: fr.fused_bwd(*args, ct, 1.0, True), 10)
    with torch.no_grad():
        p1_ms = cuda_ms(torch, lambda: fr.plain_residual_sums(
            params, x, e, vis_t, eq_w, RE, 1.0, True), 10)
    p2_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        sums_r, [flat_r, e_r], ct, retain_graph=True), 10)
    flops = fr.flop_counts(sizes, n)
    nbytes = fr.byte_counts(sizes, n, True)
    kernels, work = [], {}
    for i, (name, line, ms, plain_ms, err, rel) in enumerate([
            ("fused_residual_fwd", "nsfnet_tpu/ops/pallas_residual.py:100", k1_ms, p1_ms,
             fwd_abs, fwd_rel),
            ("fused_residual_bwd", "nsfnet_tpu/ops/pallas_residual.py:128", k2_ms, p2_ms,
             bwd_abs, max(bwd_rel, ge_rel))]):
        t_ops, t_bytes = flops[i] / FP32_PEAK, nbytes[i] / HBM_RATE
        kernels.append({
            "name": name, "route": "cuda", "source": "nsfnet_tpu_torch/csrc/fused_residual.cu",
            "replaces": line, "launches": launches[name], "max_abs_err": err,
            "max_rel_err": rel, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None})
        # worked out from the shapes, not measured: kept out of the kernels line
        work[name] = {"flops": flops[i], "bytes": nbytes[i],
                      "bound_tf32_ms": 1e3 * flops[i] / TF32_PEAK,
                      "bound_bf16_ms": 1e3 * flops[i] / BF16_PEAK}
        print(f"time {name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {1e3 * t_ops:.4f} ms "
              f"(fp32 {FP32_PEAK / 1e12:g} TFLOP/s; TF32 {1e3 * flops[i] / TF32_PEAK:.4f} ms, "
              f"bf16 {1e3 * flops[i] / BF16_PEAK:.4f} ms), {flops[i] / ms / 1e9:.1f} "
              f"TFLOP/s achieved — {card}")

    solver.run_steps(5)
    torch.cuda.synchronize()
    n_steps = 50
    t0 = time.perf_counter()
    solver.run_steps(n_steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    step_ms = 1e3 * dt / n_steps
    pts_s = n_steps * (N_F + 4 * 513) / dt
    print(f"time slice step: {step_ms:.3f} ms/step, {pts_s:,.0f} collocation points/s "
          f"(N_f {N_F:,} + 2,052 boundary, {n_steps} steps) — {card}")
    record["times"] = {"kernels": kernels, "work": work, "step_ms": step_ms,
                       "points_per_s": pts_s,
                       "peak_mem_mb": torch.cuda.max_memory_allocated(dev) / 2**20}
    record["profile"] = profile_steps(torch, solver, card)

    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)

    if not (ok_check and ok_slice and ok_small):
        print(f"chip_smoke: FAILED (kernel check {ok_check}, slice {ok_slice}, "
              f"small-input reference {ok_small})", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
