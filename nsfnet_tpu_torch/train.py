"""Training driver (port of nsfnet_tpu/train.py; parity with
ev-NSFnet/train.py:74-224).

Usage:
    python -m nsfnet_tpu_torch.train --config configs/re2000_ev.yaml [--dry-run] [--cpu]
        [--resume CKPT | --init-from CKPT]
    torchrun --nproc_per_node=N -m nsfnet_tpu_torch.train --config ... [--cpu]

Flow: config -> solver -> data -> staged Adam loop with per-stage evaluate
-> final checkpoint. A long campaign runs as the JAX driver's does:
  * `--resume CKPT` continues a full-state checkpoint, the port's or the
    JAX package's: the sampler state in its sidecar replays the writer's
    collocation points, stages the restored step has covered are skipped,
    and the stage it stopped in goes on from its restored epoch;
  * `--init-from CKPT` warm-starts from a finished run's networks only
    (fresh optimizer, schedule from step 0), widened function-preservingly
    (Net2Net) where the config is wider than the donor;
  * `resample_each_stage` draws fresh points at each stage start, residual-
    aware (RAR) where `rar_pool_mult` > 0 (`rar_schedule`: first | every);
  * a stage's `optimizer` is adam, or lbfgs / lm for a second-order polish
    stage; only an Adam stage resumes mid-stage (a resume inside a polish
    stage runs its remaining steps afresh);
  * `supervision` samples DNS points with the run's seed, and
    `adaptive_bc_weight` balances the boundary weight by gradient norms;
  * SIGTERM stops at a chunk boundary, writes `sigterm_step<N>.ckpt` and
    exits with code 3, for a later `--resume`;
  * a device error rolls back to the stage's last checkpoint (solver.train).
With `training.enable_tensorboard` (the default) the logged scalars go to
`<tb_log_dir>/<experiment>_<timestamp>/scalars.jsonl` (and to TensorBoard
where it is installed); every checkpoint gets `eq_losses.mat` beside it.
Every backbone runs: the MLP, the Fourier-embedded MLP and the KAN
(`model_variant: kan`, e.g. configs/kan_cavity.yaml). Runs on the CUDA card;
`--cpu` runs on the CPU, and without a card and without `--cpu` it raises.
`training.microbatches` accumulates each step's gradient over that many
collocation slices. Under torchrun (or another launcher's world size > 1)
the driver first joins the process group (parallel/mesh.py: NCCL on
`cuda:LOCAL_RANK`, gloo under `--cpu`; a detected launch that cannot join
raises), and each rank trains on its block of the points; rank 0 alone
logs to the console and writes the scalars and checkpoints, and a SIGTERM
then exits 3 without the collective save (resume from the newest cadence
checkpoint). `training.mesh_devices` must equal the number of processes.
`--profile DIR` records a torch.profiler trace of the first stage into DIR
(utils/profiling.py). Settings this port cannot honour are refused in
`unsupported()` rather than ignored, before any data is built. The kernels
take every width (a net too wide for a block's shared memory streams its
carries through it: ops/fused_residual.loss_plan, ops/psi_streams.psi_plan).
The JAX package's startup keepalive
(which guards remote TPU compiles) has no counterpart: nothing compiles at
start-up here.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import os
import signal
import time

import numpy as np
import torch
import torch.distributed as dist

from nsfnet_tpu_torch.config import ConfigManager
from nsfnet_tpu_torch.data.cavity import CavityData
from nsfnet_tpu_torch.logger import get_logger
from nsfnet_tpu_torch.models.mlp import widen_mlp_params
from nsfnet_tpu_torch.parallel.mesh import initialize_distributed
from nsfnet_tpu_torch.training import checkpoint as ckpt
from nsfnet_tpu_torch.training.solver import PINNSolver
from nsfnet_tpu_torch.utils.profiling import torch_trace
from nsfnet_tpu_torch.utils.tensorboard import ScalarWriter


class GracefulStop(Exception):
    """Raised by the SIGTERM handler. The solver masks SIGTERM across each
    chunk of steps and its step count, so this lands at a chunk boundary;
    the driver checkpoints the state and exits with code 3."""


def _on_sigterm(signum, frame):
    raise GracefulStop()


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="NSFnet PyTorch/CUDA training")
    p.add_argument("--config", type=str, default="configs/re5000_production.yaml")
    p.add_argument("--dry-run", action="store_true",
                   help="print config & stages then exit (ev-NSFnet/train.py:18)")
    p.add_argument("--resume", type=str, default=None,
                   help="full-state checkpoint (this package's or the JAX package's) "
                        "to resume from")
    p.add_argument("--init-from", type=str, default=None,
                   help="warm start: the network params only from this checkpoint "
                        "(fresh optimizer, schedule from step 0), widened "
                        "function-preservingly where the config is wider")
    p.add_argument("--profile", type=str, default=None,
                   help="record a torch.profiler trace of the first stage into this "
                        "directory (Chrome trace format)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the CUDA card")
    return p.parse_args(argv)


def unsupported(cfg, world_size: int = 1) -> list:
    """Config settings this port cannot honour in a run of `world_size`
    processes."""
    t = cfg.training
    out = []
    if cfg.model_variant not in ("nsfnet", "ev-nsfnet", "kan"):
        out.append(f"model_variant {cfg.model_variant!r}")
    if t.mesh_devices is not None and t.mesh_devices != world_size:
        out.append(f"mesh_devices {t.mesh_devices} in a run of {world_size} process(es) "
                   f"(one process per card: torchrun --nproc_per_node={t.mesh_devices})")
    if t.loss_mode == "L2" and (t.microbatches > 1 or world_size > 1):
        # an L2 norm is not a sum of per-slice or per-rank parts (the JAX solver refuses it too)
        out.append("loss_mode L2 with microbatches or several processes")
    if world_size > 1 and t.seed is None:
        out.append("seed: null over several processes (each would draw its own points)")
    if t.loss_mode != "MSE" and any(st.optimizer == "lm" for st in t.training_stages):
        out.append(f"an lm stage under loss_mode {t.loss_mode!r} (LM minimises the MSE loss)")
    return out


def build_solver(cfg, device=None) -> PINNSolver:
    """The solver of a config (nsfnet_tpu/train.py:77-117): `model_variant:
    kan` is the KAN backbone without the EVM net."""
    return PINNSolver(**solver_kwargs(cfg), device=device)


def solver_kwargs(cfg) -> dict:
    """PINNSolver's keyword arguments for a config (no device)."""
    variant = cfg.model_variant
    return dict(
        Re=cfg.physics.Re,
        layers=cfg.network.layers,
        layers_1=cfg.network.layers_1 if variant == "ev-nsfnet" else None,
        hidden_size=cfg.network.hidden_size,
        hidden_size_1=cfg.network.hidden_size_1,
        N_f=cfg.training.N_f,
        alpha_evm=cfg.physics.alpha_evm,
        bc_weight=cfg.physics.bc_weight,
        eq_weight=cfg.physics.eq_weight,
        supervised_data_weight=(cfg.supervision.loss_weight
                                if cfg.supervision.enabled else 0.0),
        entropy_residual_weight=cfg.physics.entropy_residual_weight,
        evm=(variant == "ev-nsfnet"),
        backbone=cfg.network.backbone if variant != "kan" else "kan",
        kan_width=tuple(cfg.network.kan_width),
        kan_grid=cfg.network.kan_grid,
        kan_k=cfg.network.kan_k,
        fourier_features=cfg.network.fourier_features,
        fourier_sigma=cfg.network.fourier_sigma,
        seed=cfg.training.seed,
        matmul_precision=cfg.training.matmul_precision,
        evm_update_freq=cfg.training.evm_update_freq,
        log_interval=cfg.training.log_interval,
        checkpoint_freq=cfg.training.checkpoint_freq,
        checkpoint_path=cfg.training.checkpoint_dir,
        loss_mode=cfg.training.loss_mode,
        formulation=cfg.network.formulation,
        max_chunk=cfg.training.max_chunk,
        lm_microbatches=cfg.training.lm_microbatches,
        adaptive_bc_weight=cfg.training.adaptive_bc_weight,
        adaptive_bc_ema=cfg.training.adaptive_bc_ema,
        adaptive_bc_max=cfg.training.adaptive_bc_max,
        microbatches=cfg.training.microbatches,
        mesh_devices=cfg.training.mesh_devices,
    )


def build_data(cfg) -> CavityData:
    return CavityData(**data_kwargs(cfg))


def data_kwargs(cfg) -> dict:
    """CavityData's keyword arguments for a config."""
    return dict(
        N_f=cfg.training.N_f,
        sort_training_points=cfg.training.sort_training_points,
        sdf_enabled=cfg.training.sdf_weighting.enabled,
        sdf_min_weight=cfg.training.sdf_weighting.min_weight,
        sdf_decay=cfg.training.sdf_weighting.decay,
        coord_transform=cfg.training.coordinate_transform,
        seed=cfg.training.seed,
    )


def warm_start(solver: PINNSolver, cfg, data: CavityData, init_from: str) -> int:
    """Install the networks of the checkpoint `init_from` into `solver`
    (nsfnet_tpu/train.py:250-340): params only, a fresh optimizer and a carry
    recomputed from the installed EVM net; the main net widened (Net2Net)
    where the config is wider than the donor. The donor trains on the
    solver's own draw (`eq_points`), so the sampler does not advance.
    The donor's shapes come from peek_architecture (the JAX package's state
    itself, the port's sidecar). Raises ValueError where they cannot be read
    or the transfer would not be one: another depth, a narrower config,
    a KAN on either side, another formulation, another EVM net.
    Returns the donor's hidden size."""
    net = cfg.network
    meta = ckpt.load_metadata(init_from) or {}
    arch = ckpt.peek_architecture(init_from)
    if arch is None:
        raise ValueError(f"--init-from: cannot read the network shapes of {init_from}")
    if arch.get("backbone", "mlp") != "mlp" or meta.get("backbone", "mlp") != "mlp" \
            or net.backbone != "mlp" or cfg.model_variant == "kan":
        raise ValueError("--init-from supports the MLP backbone only")
    donor_hidden, donor_layers = int(arch["hidden_size"]), int(arch["layers"])
    if donor_layers != net.layers:
        raise ValueError(f"--init-from: the donor has {donor_layers} layers, the config "
                         f"{net.layers}; depth transfer is not supported")
    if donor_hidden > net.hidden_size:
        raise ValueError(f"--init-from: donor hidden_size {donor_hidden} exceeds the "
                         f"config's {net.hidden_size}; widening only")
    if meta.get("formulation", "velocity") != net.formulation:
        raise ValueError(f"--init-from: donor formulation "
                         f"{meta.get('formulation', 'velocity')!r} != config "
                         f"{net.formulation!r} (the heads predict different quantities)")
    if cfg.model_variant == "ev-nsfnet":
        donor_h1, donor_l1 = arch.get("hidden_size_1"), arch.get("layers_1")
        if donor_h1 is not None and (donor_l1, donor_h1) != (net.layers_1, net.hidden_size_1):
            raise ValueError(f"--init-from: the donor EVM net is {donor_l1}x{donor_h1}, the "
                             f"config's {net.layers_1}x{net.hidden_size_1}; the EVM net "
                             f"transfers only at an exact match")
    dcfg = copy.deepcopy(cfg)
    dcfg.network.hidden_size = donor_hidden
    donor = build_solver(dcfg, device=solver.device)
    donor.set_boundary_data(X=data.boundary_data())
    donor.set_eq_training_data(X=solver.eq_points(), weights=data.sdf_weights)
    donor.load(init_from)
    params, params_evm = donor.params(), donor.params_evm()
    if donor_hidden != net.hidden_size:
        params = widen_mlp_params(params, net.hidden_size,
                                  torch.Generator().manual_seed(cfg.training.seed))
    solver.set_params(params, params_evm)
    return donor_hidden


def main(argv=None) -> int:
    args = parse_args(argv)
    # the process group first, as the JAX driver does (nsfnet_tpu/train.py:130-144)
    joined = not dist.is_initialized()
    rank, world, local_rank = initialize_distributed("cpu" if args.cpu else "cuda")
    try:
        return _main(args, rank, world, local_rank)
    finally:
        if joined and dist.is_initialized():  # the group this call joined
            dist.destroy_process_group()


def _main(args, rank: int, world: int, local_rank: int) -> int:
    if os.path.exists(args.config):
        cm = ConfigManager.from_file(args.config)
    else:
        print(f"config {args.config} not found; using built-in defaults")
        cm = ConfigManager()
    cfg = cm.config

    logger = get_logger(cfg.experiment_name, rank=rank)
    if dist.is_initialized():
        logger.info(f"process group: backend {dist.get_backend()}, "
                    f"rank {rank} of {world}, local rank {local_rank}")
    problems = cm.validate() + [f"not supported by the PyTorch port yet: {u}"
                                for u in unsupported(cfg, world)]
    logger.header("Experiment Configuration")
    cm.print_config(printer=logger.info)
    for w in problems:
        logger.warning(w)
    if args.dry_run:
        logger.info("dry-run complete (no training)")
        return 0
    if problems:
        logger.error(f"invalid configuration ({len(problems)} problem(s) above); aborting")
        return 2
    if args.init_from and args.resume:
        logger.error("--init-from and --resume are mutually exclusive")
        return 2

    device = "cpu" if args.cpu else (f"cuda:{local_rank}"
                                     if dist.is_initialized() else None)
    solver = build_solver(cfg, device=device)
    data = build_data(cfg)
    solver.attach_dataset(data)
    solver.set_boundary_data(X=data.boundary_data())
    solver.set_eq_training_data(X=data.training_data(), weights=data.sdf_weights)
    solver.set_coordinate_transform(data.coord_scale)

    eval_fields = None
    if cfg.eval_data and os.path.exists(cfg.eval_data):
        eval_fields = data.evaluate_data(cfg.eval_data)
        solver.attach_eval_data(eval_fields)
        logger.info(f"loaded DNS eval data: {cfg.eval_data} "
                    f"({eval_fields[0].shape[0]} points)")
    elif cfg.eval_data:
        logger.warning(f"eval data {cfg.eval_data} missing; skipping evaluation")

    # supervision: DNS points drawn with the run's seed (nsfnet_tpu/train.py:235-248)
    sup = cfg.supervision
    if sup.enabled and sup.num_samples > 0 and eval_fields:
        xs, ys, us, vs, ps = eval_fields
        n = min(sup.num_samples, xs.shape[0])
        idx = np.random.default_rng(cfg.training.seed).choice(xs.shape[0], size=n, replace=False)
        solver.set_supervised_data((xs[idx], ys[idx], us[idx], vs[idx], ps[idx]))
        solver.set_supervised_loss_weight(sup.loss_weight)
        logger.info(f"supervision: {n} DNS samples, weight={sup.loss_weight}")
    else:
        if sup.enabled:
            logger.warning("supervision is enabled but there are no DNS samples "
                           "(num_samples 0 or no eval data): training without it")
        solver.clear_supervised_data()
        solver.set_supervised_loss_weight(0.0)

    if args.init_from:
        try:
            donor_hidden = warm_start(solver, cfg, data, args.init_from)
        except ValueError as err:
            logger.error(str(err))
            return 2
        if donor_hidden != cfg.network.hidden_size:
            logger.info(f"warm-start: widened h{donor_hidden} -> h{cfg.network.hidden_size} "
                        f"(function-preserving)")
        logger.info(f"warm-start from {args.init_from}: params only; fresh optimizer, "
                    f"schedule from step 0")

    start_step, sampler_replayed = 0, False
    if args.resume:
        # the sampler first: the replayed points go in (set_eq_training_data
        # resets the carry), then load() installs the carry that belongs to them
        meta = ckpt.load_metadata(args.resume)
        if meta and meta.get("sampler") is not None:
            data.set_state(meta["sampler"])
            solver.set_eq_training_data(X=data.training_data(), weights=data.sdf_weights)
            sampler_replayed = True
            logger.info("sampler state restored; collocation points replayed")
        solver.load(args.resume)
        start_step = solver.global_step
        logger.info(f"resumed from {args.resume} at step {start_step}")

    stages = cfg.training.training_stages
    logger.info(f"training: total epochs={sum(st.epochs for st in stages):,} "
                f"over {len(stages)} stages")
    if cfg.training.enable_tensorboard and rank == 0:
        run_name = f"{cfg.experiment_name}_{time.strftime('%Y%m%d_%H%M%S')}"
        solver.tb_writer = ScalarWriter(os.path.join(cfg.training.tb_log_dir, run_name))
    try:
        old_handler = signal.signal(signal.SIGTERM, _on_sigterm)
        installed = True
    except ValueError:  # not the main thread: SIGTERM keeps its default action
        installed = False
    try:
        cum = 0
        for i, st in enumerate(stages):
            stage_start, stage_end = cum, cum + st.epochs
            cum = stage_end
            if start_step >= stage_end:
                continue  # covered by the restored step
            epochs = stage_end - max(start_step, stage_start)
            logger.stage(st.name, st.alpha, epochs, st.lr)
            solver.current_stage = st.name
            solver.set_alpha_evm(st.alpha)
            # a mid-stage resume keeps the stage's points (replayed from the
            # sampler state where the checkpoint has one); a polish stage
            # keeps no state of its own, so it runs its remaining steps afresh
            mid_stage = bool(args.resume) and start_step > stage_start and st.optimizer == "adam"
            if mid_stage and cfg.training.resample_each_stage and not sampler_replayed:
                logger.warning("mid-stage resume without sampler metadata under "
                               "resample_each_stage: the collocation points may differ "
                               "from the writer's (approximate resume)")
            if cfg.training.resample_each_stage and i > 0 and not mid_stage:
                # rar_schedule "first": residual-aware only on the run's first
                # redraw (stage 1); later redraws are uniform
                use_rar = cfg.training.rar_pool_mult > 0 and (
                    cfg.training.rar_schedule == "every" or i == 1)
                if use_rar:
                    X = data.rar_training_data(solver.residuals_at,
                                               pool_mult=cfg.training.rar_pool_mult,
                                               top_frac=cfg.training.rar_top_frac)
                    logger.info(f"RAR resample: scored pool {cfg.training.rar_pool_mult}x"
                                f"{cfg.training.N_f:,}, kept worst "
                                f"{cfg.training.rar_top_frac:.0%}")
                else:
                    X = data.training_data()
                solver.set_eq_training_data(X=X, weights=data.sdf_weights)
            # a mid-stage resume runs the FULL stage from the restored
            # epoch_in_stage, so the EVM gate's phase stays aligned
            trace = (torch_trace(args.profile, cuda=solver.device.type == "cuda")
                     if args.profile and i == 0 else contextlib.nullcontext())
            with trace:
                solver.train(num_epoch=st.epochs if mid_stage else epochs, lr=st.lr,
                             optimizer=st.optimizer, Re=st.Re or None,
                             bc_weight=st.bc_weight or None,
                             resume_in_stage=mid_stage,
                             advance_on_stall=st.advance_on_stall,
                             stall_threshold=cfg.training.stall_threshold,
                             stall_window=cfg.training.stall_window,
                             stall_min_epochs=st.resolved_stall_min(),
                             stall_metric=cfg.training.stall_metric)
            if eval_fields:
                solver.evaluate(*eval_fields)
        path = solver.save("model_final.ckpt")
    except GracefulStop:
        if world > 1:
            # solver.save reaches a collective that a signal to one rank
            # would deadlock (nsfnet_tpu/train.py:449-457)
            logger.info("SIGTERM: multi-process run, exiting without a collective save "
                        "(resume from the newest cadence checkpoint)")
            return 3
        path = solver.save(f"sigterm_step{solver.global_step}.ckpt")
        logger.info(f"SIGTERM: checkpointed {path}; exiting for --resume")
        return 3
    finally:
        if installed:
            signal.signal(signal.SIGTERM, old_handler)
        if solver.tb_writer is not None:
            solver.tb_writer.close()
    logger.info(f"final state: {path}")
    logger.header("Training Completed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
