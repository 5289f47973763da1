"""Training driver (port of nsfnet_tpu/train.py; parity with
ev-NSFnet/train.py:74-224).

Usage:
    python -m nsfnet_tpu_torch.train --config configs/re2000_ev.yaml [--dry-run] [--cpu]

Flow: config -> solver -> data -> staged Adam loop with per-stage evaluate
-> final checkpoint. With `training.enable_tensorboard` (the default) the
logged scalars go to `<tb_log_dir>/<experiment>_<timestamp>/scalars.jsonl`
(and to TensorBoard where it is installed); every checkpoint gets
`eq_losses.mat` beside it. Runs on the CUDA card; `--cpu` runs on the CPU,
and without a card and without `--cpu` it raises. Options of the JAX driver
that this port does not run yet (resume, init-from, profiling, per-stage
resampling, RAR, L-BFGS/LM stages, supervision, Fourier / KAN, ...) are refused in
`unsupported()` rather than ignored.
"""

from __future__ import annotations

import argparse
import os
import time

from nsfnet_tpu_torch.config import ConfigManager
from nsfnet_tpu_torch.data.cavity import CavityData
from nsfnet_tpu_torch.logger import get_logger
from nsfnet_tpu_torch.training.solver import PINNSolver
from nsfnet_tpu_torch.utils.tensorboard import ScalarWriter


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="NSFnet PyTorch/CUDA training")
    p.add_argument("--config", type=str, default="configs/re5000_production.yaml")
    p.add_argument("--dry-run", action="store_true",
                   help="print config & stages then exit (ev-NSFnet/train.py:18)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the CUDA card")
    return p.parse_args(argv)


def unsupported(cfg) -> list:
    """Config settings this slice of the port cannot honour."""
    t, n = cfg.training, cfg.network
    out = []
    if cfg.model_variant not in ("nsfnet", "ev-nsfnet"):
        out.append(f"model_variant {cfg.model_variant!r}")
    if n.backbone != "mlp" or n.fourier_features:
        out.append("only the plain MLP backbone (either formulation)")
    if t.microbatches != 1 or (t.mesh_devices or 1) != 1:
        out.append("microbatches / mesh_devices > 1")
    if t.resample_each_stage or t.rar_pool_mult or t.adaptive_bc_weight:
        out.append("resample_each_stage / rar_pool_mult / adaptive_bc_weight")
    if cfg.supervision.enabled:
        out.append("supervision")
    for st in t.training_stages:
        if st.optimizer != "adam":
            out.append(f"stage {st.name!r}: optimizer {st.optimizer!r}")
    return out


def build_solver(cfg, device=None) -> PINNSolver:
    variant = cfg.model_variant
    return PINNSolver(
        Re=cfg.physics.Re,
        layers=cfg.network.layers,
        layers_1=cfg.network.layers_1 if variant == "ev-nsfnet" else None,
        hidden_size=cfg.network.hidden_size,
        hidden_size_1=cfg.network.hidden_size_1,
        N_f=cfg.training.N_f,
        alpha_evm=cfg.physics.alpha_evm,
        bc_weight=cfg.physics.bc_weight,
        eq_weight=cfg.physics.eq_weight,
        entropy_residual_weight=cfg.physics.entropy_residual_weight,
        evm=(variant == "ev-nsfnet"),
        seed=cfg.training.seed,
        matmul_precision=cfg.training.matmul_precision,
        evm_update_freq=cfg.training.evm_update_freq,
        log_interval=cfg.training.log_interval,
        checkpoint_freq=cfg.training.checkpoint_freq,
        checkpoint_path=cfg.training.checkpoint_dir,
        loss_mode=cfg.training.loss_mode,
        formulation=cfg.network.formulation,
        device=device,
    )


def build_data(cfg) -> CavityData:
    return CavityData(
        N_f=cfg.training.N_f,
        sort_training_points=cfg.training.sort_training_points,
        sdf_enabled=cfg.training.sdf_weighting.enabled,
        sdf_min_weight=cfg.training.sdf_weighting.min_weight,
        sdf_decay=cfg.training.sdf_weighting.decay,
        coord_transform=cfg.training.coordinate_transform,
        seed=cfg.training.seed,
    )


def main(argv=None) -> int:
    args = parse_args(argv)
    if os.path.exists(args.config):
        cm = ConfigManager.from_file(args.config)
    else:
        print(f"config {args.config} not found; using built-in defaults")
        cm = ConfigManager()
    cfg = cm.config

    logger = get_logger(cfg.experiment_name)
    problems = cm.validate() + [f"not supported by the PyTorch port yet: {u}"
                                for u in unsupported(cfg)]
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

    solver = build_solver(cfg, device="cpu" if args.cpu else None)
    data = build_data(cfg)
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

    stages = cfg.training.training_stages
    logger.info(f"training: total epochs={sum(st.epochs for st in stages):,} "
                f"over {len(stages)} stages")
    if cfg.training.enable_tensorboard:
        run_name = f"{cfg.experiment_name}_{time.strftime('%Y%m%d_%H%M%S')}"
        solver.tb_writer = ScalarWriter(os.path.join(cfg.training.tb_log_dir, run_name))
    try:
        for st in stages:
            logger.stage(st.name, st.alpha, st.epochs, st.lr)
            solver.current_stage = st.name
            solver.set_alpha_evm(st.alpha)
            solver.train(num_epoch=st.epochs, lr=st.lr, Re=st.Re or None,
                         bc_weight=st.bc_weight or None,
                         advance_on_stall=st.advance_on_stall,
                         stall_threshold=cfg.training.stall_threshold,
                         stall_window=cfg.training.stall_window,
                         stall_min_epochs=st.resolved_stall_min(),
                         stall_metric=cfg.training.stall_metric)
            if eval_fields:
                solver.evaluate(*eval_fields)
        path = solver.save("model_final.ckpt")
    finally:
        if solver.tb_writer is not None:
            solver.tb_writer.close()
    logger.info(f"final state: {path}")
    logger.header("Training Completed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
