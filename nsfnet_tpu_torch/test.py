"""Checkpoint-sweep evaluation (port of nsfnet_tpu/test.py; parity
with ev-NSFnet/test.py:27-99): replay saved checkpoints through evaluate +
test, writing one `.mat` result file per checkpoint with the error scalars
in it.

Usage:
    python -m nsfnet_tpu_torch.test --config configs/re5000_production.yaml \\
        --checkpoints 'results/Re5000/**/model_cavity_loop*.ckpt' [--out DIR] [--cpu]

Checkpoints of either format load: the port's own and the JAX package's
flax msgpack. Runs on the CUDA card; `--cpu` runs on the CPU.
"""

from __future__ import annotations

import argparse
import glob
import os

from nsfnet_tpu_torch.config import ConfigManager
from nsfnet_tpu_torch.logger import get_logger
from nsfnet_tpu_torch.train import build_data, build_solver


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="NSFnet PyTorch/CUDA checkpoint sweep")
    p.add_argument("--config", type=str, default="configs/re5000_production.yaml")
    p.add_argument("--checkpoints", type=str, required=True,
                   help="glob over full-state checkpoint files")
    p.add_argument("--out", type=str, default=None, help="result .mat directory")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    cm = ConfigManager.from_file(args.config) if os.path.exists(args.config) \
        else ConfigManager()
    cfg = cm.config
    logger = get_logger(cfg.experiment_name + "_sweep")

    # the training config's data exactly (sort, SDF, seed, transform), so the
    # restore template matches the run being swept
    data = build_data(cfg)
    data.boundary_data()  # fixes the coordinate frame
    if not cfg.eval_data or not os.path.exists(cfg.eval_data):
        logger.error(f"eval data missing: {cfg.eval_data!r}")
        return 1
    x, y, u, v, p = data.evaluate_data(cfg.eval_data)

    paths = sorted(glob.glob(args.checkpoints, recursive=True))
    if not paths:
        logger.error(f"no checkpoints match {args.checkpoints}")
        return 1
    logger.info(f"sweeping {len(paths)} checkpoints")

    solver = build_solver(cfg, device="cpu" if args.cpu else None)
    # the restore template needs the collocation shapes for the vis_t carry
    solver.set_boundary_data(X=data.boundary_data())
    solver.set_eq_training_data(X=data.training_data(), weights=data.sdf_weights)
    solver.set_coordinate_transform(data.coord_scale)

    for i, path in enumerate(paths):
        solver.load(path)
        logger.info(f"[{i + 1}/{len(paths)}] {path} (step {solver.global_step})")
        solver.test(x, y, u, v, p, loop=solver.global_step, save_dir=args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
