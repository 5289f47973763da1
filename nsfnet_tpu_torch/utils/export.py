"""Model export for serving (port of nsfnet_tpu/utils/export.py): the
solver's prediction head, weights baked in and the batch dimension symbolic,
saved as a `torch.export` program.

The serving process needs only `torch` and the file: no model code, no
config, no checkpoint format. The program is traced on the solver's device
and saved with its weights on the CPU, so any machine loads it;
`load_predict` moves it to the card, or to the CPU where asked.

Artifact layout: `<path>` holds the `torch.export.save` archive; `<path>.json`
is a human-readable sidecar (architecture, formulation, Re, torch version)
with the JAX package's keys, `torch_version` in place of `jax_version`. Both
are written atomically.

The residual (physics QC) head runs the closed-form engine in exact fp32, as
`solver.residuals_at` does: a kernel launched through ctypes cannot be traced.
"""

from __future__ import annotations

import json
import os

import torch

from nsfnet_tpu_torch.ops import residuals as R
from nsfnet_tpu_torch.training.solver import _exact_fp32, resolve_device

SIDECAR_SUFFIX = ".json"
SERVES = ("cpu", "cuda")  # load_predict moves a program to either


class _Head(torch.nn.Module):
    """(pts [N, 2] float32) -> fn(params, params_evm, pts), the weights held
    as buffers (copies: later training does not move a served head)."""

    def __init__(self, fn, params, params_evm):
        super().__init__()
        self.fn = fn
        self.register_buffer("params", params.detach().clone())
        self.register_buffer("params_evm", None if params_evm is None
                             else params_evm.detach().clone())

    def forward(self, pts):
        return self.fn(self.params, self.params_evm, pts)


def _predict_fn(solver):
    """(params, params_evm, pts) -> [N, 4] (u, v, p, e), the contract of
    solver.predict (e == 0 without an EVM net)."""
    uvp_apply = solver._uvp_apply()
    apply_evm = solver._apply_evm() if solver.evm else None

    def predict(params, params_evm, pts):
        uvp = uvp_apply(params, pts)[:, 0:3]
        e = (apply_evm(params_evm, pts)[:, 0:1] if apply_evm is not None
             else torch.zeros_like(pts[:, 0:1]))
        return torch.cat([uvp, e], dim=1)

    return predict


def _residual_fn(solver):
    """(params, params_evm, pts) -> [N] per-point PDE residual magnitude
    sqrt(eq1^2 + eq2^2 + eq3^2) under the solver's nets and physics at
    export time (the EVM viscosity included), solver.residuals_at's
    contract."""
    engine = solver._engine("xla")
    apply_evm = solver._apply_evm() if solver.evm else None
    scale, re, alpha = solver.coord_scale, float(solver.current_re), float(solver.alpha_evm)

    def score(params, params_evm, pts):
        derivs = engine(params, pts)
        if apply_evm is not None:
            e = apply_evm(params_evm, pts)[:, 0:1]
            vis_t = torch.clamp(alpha * e.abs(), max=20.0 / re)
            r = R.ev_ns_residuals(derivs, e, vis_t, re, scale)
        else:
            r = R.ns_residuals(derivs, re, scale)
        return torch.sqrt(r.eq1 ** 2 + r.eq2 ** 2 + r.eq3 ** 2)[:, 0]

    return score


def _export(solver, fn, path, kind, outputs, extra_meta=None) -> dict:
    from torch.export import Dim, export
    from torch.export.passes import move_to_device_pass

    dev = solver.device
    head = _Head(fn, solver.state.params,
                 solver.state.params_evm if solver.evm else None).to(dev)
    example = torch.rand((16, 2), dtype=torch.float32, device=dev)
    with torch.no_grad():
        program = export(head, (example,), dynamic_shapes=({0: Dim("n")},))
    program = move_to_device_pass(program, torch.device("cpu"))
    meta = {
        "kind": kind,
        "outputs": outputs,
        "input": "[n, 2] float32 (x, y)",
        "platforms": list(SERVES),
        "traced_on": str(dev),
        "torch_version": torch.__version__,
        "formulation": solver.formulation,
        "backbone": solver.backbone,
        "Re": float(solver.current_re),
        "evm": bool(solver.evm),
        "alpha_evm": float(solver.alpha_evm),
        "coord_scale": float(solver.coord_scale),
        "global_step": int(solver.global_step),
    }
    if extra_meta:
        meta.update(extra_meta)
    tmp = f"{path}.{os.getpid()}.tmp.pt2"  # torch.export names its archives .pt2
    torch.export.save(program, tmp)
    os.replace(tmp, path)  # atomic, as the checkpoint writes
    tmp = f"{path}{SIDECAR_SUFFIX}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1)
    os.replace(tmp, path + SIDECAR_SUFFIX)
    return meta


def export_predict(solver, path: str, extra_meta=None) -> dict:
    """Save the solver's prediction head (u, v, p, e) to `path` with its
    `.json` sidecar; returns the sidecar's fields."""
    return _export(solver, _predict_fn(solver), path, kind="nsfnet_tpu.predict",
                   outputs=["u", "v", "p", "e"], extra_meta=extra_meta)


def export_residuals(solver, path: str, extra_meta=None) -> dict:
    """Save the physics-QC head (the per-point PDE residual magnitude) to
    `path` with its sidecar. Its vis_t cap bakes the solver's current
    alpha_evm: the CLI restores the checkpoint's."""
    return _export(solver, _residual_fn(solver), path, kind="nsfnet_tpu.residuals",
                   outputs=["sqrt(eq1^2+eq2^2+eq3^2)"], extra_meta=extra_meta)


def load_predict(path: str, device=None):
    """An exported artifact as a callable (pts [N, 2]) -> its outputs, any N,
    on `device`: the card unless the caller asks for the CPU (no card and no
    such request raises). No model code is needed; matmuls run in exact
    fp32."""
    from torch.export.passes import move_to_device_pass

    target = resolve_device(device)
    module = move_to_device_pass(torch.export.load(path), target).module()

    def call(pts):
        x = torch.as_tensor(pts, dtype=torch.float32).reshape(-1, 2).to(target)
        with torch.no_grad(), _exact_fp32():
            return module(x)

    return call


def main(argv=None) -> int:
    """CLI: export a trained checkpoint's prediction head (and its residual
    head with --residuals).

    python -m nsfnet_tpu_torch.utils.export --config configs/re5000_production.yaml \\
        --ckpt results/.../model_final.ckpt --out artifacts/re5000_predict.pt2 [--cpu]
    """
    import argparse

    p = argparse.ArgumentParser(description="Export the predict head with torch.export")
    p.add_argument("--config", required=True)
    p.add_argument("--ckpt", required=True, help="full-state checkpoint (either format)")
    p.add_argument("--out", required=True, help="artifact path")
    p.add_argument("--residuals", action="store_true",
                   help="also export the physics-QC residual head (<out>.residuals)")
    p.add_argument("--alpha-evm", type=float, default=None,
                   help="the EVM alpha baked into the residual head (default: the "
                        "checkpoint's training-time alpha from its metadata, else the "
                        "config's)")
    p.add_argument("--cpu", action="store_true", help="export on the CPU instead of the card")
    args = p.parse_args(argv)

    from nsfnet_tpu_torch.config import ConfigManager
    from nsfnet_tpu_torch.train import build_data, build_solver
    from nsfnet_tpu_torch.training import checkpoint as ckpt_io

    cfg = ConfigManager.from_file(args.config).config
    solver = build_solver(cfg, device="cpu" if args.cpu else None)
    # the restore template, wired as train.py wires it (the coordinate
    # transform included: a transform-trained net's derivatives scale by it)
    data = build_data(cfg)
    solver.set_boundary_data(X=data.boundary_data())
    solver.set_eq_training_data(X=data.training_data(), weights=data.sdf_weights)
    solver.set_coordinate_transform(data.coord_scale)
    solver.load(args.ckpt)
    # the residual head's vis_t cap depends on alpha_evm, which train.py
    # sets per stage: restore the value the checkpoint trained at
    ckpt_meta = ckpt_io.load_metadata(args.ckpt) or {}
    if args.alpha_evm is not None:
        solver.set_alpha_evm(args.alpha_evm)
        alpha_src = "cli"
    elif "alpha_evm" in ckpt_meta:
        solver.set_alpha_evm(float(ckpt_meta["alpha_evm"]))
        alpha_src = "checkpoint"
    else:
        alpha_src = "config"
    extra = {"alpha_evm_source": alpha_src}
    print(json.dumps(export_predict(solver, args.out, extra_meta=extra)))
    if args.residuals:
        print(json.dumps(export_residuals(solver, args.out + ".residuals", extra_meta=extra)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
