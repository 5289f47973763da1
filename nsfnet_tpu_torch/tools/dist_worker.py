"""One rank of a data-parallel check run, and the driver under a launcher
with its kernel launch counts read back.

    python -m nsfnet_tpu_torch.tools.dist_worker dp SPEC.json OUT.npz
    torchrun --nproc_per_node=N -m nsfnet_tpu_torch.tools.dist_worker \\
        train OUT.json --config CFG [train.py arguments]

`dp`: join the launch's process group (parallel/mesh.initialize_distributed,
with the spec's `backend` if it names one), then `run_dp(spec)` and save
its arrays to OUT.npz (one file per rank: the caller gives each rank its
own path). `run_dp` also runs in-process without a group: the 1-rank run
the ranks are held against.

The spec (JSON): `solver` (PINNSolver keyword arguments), `data`
(CavityData keyword arguments), `device` ("cpu" or "cuda"), optional
`backend`, `weights` (an .npz with flat `params` / `params_evm` installed
before every run), `steps` (Adam steps at lr 1e-3), `microbatches` (a list:
one run each), `ckpt_dir` and `continue_steps` (the first run saves a
checkpoint there, every rank reloads it and trains that many steps more),
`polish` ({"lbfgs": steps, "lm": steps, "cg_iters": n, "lm_slices": k}:
L-BFGS in float32, then LM, full and over k slices, on the batch cast to
float64).

`train`: join the process group, run train.main with the arguments after
OUT.json, and write {rc, backend, rank, world, launches, launch_rows} to
OUT.json (OUT.json.rank<r> on ranks above 0).
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch
import torch.distributed

from nsfnet_tpu_torch import ops


def _counts():
    from nsfnet_tpu_torch.ops import fused_residual as fr

    return ops.launch_counts(), dict(fr.launch_rows)


def _reset():
    ops.reset_launch_counts()


def _solver(spec, **kw):
    from nsfnet_tpu_torch.data.cavity import CavityData
    from nsfnet_tpu_torch.models.mlp import unflatten_params
    from nsfnet_tpu_torch.training.solver import PINNSolver

    dev = spec["device"]
    if dev == "cuda" and torch.distributed.is_initialized():
        dev = f"cuda:{torch.cuda.current_device()}"
    s = PINNSolver(**{**spec["solver"], **kw}, device=dev)
    d = CavityData(**spec["data"])
    s.set_boundary_data(X=d.boundary_data())
    s.set_eq_training_data(X=d.training_data(), weights=d.sdf_weights)
    s.set_coordinate_transform(d.coord_scale)
    if spec.get("weights"):
        w = np.load(spec["weights"])
        s.set_params(unflatten_params(torch.from_numpy(w["params"]), s.net.sizes),
                     unflatten_params(torch.from_numpy(w["params_evm"]), s.net_1.sizes)
                     if s.evm else None)
    return s


def _flat(s) -> np.ndarray:
    parts = [s.state.params] + ([s.state.params_evm] if s.evm else [])
    return torch.cat([p.detach().reshape(-1) for p in parts]).cpu().numpy()


def run_dp(spec: dict) -> dict:
    """The spec's runs on this process (a rank of the current process group,
    or alone): {name: array}. Every "run/quantity" key is the same on all
    ranks of a group (the caller checks them bitwise); "<run>_seconds" is
    the run's wall time."""
    out = {}
    steps = int(spec["steps"])
    for i, m in enumerate(spec["microbatches"]):
        s = _solver(spec, microbatches=m, log_interval=1)
        _reset()
        t0 = time.perf_counter()
        s.train(num_epoch=steps, lr=1e-3)
        if s.device.type == "cuda":
            torch.cuda.synchronize(s.device)
        seconds = time.perf_counter() - t0
        counts, rows = _counts()
        tag = f"m{m}"
        out[f"{tag}_seconds"] = np.asarray(seconds)  # no "/": the one key ranks differ in
        out[f"{tag}/params"] = _flat(s)
        out[f"{tag}/history"] = np.asarray([list(mt) for _, mt in s.loss_history], np.float64)
        out[f"{tag}/launches"] = np.asarray([counts["fused_residual_fwd"],
                                             counts["fused_residual_bwd"]])
        out[f"{tag}/other_launches"] = np.asarray(sum(v for k, v in counts.items()
                                                      if not k.startswith("fused")))
        out[f"{tag}/rows"] = np.asarray([rows["fused_residual_fwd"], rows["fused_residual_bwd"]])
        out[f"{tag}/local_rows"] = np.asarray(s._batch.x_f.shape[0])
        if i == 0 and spec.get("ckpt_dir"):
            carry = s.state.vis_t_minus.detach().clone()
            path = s.save("dist.ckpt", directory=spec["ckpt_dir"])
            before = _flat(s)
            s.load(path)
            # the real rows of this rank's block (load pads the others anew)
            local = carry.shape[0]
            real = (s.rank * local + torch.arange(local, device=carry.device)) < s._eq[0].shape[0]
            out["reload/params_equal"] = np.asarray(np.array_equal(before, _flat(s)))
            out["reload/carry_equal"] = np.asarray(torch.equal(carry[real],
                                                               s.state.vis_t_minus[real]))
            s.train(num_epoch=int(spec.get("continue_steps", 2)), lr=1e-3)
            out["reload/params"] = _flat(s)
            out["reload/history"] = np.asarray([list(mt) for _, mt in s.loss_history],
                                               np.float64)
    pol = spec.get("polish")
    if pol:
        s = _solver(spec)
        s.train(num_epoch=int(pol["lbfgs"]), optimizer="lbfgs")
        out["lbfgs/params"] = _flat(s)
        out["lbfgs/history"] = np.asarray(s.polish_stats["history"], np.float64)
        for k in (1, int(pol.get("lm_slices", 2))):
            s = _solver(spec)
            _to_float64(s)
            s.train_lm(int(pol["lm"]), cg_iters=int(pol["cg_iters"]), microbatches=k)
            out[f"lm{k}/params"] = _flat(s)
            out[f"lm{k}/history"] = np.asarray(s.polish_stats["history"], np.float64)
    return out


def _to_float64(s) -> None:
    """The solver's batch, carry and parameters in float64 (the LM checks:
    fp32 CG parts early between summation orders)."""
    from nsfnet_tpu_torch.training.state import Batch

    s._ensure_ready()
    f64 = lambda t: t.double() if torch.is_tensor(t) else t
    s._batch = Batch(*map(f64, s._batch))
    st = s.state
    st.params = st.params.detach().double()
    st.params_evm = None if st.params_evm is None else st.params_evm.detach().double()
    st.vis_t_minus = None if st.vis_t_minus is None else st.vis_t_minus.double()


def main(argv=None) -> int:
    from nsfnet_tpu_torch.logger import get_logger
    from nsfnet_tpu_torch.parallel.mesh import initialize_distributed

    argv = sys.argv[1:] if argv is None else argv
    mode = argv[0]
    if mode == "dp":
        spec_path, out_path = argv[1:3]
        with open(spec_path) as f:
            spec = json.load(f)
        rank, world, _ = initialize_distributed(spec["device"], backend=spec.get("backend"))
        get_logger("dist_worker", rank=rank)  # rank 0 alone logs
        try:
            arrays = run_dp(spec)
            arrays["world"] = np.asarray(world)
            arrays["rank"] = np.asarray(rank)
            arrays["backend"] = np.asarray(torch.distributed.get_backend()
                                           if torch.distributed.is_initialized() else "none")
            np.savez(out_path, **arrays)
        finally:
            if torch.distributed.is_initialized():
                torch.distributed.destroy_process_group()
        print(f"DONE rank={rank}", flush=True)
        return 0
    if mode == "train":
        from nsfnet_tpu_torch import train

        out_path, rest = argv[1], argv[2:]
        rank, world, _ = initialize_distributed("cpu" if "--cpu" in rest else "cuda")
        try:
            backend = (torch.distributed.get_backend() if torch.distributed.is_initialized()
                       else "none")
            _reset()
            rc = train.main(rest)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            counts, rows = _counts()
        finally:
            if torch.distributed.is_initialized():
                torch.distributed.destroy_process_group()
        with open(out_path if rank == 0 else f"{out_path}.rank{rank}", "w") as f:
            json.dump({"rc": rc, "backend": backend, "rank": rank, "world": world,
                       "launches": counts, "launch_rows": rows}, f)
        return rc
    raise SystemExit(f"unknown mode {mode!r}; dp or train")


if __name__ == "__main__":
    raise SystemExit(main())
