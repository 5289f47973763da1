"""PyTorch port: data parallelism over torch.distributed on the CPU — two
real processes (gloo) spawned as tests/test_distributed.py spawns the JAX
package's, on a free port, each a rank of `nsfnet_tpu_torch.tools.
dist_worker`: a tiny flagship trained 10 Adam steps alone and with
`microbatches: 2`, rank 0's checkpoint with the gathered vis_t carry
reloaded by both ranks, and the polish (L-BFGS; LM full and over slices in
float64) across the ranks. Held against each other (bitwise), against the
JAX solver's 2-device mesh on the same weights, and against the port's own
1-process run. Then the launch decision from the environment, and the
settings the port refuses.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import nsfnet_tpu.parallel.mesh as jax_mesh
from nsfnet_tpu.data.cavity import CavityData as JaxCavityData
from nsfnet_tpu.training.solver import PINNSolver as JaxSolver
from nsfnet_tpu_torch import train as port_train
from nsfnet_tpu_torch.config import ConfigManager
from nsfnet_tpu_torch.models.convert import params_from_numpy
from nsfnet_tpu_torch.models.mlp import flatten_params
from nsfnet_tpu_torch.parallel import mesh as M
from nsfnet_tpu_torch.tools.dist_worker import run_dp
from nsfnet_tpu_torch.training import solver as solver_mod
from nsfnet_tpu_torch.training.solver import PINNSolver

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_distributed.py's tiny flagship, with SDF weights and the EVM
# gate firing inside the 10 steps
ARCH = dict(Re=100, layers=2, layers_1=2, hidden_size=12, hidden_size_1=8, N_f=256,
            alpha_evm=0.03, bc_weight=10, eq_weight=1, seed=7, evm_update_freq=4,
            checkpoint_freq=10**9)
DATA = dict(N_f=256, sort_training_points=False, sdf_enabled=True, seed=0)
STEPS = 10
MICRO = (1, 2)
# LM runs in float64 with 3 CG iterations: at 10 on this net CG loses
# orthogonality and even float64 parts by % between two summation orders
POLISH = {"lbfgs": 3, "lm": 2, "cg_iters": 3, "lm_slices": 2}


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _jax_solver(micro, tmp):
    js = JaxSolver(**ARCH, log_interval=1, mesh_devices=2, microbatches=micro,
                   matmul_precision="highest", checkpoint_path=str(tmp))
    assert js.world_size == 2
    jd = JaxCavityData(**DATA, use_native=False)
    js.set_boundary_data(X=jd.boundary_data())
    js.set_eq_training_data(X=jd.training_data(), weights=jd.sdf_weights)
    return js


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both ranks' arrays, the port's 1-process run of the same spec, the
    JAX mesh runs' (history, params) by microbatch count, and the paths."""
    tmp = tmp_path_factory.mktemp("dp")
    js = _jax_solver(1, tmp / "jax1")
    flat = lambda tree: flatten_params(params_from_numpy(jax.device_get(tree))).numpy()
    weights = str(tmp / "weights.npz")
    np.savez(weights, params=flat(js.state.params), params_evm=flat(js.state.params_evm))
    spec = {"solver": {**ARCH, "engine": "pallas", "checkpoint_path": str(tmp / "ck")},
            "data": DATA, "device": "cpu", "weights": weights, "steps": STEPS,
            "microbatches": list(MICRO), "ckpt_dir": str(tmp / "shared_ckpts"),
            "continue_steps": 2, "polish": POLISH}
    with open(tmp / "spec.json", "w") as f:
        json.dump(spec, f)
    port = _free_port()
    outs = [str(tmp / f"rank{r}.npz") for r in (0, 1)]
    procs = []
    for r in (0, 1):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "nsfnet_tpu_torch.tools.dist_worker", "dp",
             str(tmp / "spec.json"), outs[r]], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        # meanwhile, in this process: the references
        jax_runs = {}
        for m in MICRO:
            j = js if m == 1 else _jax_solver(m, tmp / f"jax{m}")
            j.train(num_epoch=STEPS, lr=1e-3)
            p = jax.device_get((j.state.params, j.state.params_evm))
            jax_runs[m] = (np.asarray(j._loss_history)[:, 1:],
                           np.concatenate([flat(p[0]), flat(p[1])]))
        one = run_dp({**spec, "ckpt_dir": str(tmp / "one_ckpts")})
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-3000:]}"
        assert f"DONE rank={r}" in log
    ranks = [dict(np.load(o)) for o in outs]
    return {"ranks": ranks, "one": one, "jax": jax_runs, "tmp": tmp}


def _port_history(h):
    """StepMetrics rows (total, boundary, equation, supervised, eq1..eq4,
    vis_t_mean) in the JAX history's columns (total, eq, bc, eq1..eq4)."""
    return h[:, [0, 2, 1, 4, 5, 6, 7]]


def test_ranks_are_one_process_group_and_bitwise_equal(runs):
    """A gloo group of two; every array of every run (params after Adam
    alone and microbatched, after the reload, after L-BFGS and LM; the
    logged metrics) bitwise equal across the ranks; each rank held half the
    padded collocation rows."""
    a, b = runs["ranks"]
    assert str(a["backend"]) == str(b["backend"]) == "gloo"
    assert int(a["world"]) == int(b["world"]) == 2 and (int(a["rank"]), int(b["rank"])) == (0, 1)
    keys = [k for k in a if "/" in k]
    assert len(keys) >= 20 and set(keys) == {k for k in b if "/" in k}
    for k in keys:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert int(a["m1/local_rows"]) * 2 == int(runs["one"]["m1/local_rows"]) == 256


@pytest.mark.parametrize("micro", MICRO)
def test_two_ranks_match_the_jax_mesh(runs, micro):
    """10 Adam steps on 2 ranks against the JAX solver with mesh_devices=2
    (and the same microbatch count) from the same weights and points: every
    logged metric within rtol 2e-5, the params within 5e-5 (Adam's step is
    lr-sized, tests/test_torch_solver.py)."""
    jh, jp = runs["jax"][micro]
    a = runs["ranks"][0]
    hist = _port_history(a[f"m{micro}/history"])
    assert hist.shape == jh.shape == (STEPS, 7)
    np.testing.assert_allclose(hist, jh, rtol=2e-5, atol=0)
    np.testing.assert_allclose(a[f"m{micro}/params"], jp, rtol=0, atol=5e-5)
    assert hist[-1, 0] < hist[0, 0]


@pytest.mark.parametrize("micro", MICRO)
def test_two_ranks_match_one_process(runs, micro):
    """The same run in one process: the sums in another order, metrics
    within rtol 2e-6 and params within 1e-6."""
    a, one = runs["ranks"][0], runs["one"]
    np.testing.assert_allclose(a[f"m{micro}/history"], one[f"m{micro}/history"],
                               rtol=2e-6, atol=1e-12)
    np.testing.assert_allclose(a[f"m{micro}/params"], one[f"m{micro}/params"],
                               rtol=0, atol=1e-6)


def test_checkpoint_gathers_the_carry_and_both_ranks_resume(runs):
    """Rank 0's checkpoint holds the whole padded vis_t carry (both ranks'
    blocks, in rank order), matching the 1-process run's; both ranks
    reloaded it bitwise (params, their real carry rows) and trained on."""
    tmp = runs["tmp"]
    two = torch.load(tmp / "shared_ckpts" / "dist.ckpt", weights_only=True)
    one = torch.load(tmp / "one_ckpts" / "dist.ckpt", weights_only=True)
    assert two["vis_t_minus"].shape == one["vis_t_minus"].shape == (256, 1)
    torch.testing.assert_close(two["vis_t_minus"], one["vis_t_minus"], rtol=1e-5, atol=1e-9)
    assert two["step"] == STEPS and two["opt_main"]["count"] == STEPS
    for r in runs["ranks"]:
        assert bool(r["reload/params_equal"]) and bool(r["reload/carry_equal"])
        assert np.isfinite(r["reload/history"]).all()
    np.testing.assert_allclose(runs["ranks"][0]["reload/params"], runs["one"]["reload/params"],
                               rtol=0, atol=1e-6)


def test_polish_across_ranks_matches_one_process(runs):
    """L-BFGS (3 steps, float32): the value and gradient of each evaluation
    all-reduced, the line search deciding alike; within 1e-5 of one
    process. LM (2 steps, float64), full and over 2 slices per rank: the
    Gauss-Newton products all-reduced; within 1e-9."""
    a, one = runs["ranks"][0], runs["one"]
    np.testing.assert_allclose(a["lbfgs/history"], one["lbfgs/history"], rtol=1e-5)
    np.testing.assert_allclose(a["lbfgs/params"], one["lbfgs/params"], rtol=0, atol=1e-5)
    for k in (1, POLISH["lm_slices"]):
        assert a[f"lm{k}/history"][-1] < a["lbfgs/history"][0]
        np.testing.assert_allclose(a[f"lm{k}/history"], one[f"lm{k}/history"], rtol=1e-9)
        np.testing.assert_allclose(a[f"lm{k}/params"], one[f"lm{k}/params"], rtol=0, atol=1e-9)


def test_launch_decision_from_the_environment():
    """tests/test_mesh.py's cases where the port has a counterpart (a world
    size above 1 under any launcher; a malformed count ignored), plus
    torchrun's markers, which ask for a group even at one process. The JAX
    package's coordinator and TPU-host markers start no torch process group."""
    decide = M.should_initialize_distributed
    assert not decide({})
    assert decide({"SLURM_NTASKS": "4"})
    assert not decide({"SLURM_NTASKS": "1"})
    assert decide({"OMPI_COMM_WORLD_SIZE": "2"})
    assert decide({"NSFNET_NUM_PROCESSES": "8"})
    assert decide({"PMI_SIZE": "2"})
    assert not decide({"SLURM_NTASKS": "garbage"})
    assert decide({"WORLD_SIZE": "2"})
    assert decide({"TORCHELASTIC_RUN_ID": "x", "WORLD_SIZE": "1"})
    assert decide({"MASTER_ADDR": "127.0.0.1", "WORLD_SIZE": "1"})
    assert not decide({"WORLD_SIZE": "1"})
    for env in ({}, {"SLURM_NTASKS": "4"}, {"OMPI_COMM_WORLD_SIZE": "2"}):
        assert decide(env) == jax_mesh.should_initialize_distributed(env)


def test_a_detected_launch_that_cannot_join_raises(monkeypatch):
    """No silent single-process fallback (nsfnet_tpu/parallel/mesh.py:56-74):
    a failing init_process_group is raised, and so is a launch without a
    rendezvous address; a single-process environment joins nothing."""
    import torch.distributed as dist

    def boom(*a, **k):
        raise RuntimeError("no store reachable")

    monkeypatch.setattr(dist, "init_process_group", boom)
    launch = {"WORLD_SIZE": "2", "RANK": "0", "MASTER_ADDR": "127.0.0.1",
              "MASTER_PORT": "1"}
    with pytest.raises(RuntimeError, match="no store reachable"):
        M.initialize_distributed("cpu", launch)
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        M.initialize_distributed("cpu", {"OMPI_COMM_WORLD_SIZE": "2",
                                         "OMPI_COMM_WORLD_RANK": "1"})
    with pytest.raises(RuntimeError, match="rank"):
        M.initialize_distributed("cpu", {"SLURM_NTASKS": "2"})
    assert M.initialize_distributed("cpu", {}) == (0, 1, 0)
    assert not dist.is_initialized()


def test_rows_shard_in_jax_order_and_gather_back():
    """shard_rows gives rank r the r-th contiguous block, as P('data', None)
    places rows; padded_size keeps every block whole tiles."""
    a = np.arange(24, dtype=np.float32).reshape(12, 2)
    blocks = [M.shard_rows(a, r, 3) for r in range(3)]
    np.testing.assert_array_equal(np.concatenate(blocks), a)
    np.testing.assert_array_equal(blocks[1], a[4:8])
    with pytest.raises(ValueError):
        M.shard_rows(a, 0, 5)
    assert M.padded_size(256, 2, 16 * 2) == 256 and M.padded_size(257, 2, 32) == 320
    assert M.padded_size(2052, 2) == jax_mesh.padded_size(2052, 2) == 2064


def test_settings_a_single_process_refuses(tmp_path, monkeypatch):
    """mesh_devices must be the world size (one process per card), and an
    L2 loss is refused over several ranks (nsfnet_tpu solver.py:575-577):
    in the solver and in the driver, with a message naming torchrun."""
    with pytest.raises(ValueError, match="torchrun --nproc_per_node=2"):
        PINNSolver(**ARCH, mesh_devices=2, device="cpu")
    assert PINNSolver(**ARCH, mesh_devices=1, device="cpu").world_size == 1
    cfg = ConfigManager.from_dict({"training": {"mesh_devices": 2}}).config
    assert any("mesh_devices 2" in u for u in port_train.unsupported(cfg))
    assert port_train.unsupported(cfg, world_size=2) == []
    monkeypatch.setattr(solver_mod.pmesh, "process_group", lambda: object())
    monkeypatch.setattr(solver_mod.pmesh, "rank_and_world", lambda group: (0, 2))
    with pytest.raises(ValueError, match="single-program"):
        PINNSolver(**{**ARCH, "evm": False, "layers_1": None}, loss_mode="L2", device="cpu")
