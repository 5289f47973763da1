"""PyTorch port: the KAN backbone on the CPU against the JAX package — the
B-spline basis and the forward in float64, the closed-form engine and the
generic nested-jvp engine in float64, the solver (Adam with and without
the EVM net, L-BFGS) in float32, the committed KAN checkpoint, the port's
own KAN checkpoints, and configs/kan_cavity.yaml through train.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import nsfnet_tpu.training.lm as jax_lm
import nsfnet_tpu.training.solver as jax_solver_mod
from nsfnet_tpu.data.cavity import CavityData as JaxCavityData
from nsfnet_tpu.models import kan as jkan
from nsfnet_tpu.ops import derivatives as jd
from nsfnet_tpu.training.solver import PINNSolver as JaxSolver
from nsfnet_tpu_torch import train as port_train
from nsfnet_tpu_torch.config import ConfigManager
from nsfnet_tpu_torch.data.cavity import CavityData
from nsfnet_tpu_torch.models import kan as tkan
from nsfnet_tpu_torch.models.convert import (kan_params_from_numpy, kan_params_to_numpy,
                                             params_from_numpy)
from nsfnet_tpu_torch.models.kan import flatten_kan
from nsfnet_tpu_torch.models.mlp import flatten_params
from nsfnet_tpu_torch.ops import derivatives as td
from nsfnet_tpu_torch.training import checkpoint as ckpt
from nsfnet_tpu_torch.training import solver as solver_mod
from nsfnet_tpu_torch.training.solver import PINNSolver, resolve_engine

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KAN_CKPT = os.path.join(ROOT, "artifacts", "kan_cavity", "final_state.ckpt")
KAN_CFG = os.path.join(ROOT, "configs", "kan_cavity.yaml")
WIDTH = (2, 8, 8, 3)
ARCH = dict(Re=100, layers=2, layers_1=2, hidden_size=8, hidden_size_1=4, N_f=300,
            alpha_evm=0.03, bc_weight=10, eq_weight=1, seed=7, evm_update_freq=2,
            log_interval=1, checkpoint_freq=10**9, backbone="kan", kan_width=WIDTH)
DATA = dict(N_f=300, sort_training_points=False, sdf_enabled=True, coord_transform=True, seed=3)


def _x64_kan(width=WIDTH, grid=5, k=3, n=300, seed=0):
    """JAX-initialised float64 KAN params, both packages' copies, and points
    in [-1.2, 1.2]^2 (outside the grid too, where only silu is left). The
    JAX functions run under jit, as the JAX package runs them (eager JAX
    dispatches op by op, seconds per call here)."""
    p = jax.jit(jkan.init_kan, static_argnums=(1, 2, 3, 5))(
        jax.random.PRNGKey(seed), width, grid, k, 0.1, jnp.float64)
    x = np.random.default_rng(seed).uniform(-1.2, 1.2, (n, 2))
    return p, kan_params_from_numpy(jax.device_get(p), dtype=torch.float64), x


def _max_diff(ref, got):
    return max(float(np.abs(np.asarray(r) - g.detach().numpy()).max()) for r, g in zip(ref, got))


def test_basis_and_forward_match_jax_in_float64(x64):
    """bspline_basis, bspline_basis_derivs (B, B', B'') and kan_apply, grid 5
    and k 3 (the notebook's) and grid 7, k 2, within 1e-12."""
    for grid, k in ((5, 3), (7, 2)):
        jp, tp, x = _x64_kan(grid=grid, k=k)
        xt = torch.from_numpy(x)
        ref = jax.jit(lambda p, x: (jkan.bspline_basis(x, grid, k),
                                    *jkan.bspline_basis_derivs(x, grid, k),
                                    jkan.kan_apply(p, x, grid, k)))(jp, jnp.asarray(x))
        got = (tkan.bspline_basis(xt, grid, k), *tkan.bspline_basis_derivs(xt, grid, k),
               tkan.kan_apply(tp, xt, grid, k))
        assert _max_diff(ref, got) <= 1e-12


def test_engines_match_jax_in_float64(x64):
    """make_kan_derivatives_2d against JAX's, and the generic jvp-of-jvp
    engine over the KAN against JAX's and against the closed form: each
    stream within 1e-10."""
    jp, tp, x = _x64_kan()
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    jnet, tnet = jkan.KAN(width=WIDTH), tkan.KAN(WIDTH)
    closed_j = jax.jit(jd.make_kan_derivatives_2d(jnet))(jp, xj)
    closed_t = td.make_kan_derivatives_2d(tnet)(tp, xt)
    assert _max_diff(closed_j, closed_t) <= 1e-10
    generic_j = jax.jit(lambda p, x: jd.derivatives_2d(lambda z: jnet.apply(p, z), x))(jp, xj)
    generic_t = td.derivatives_2d(lambda z: tkan.kan_apply(tp, z), xt)
    assert _max_diff(generic_j, generic_t) <= 1e-10
    assert _max_diff([c.numpy() for c in closed_t], generic_t) <= 1e-10


def test_generic_engine_gradient_flows_to_the_weights(x64):
    """Autograd through the nested jvps wrt weights captured by the closure
    (the step's mechanism) equals the closed form's gradient."""
    _, tp, x = _x64_kan(n=64)
    xt = torch.from_numpy(x)
    flat = flatten_kan(tp).requires_grad_(True)
    net = tkan.KAN(WIDTH)
    grads = []
    for engine in (lambda f: td.make_kan_derivatives_2d(net)(net.unflatten(f), xt),
                   lambda f: td.derivatives_2d(lambda z: tkan.kan_apply(net.unflatten(f), z), xt)):
        out = engine(flat)
        (g,) = torch.autograd.grad(sum((s ** 2).sum() for s in out), [flat])
        grads.append(g)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-10, atol=1e-12)


def _pair(tmp_path, **kw):
    """The JAX solver and the port on the same KAN (and EVM) weights and
    the same points."""
    arch = {**ARCH, **kw}
    js = JaxSolver(**arch, mesh_devices=1, matmul_precision="highest",
                   checkpoint_path=str(tmp_path / "jax"))
    jdata = JaxCavityData(**DATA, use_native=False)
    js.set_boundary_data(X=jdata.boundary_data())
    js.set_eq_training_data(X=jdata.training_data(), weights=jdata.sdf_weights)
    js.set_coordinate_transform(jdata.coord_scale)
    ps = PINNSolver(**arch, checkpoint_path=str(tmp_path / "port"), device="cpu")
    pdata = CavityData(**DATA)
    ps.set_params(kan_params_from_numpy(jax.device_get(js.state.params)),
                  params_from_numpy(jax.device_get(js.state.params_evm)) if ps.evm else None)
    ps.set_boundary_data(X=pdata.boundary_data())
    ps.set_eq_training_data(X=pdata.training_data(), weights=pdata.sdf_weights)
    ps.set_coordinate_transform(pdata.coord_scale)
    return js, ps


def _initial_grads(js, ps):
    """d total / d (main, EVM) params at the current state, both packages,
    as flat numpy vectors in the port's layout."""
    js._ensure_ready()
    ps._ensure_ready()
    sc = js._stage_scalars(1e-3)
    jg = jax.jit(jax.grad(lambda pa, b, v: js._loss_fn(pa, b, v, sc)[0]))(
        (js.state.params, js.state.params_evm), js._batch, js.state.vis_t_minus)
    st = ps.state
    leaves = [st.params.detach().clone().requires_grad_(True)]
    if ps.evm:
        leaves.append(st.params_evm.detach().clone().requires_grad_(True))
    total, _ = ps._loss_fn((leaves[0], leaves[1] if ps.evm else None), ps._batch,
                           st.vis_t_minus, ps._stage_scalars(1e-3))
    pg = torch.autograd.grad(total, leaves)
    flat = lambda tree, f, conv: f(conv(jax.device_get(tree))).numpy()
    ref = [flat(jg[0], flatten_kan, kan_params_from_numpy)]
    if ps.evm:
        ref.append(flat(jg[1], flatten_params, params_from_numpy))
    return ref, [g.numpy() for g in pg]


@pytest.mark.parametrize("evm", [False, True], ids=["kan", "kan_evm"])
def test_adam_matches_jax_solver(tmp_path, evm):
    """The first gradient of both nets within rtol 5e-4 / atol 5e-6, then 5
    Adam steps (the EVM net updating at stage epochs 2 and 4) with every
    logged metric within rtol 2e-5; float32 on both sides."""
    js, ps = _pair(tmp_path, **({} if evm else dict(evm=False, layers_1=None)))
    assert ps.engine == js.engine == "xla" and ps.evm == evm and ps.backbone == "kan"
    for ref, got in zip(*_initial_grads(js, ps)):
        np.testing.assert_allclose(got, ref, rtol=5e-4, atol=5e-6)
    js.train(num_epoch=5, lr=1e-3)
    ps.train(num_epoch=5, lr=1e-3)
    jh = np.asarray(js._loss_history)[:, 1:]  # total, eq, bc, eq1..eq4
    ph = np.asarray([(m.total, m.equation, m.boundary, m.eq1, m.eq2, m.eq3, m.eq4)
                     for _, m in ps.loss_history])
    assert jh.shape == ph.shape == (5, 7)
    np.testing.assert_allclose(ph, jh, rtol=2e-5, atol=0)
    assert ph[-1, 0] < ph[0, 0]


def test_lbfgs_matches_jax_solver(tmp_path, monkeypatch):
    """5 L-BFGS steps of a small KAN from the same state: the loss history
    within 1e-5 (the MLP's bar, tests/test_torch_polish.py) and the params."""
    hist = []
    real = jax_solver_mod.run_lbfgs

    def capture(*a, **kw):
        out = real(*a, **kw)
        hist.append(np.asarray(out[1]))
        return out

    monkeypatch.setattr(jax_solver_mod, "run_lbfgs", capture)
    js, ps = _pair(tmp_path, evm=False, layers_1=None)
    js.train(num_epoch=5, optimizer="lbfgs")
    ps.train(num_epoch=5, optimizer="lbfgs")
    np.testing.assert_allclose(ps.polish_stats["history"], hist[0], rtol=1e-5)
    assert ps.polish_stats["history"][-1] < ps.polish_stats["history"][0]
    for got, ref in zip(kan_params_to_numpy(ps.params()), jax.device_get(js.state.params)):
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-5)
    assert ps.global_step == js.global_step == 5


def test_lm_matches_jax_solver(tmp_path, monkeypatch):
    """3 LM steps (cg_iters 40) of a small KAN (width [2, 3, 3], grid 3,
    k 2: 105 parameters) from the same state, the closed-form KAN engine
    under LM's jvp, float32 on both sides. The first two steps are
    rejected (the damping rises), the third is taken. The loss history
    agrees to 3e-5 and the params to 1.7e-5 (measured; with cg_iters 20,
    CG stopped early, 2e-3): the bar is the MLP's LM bar, 5e-4
    (tests/test_torch_polish.py)."""
    hist = []
    real = jax_lm.run_lm

    def capture(*a, **kw):
        out = real(*a, **kw)
        hist.append(np.asarray(out[1]))
        return out

    monkeypatch.setattr(jax_lm, "run_lm", capture)
    js, ps = _pair(tmp_path, evm=False, layers_1=None, kan_width=(2, 3, 3), kan_grid=3, kan_k=2)
    js.train_lm(3, cg_iters=40)
    ps.train_lm(3, cg_iters=40)
    np.testing.assert_allclose(ps.polish_stats["history"], hist[0], rtol=5e-4)
    assert ps.polish_stats["history"][-1] < ps.polish_stats["history"][0]
    for got, ref in zip(kan_params_to_numpy(ps.params()), jax.device_get(js.state.params)):
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g, r, rtol=0, atol=5e-4)
    assert ps.global_step == js.global_step == 3


def _kan_cavity_solver(cls, tmp_path, n_f, **kw):
    """A solver of configs/kan_cavity.yaml's net on n_f of its seeded points."""
    cfg = ConfigManager.from_file(KAN_CFG).config
    arch = dict(Re=cfg.physics.Re, bc_weight=cfg.physics.bc_weight, N_f=n_f, evm=False,
                layers_1=None, backbone="kan", kan_width=tuple(cfg.network.kan_width),
                kan_grid=cfg.network.kan_grid, kan_k=cfg.network.kan_k,
                checkpoint_path=str(tmp_path), **kw)
    data_kw = dict(N_f=n_f, sort_training_points=False, seed=cfg.training.seed)
    if cls is JaxSolver:
        s, d = cls(**arch, mesh_devices=1, matmul_precision="highest"), \
            JaxCavityData(**data_kw, use_native=False)
    else:
        s, d = cls(**arch, device="cpu"), CavityData(**data_kw)
    s.set_boundary_data(X=d.boundary_data())
    s.set_eq_training_data(X=d.training_data(), weights=d.sdf_weights)
    return s


def test_committed_kan_checkpoint_loads_bitwise(tmp_path):
    """artifacts/kan_cavity/final_state.ckpt (the JAX package's 200 L-BFGS
    steps of the notebook's KAN): the port's reader gives JAX's params
    bitwise, and the two solvers' losses of that state on the same 2,000
    seeded points agree within 2e-5."""
    arch = ckpt.peek_architecture(KAN_CKPT)
    assert arch["backbone"] == "kan" and arch["kan_width"] == [2, 16, 16, 8]
    js = _kan_cavity_solver(JaxSolver, tmp_path / "jax", 2000)
    ps = _kan_cavity_solver(PINNSolver, tmp_path / "port", 2000)
    js.load(KAN_CKPT)
    ps.load(KAN_CKPT)
    assert ps.global_step == js.global_step == 200 and ps.current_stage == "lbfgs"
    for got, ref in zip(kan_params_to_numpy(ps.params()), jax.device_get(js.state.params)):
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, np.asarray(r))
    js._ensure_ready()
    ps._ensure_ready()
    sc = js._stage_scalars(1.0)
    jl = float(jax.jit(lambda p, b: js._loss_fn((p, None), b, None, sc)[0])(
        js.state.params, js._batch))
    with torch.no_grad():
        pl = float(ps._loss_fn((ps.state.params, None), ps._batch, None,
                               ps._stage_scalars(1.0))[0])
    assert abs(pl - jl) <= 2e-5 * abs(jl)
    assert pl < 0.05  # a trained state (the run ended near 8.5e-3 on its 10,000 points)


def test_own_checkpoint_round_trips_and_load_refuses_other_nets(tmp_path):
    """A port KAN state after 2 Adam steps saves and loads bit for bit (Adam
    moments included); load refuses a KAN state of another width (the port's
    sidecar and the JAX state) and an MLP state in a KAN solver."""
    _, ps = _pair(tmp_path, evm=False, layers_1=None)
    ps.train(num_epoch=2, lr=1e-3)
    path = ps.save("k.ckpt", directory=str(tmp_path))
    assert ckpt.load_metadata(path)["backbone"] == "kan"
    vanilla = {**ARCH, "evm": False, "layers_1": None}
    back = PINNSolver(**{**vanilla, "seed": 99}, device="cpu")
    back.load(path)
    for a, b in ((back.state.params, ps.state.params), (back.state.opt_main.mu, ps.state.opt_main.mu),
                 (back.state.opt_main.nu, ps.state.opt_main.nu)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert back.state.opt_main.count == 2 and back.global_step == 2

    other = PINNSolver(**{**vanilla, "kan_width": (2, 8, 3)}, device="cpu")
    for p in (path, KAN_CKPT):
        with pytest.raises(ValueError, match="architecture does not match"):
            other.load(p)
    mlp = PINNSolver(**{**vanilla, "backbone": "mlp"}, device="cpu")
    mlp_path = mlp.save("m.ckpt", directory=str(tmp_path))
    with pytest.raises(ValueError, match="backbone"):
        back.load(mlp_path)
    with pytest.raises(ValueError, match="architecture does not match"):
        mlp.load(path)


def test_engine_choice_keeps_kernels_off_the_kan(tmp_path, monkeypatch):
    """`auto` on a card resolves to "xla" for a KAN (and "pallas" for the
    plain MLP); an explicit "pallas" falls back to "xla"; the solver's
    generic engine kind agrees with the KAN closed form; the solver never
    calls a kernel wrapper or builds the fused loss for a KAN; the
    streamfunction formulation is refused."""
    assert resolve_engine("auto", "cuda", "mlp") == "pallas"
    assert resolve_engine("auto", "cuda", "kan") == "xla"
    assert resolve_engine("pallas", "cuda", "kan") == "xla"
    assert resolve_engine("auto", "cpu", "kan") == "xla"

    def refuse(*a, **kw):
        raise AssertionError("a kernel wrapper was called for a KAN")

    for name in ("fused_residual_loss", "mlp_streams", "psi_streams"):
        monkeypatch.setattr(solver_mod, name, refuse)
    _, ps = _pair(tmp_path, engine="pallas")
    assert ps.engine == "xla"
    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (64, 2)).astype(np.float32))
    for got, ref in zip(ps._engine("generic")(ps.state.params, x), ps._engine()(ps.state.params, x)):
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-5 * ref.abs().max().item())
    ps.train(num_epoch=2, lr=1e-3)
    ps.residuals_at(np.linspace(0, 1, 7), np.linspace(0, 1, 7))
    with pytest.raises(ValueError, match="streamfunction"):
        PINNSolver(**ARCH, formulation="streamfunction", device="cpu")


def test_cli_trains_kan_cavity_on_the_cpu(tmp_path):
    """configs/kan_cavity.yaml through train.py, its L-BFGS stage cut to 3
    steps on 500 points: nothing refused, exit 0, a KAN checkpoint at
    global step 3 that a solver of the config loads; --init-from a KAN
    state is refused (exit 2)."""
    cm = ConfigManager.from_file(KAN_CFG)
    assert port_train.unsupported(cm.config) == []
    raw = cm.to_dict()
    raw["training"]["training_stages"][0]["epochs"] = 3
    raw["training"].update(N_f=500, checkpoint_dir=str(tmp_path))
    path = tmp_path / "kan.yaml"
    path.write_text(yaml.safe_dump(raw))
    assert port_train.main(["--config", str(path), "--dry-run"]) == 0
    assert port_train.main(["--config", str(path), "--cpu"]) == 0
    final = list(tmp_path.glob("Re100/*/model_final.ckpt"))
    assert len(final) == 1
    meta = ckpt.load_metadata(str(final[0]))
    assert (meta["backbone"], meta["kan_width"], meta["global_step"]) == ("kan", [2, 16, 16, 8], 3)
    solver = port_train.build_solver(ConfigManager.from_file(str(path)).config, device="cpu")
    assert solver.backbone == "kan" and not solver.evm
    solver.load(str(final[0]))
    assert solver.global_step == 3
    # --init-from stays MLP-only (nsfnet_tpu/train.py:289-290)
    assert port_train.main(["--config", str(path), "--cpu", "--init-from", KAN_CKPT]) == 2
