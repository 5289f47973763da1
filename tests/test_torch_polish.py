"""PyTorch port: the second-order polish on the CPU — L-BFGS with the zoom
line search against optax and the JAX solver, Levenberg-Marquardt (full
and over collocation slices) against the JAX package's, the least-squares
residual against the loss, and the chunking of both.

LM steps in float32 are chaotic from a random start when CG stops early:
CG over an ill-conditioned J^T J amplifies one-ulp differences of the sums
by orders of magnitude. So the LM comparisons run CG to convergence on
nets small enough for it (cg_iters > the parameter count's effective
rank), where a step is a well-conditioned function of its inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

import nsfnet_tpu.training.lm as jax_lm
import nsfnet_tpu.training.solver as jax_solver_mod
from nsfnet_tpu.data.cavity import CavityData as JaxCavityData
from nsfnet_tpu.models.mlp import mlp_apply as jax_mlp_apply
from nsfnet_tpu.ops.derivatives import mlp_derivatives_2d as jax_mlp_derivatives_2d
from nsfnet_tpu.training.state import Batch as JaxBatch
from nsfnet_tpu.training.solver import PINNSolver as JaxSolver
from nsfnet_tpu.training.step import StageScalars as JaxStageScalars
from nsfnet_tpu.training.step import make_residual_fn as jax_make_residual_fn
from nsfnet_tpu_torch.data.cavity import CavityData
from nsfnet_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from nsfnet_tpu_torch.training.lbfgs import run_lbfgs
from nsfnet_tpu_torch.training.lm import run_lm, run_lm_micro, stack_slices
from nsfnet_tpu_torch.training.solver import PINNSolver
from nsfnet_tpu_torch.training.state import Batch
from nsfnet_tpu_torch.training.step import make_residual_fn

torch.set_num_threads(2)

ARCH = dict(Re=100, layers=2, layers_1=2, hidden_size=8, hidden_size_1=4, N_f=64,
            alpha_evm=0.03, bc_weight=10, eq_weight=1, seed=7, evm_update_freq=2,
            log_interval=1000, checkpoint_freq=10**9)
DATA = dict(N_f=64, sort_training_points=False, sdf_enabled=True, coord_transform=False, seed=3)
CG = 40  # > the 160 parameters' effective rank: CG converges (module docstring)
SUP = tuple(np.asarray(a, np.float32) for a in (
    [[0.3], [0.6], [0.8]], [[0.4], [0.5], [0.2]], [[0.1], [0.2], [0.3]],
    [[0.0], [0.1], [0.2]], [[0.5], [np.nan], [0.7]]))


def _pair(tmp_path, adam_steps=0, supervised=False, **kw):
    """The JAX solver and the port on the same weights, points and
    supervised samples, after the same Adam steps (none by default)."""
    arch = {**ARCH, **kw}
    js = JaxSolver(**arch, mesh_devices=1, matmul_precision="highest",
                   checkpoint_path=str(tmp_path / "jax"))
    jd = JaxCavityData(**DATA, use_native=False)
    js.set_boundary_data(X=jd.boundary_data())
    js.set_eq_training_data(X=jd.training_data(), weights=jd.sdf_weights)
    ps = PINNSolver(**arch, checkpoint_path=str(tmp_path / "port"), device="cpu")
    pd = CavityData(**DATA)
    ps.set_params(params_from_numpy(jax.device_get(js.state.params)),
                  params_from_numpy(jax.device_get(js.state.params_evm)) if ps.evm else None)
    ps.set_boundary_data(X=pd.boundary_data())
    ps.set_eq_training_data(X=pd.training_data(), weights=pd.sdf_weights)
    if supervised:
        for s in (js, ps):
            s.set_supervised_data(SUP)
            s.set_supervised_loss_weight(2.0)
    if adam_steps:
        js.train(num_epoch=adam_steps, lr=1e-3)
        ps.train(num_epoch=adam_steps, lr=1e-3)
    return js, ps


def _params_close(js, ps, atol):
    pairs = [(ps.params(), js.state.params)]
    if ps.evm:
        pairs.append((ps.params_evm(), js.state.params_evm))
    for got, ref in pairs:
        for (gw, gb), (rw, rb) in zip(params_to_numpy(got), jax.device_get(ref)):
            np.testing.assert_allclose(gw, rw, rtol=0, atol=atol)
            np.testing.assert_allclose(gb, rb, rtol=0, atol=atol)


def _capture(monkeypatch, module, name, store):
    real = getattr(module, name)

    def wrapper(*a, **kw):
        out = real(*a, **kw)
        store.append(np.asarray(out[1]))
        return out

    monkeypatch.setattr(module, name, wrapper)


# ---------------------------------------------------------------- L-BFGS

def _rosenbrock(np_):
    return lambda w: np_.sum(100.0 * (w[1:] - w[:-1] ** 2) ** 2 + (1 - w[:-1]) ** 2)


_A = np.random.default_rng(0).standard_normal((12, 8))
_B = np.random.default_rng(1).standard_normal(12)


def _least_squares(np_, tanh, sin, asarray):
    return lambda w: (np_.sum((asarray(_A) @ tanh(w) - asarray(_B)) ** 2)
                      + 0.1 * np_.sum(sin(3 * w) ** 2))


PROBLEMS = {
    # the valley makes the line search zoom (up to 10 evaluations a step)
    "rosenbrock": (_rosenbrock(jnp), _rosenbrock(torch),
                   np.array([-1.2, 1.0, -0.5, 0.8, 1.1, -1.0]), 20),
    "least_squares": (_least_squares(jnp, jnp.tanh, jnp.sin, jnp.asarray),
                      _least_squares(torch, torch.tanh, torch.sin, torch.from_numpy),
                      np.random.default_rng(2).standard_normal(8), 25),
}


@pytest.mark.parametrize("problem", sorted(PROBLEMS))
def test_lbfgs_matches_optax_in_float64(x64, problem):
    """Every iterate of the port's L-BFGS against optax.lbfgs with run_lbfgs's
    settings (memory 10, zoom line search of 25 steps, its "keep" initial
    guess), float64 on both sides, within 1e-9."""
    f_jax, f_torch, w0, n = PROBLEMS[problem]
    opt = optax.lbfgs(memory_size=10,
                      linesearch=optax.scale_by_zoom_linesearch(max_linesearch_steps=25))
    value_and_grad = jax.value_and_grad(f_jax)

    @jax.jit
    def step(p, s):
        v, g = value_and_grad(p)
        u, s = opt.update(g, s, p, value=v, grad=g, value_fn=f_jax)
        return optax.apply_updates(p, u), s, v

    p, s = jnp.asarray(w0), opt.init(jnp.asarray(w0))
    iterates, values = [], []
    for _ in range(n):
        p, s, v = step(p, s)
        iterates.append(np.asarray(p))
        values.append(float(v))

    def vg(w):
        w = w.detach().requires_grad_(True)
        val = f_torch(w)
        return val.detach(), torch.autograd.grad(val, w)[0]

    for k in (1, 2, 5, n // 2, n):
        res = run_lbfgs(vg, torch.from_numpy(w0), k)
        np.testing.assert_allclose(res.params.numpy(), iterates[k - 1], rtol=0, atol=1e-9)
    np.testing.assert_allclose(res.history, values, rtol=1e-9, atol=1e-12)
    if problem == "rosenbrock":
        assert max(res.evaluations) > 3  # the zoom phase ran


def test_train_lbfgs_matches_jax_solver(tmp_path, monkeypatch):
    """3 L-BFGS steps of both nets on the closed-form loss from the same
    state: loss histories and params, float32 on both sides (the line
    search decides alike; the losses differ in the sums' order)."""
    hist = []
    _capture(monkeypatch, jax_solver_mod, "run_lbfgs", hist)
    js, ps = _pair(tmp_path, supervised=True)
    js.train(num_epoch=3, optimizer="lbfgs")
    ps.train(num_epoch=3, optimizer="lbfgs")
    np.testing.assert_allclose(ps.polish_stats["history"], hist[0], rtol=1e-5)
    _params_close(js, ps, atol=1e-5)
    assert ps.global_step == js.global_step == 3
    assert ps.state.opt_main.count == 0  # Adam's moments untouched


@pytest.mark.parametrize("micro", [1, 3])
def test_train_lm_matches_jax_solver(tmp_path, monkeypatch, micro):
    """2 LM steps (cg_iters 40) of both nets from the same state, full and
    over 3 slices, supervision on, float32 on both sides. The first step
    agrees to 2e-6; fp32 CG stagnates at the rounding of its products, so
    the second differs by 1e-4 of the loss and of the params (measured):
    the bars are 5e-4. The float64 test below holds the algorithm to 1e-9."""
    hist = []
    _capture(monkeypatch, jax_lm, "run_lm_micro" if micro > 1 else "run_lm", hist)
    js, ps = _pair(tmp_path, supervised=True)
    js.train_lm(2, cg_iters=CG, microbatches=micro)
    ps.train_lm(2, cg_iters=CG, microbatches=micro)
    assert ps.polish_stats["microbatches"] == micro
    np.testing.assert_allclose(ps.polish_stats["history"], hist[0], rtol=5e-4)
    assert ps.polish_stats["history"][-1] < ps.polish_stats["history"][0]  # steps were taken
    _params_close(js, ps, atol=5e-4)
    assert ps.global_step == js.global_step == 2


def test_lm_full_and_sliced_match_jax_in_float64(tmp_path, x64):
    """run_lm and run_lm_micro (3 slices, zero-padded) on the cavity
    residual with EVM and supervision, the port's and the JAX package's in
    float64 on the same weights and batch: every pair within 1e-9. The flat
    vectors have one order in both packages ((W, b) per layer, main net
    first)."""
    ps = PINNSolver(**ARCH, checkpoint_path=str(tmp_path), device="cpu")
    pd = CavityData(**DATA)
    ps.set_boundary_data(X=pd.boundary_data())
    ps.set_eq_training_data(X=pd.training_data(), weights=pd.sdf_weights)
    ps.set_supervised_data(SUP)
    ps.set_supervised_loss_weight(2.0)
    ps.train(num_epoch=2, lr=1e-3)
    f64 = lambda t: t.double() if torch.is_tensor(t) else t
    pb, pv = Batch(*map(f64, ps._batch)), ps.state.vis_t_minus.double()
    res = make_residual_fn(engine=ps._engine("xla"), apply_main=ps._uvp_apply(),
                           apply_evm=ps._apply_evm(), coord_scale=1.0, alpha_e=1.0,
                           alpha_s=2.0, evm=True)
    w0, split = ps._flat_state()
    sc = ps._stage_scalars(1.0)
    out = {"port": run_lm(lambda w: res(split(w), pb, pv, sc), w0.double(), 3, cg_iters=CG)}
    slices = stack_slices([pb.x_f, pb.y_f, pb.eq_w, pv], 3)
    out["port_micro"] = run_lm_micro(
        lambda w, sl: res.eq_residual_fn(split(w), *sl, pb.n_f, sc),
        lambda w: res.aux_residual_fn(split(w), pb, sc), slices, w0.double(), 3, cg_iters=CG)

    jres = jax_make_residual_fn(engine=jax_mlp_derivatives_2d, apply_main=jax_mlp_apply,
                                apply_evm=jax_mlp_apply, coord_scale=1.0, alpha_e=1.0,
                                alpha_s=2.0, evm=True)
    to64 = lambda a: jnp.asarray(a.numpy() if torch.is_tensor(a) else a, jnp.float64)
    jb = JaxBatch(**{k: None if v is None else to64(v) for k, v in pb._asdict().items()})
    jv = to64(pv)
    jp = tuple(tuple(tuple(map(to64, wb)) for wb in params_to_numpy(net))
               for net in (ps.params(), ps.params_evm()))
    jsc = JaxStageScalars(*map(to64, sc))
    p, h, lam = jax_lm.run_lm(lambda pa: jres(pa, jb, jv, jsc), jp, 3, cg_iters=CG)
    out["jax"] = (ravel_pytree(p)[0], h, lam)
    n, k = jb.x_f.shape[0], 3
    m = -(-n // k)
    stack = lambda a: jnp.concatenate([a, jnp.zeros((k * m - n, 1))]).reshape(k, m, 1)
    sl = {"x": stack(jb.x_f), "y": stack(jb.y_f), "w": stack(jb.eq_w), "v": stack(jv)}
    p, h, lam = jax_lm.run_lm_micro(
        lambda pa, s: jres.eq_residual_fn(pa, s["x"], s["y"], s["w"], s["v"], jb.n_f, jsc),
        lambda pa: jres.aux_residual_fn(pa, jb, jsc), sl, jp, 3, cg_iters=CG)
    out["jax_micro"] = (ravel_pytree(p)[0], h, lam)

    ref_w, ref_h, ref_lam = out["jax"]
    assert np.asarray(ref_h)[-1] < np.asarray(ref_h)[0]
    for name, (w, h, lam) in out.items():
        np.testing.assert_allclose(np.asarray(w), np.asarray(ref_w), rtol=0, atol=1e-9,
                                   err_msg=name)
        np.testing.assert_allclose(np.asarray(h), np.asarray(ref_h), rtol=1e-9, err_msg=name)
        assert lam == pytest.approx(ref_lam, rel=1e-12)


def test_lm_sliced_matches_full_in_float32(tmp_path):
    """run_lm_micro realises run_lm's Gauss-Newton math within the port in
    float32 (nsfnet_tpu's test_lm_microbatched_matches_full, with CG run
    further): 4 slices, the vanilla net (no carry), 2 steps. The history
    agrees to 2.6e-6 and the params to 1.3e-5 (measured): bars 2e-5, 5e-5."""
    runs = []
    for micro in (1, 4):
        s = PINNSolver(**{**ARCH, "evm": False, "layers_1": None},
                       checkpoint_path=str(tmp_path), device="cpu")
        d = CavityData(**DATA)
        s.set_boundary_data(X=d.boundary_data())
        s.set_eq_training_data(X=d.training_data(), weights=d.sdf_weights)
        s.train(num_epoch=2, lr=1e-3)
        s.train_lm(2, cg_iters=CG, microbatches=micro)
        runs.append(s)
    a, b = runs
    assert b.polish_stats["history"][-1] < b.polish_stats["history"][0]
    np.testing.assert_allclose(b.polish_stats["history"], a.polish_stats["history"], rtol=2e-5)
    torch.testing.assert_close(b.state.params, a.state.params, rtol=0, atol=5e-5)


# --------------------------------------------------- residual and chunks

def test_lbfgs_and_lm_are_chunking_invariant():
    """Chunks only move the loop's state between host calls: the same
    trajectory bitwise (nsfnet_tpu's test_lbfgs_chunking_invariant)."""
    def vg(w):
        w = w.detach().requires_grad_(True)
        v = torch.sum((w - 3.0) ** 2) + torch.sum(torch.sin(w) ** 2)
        return v.detach(), torch.autograd.grad(v, w)[0]

    w0 = torch.arange(6, dtype=torch.float32) / 7.0
    one, chunked = run_lbfgs(vg, w0, 12, max_chunk=12), run_lbfgs(vg, w0, 12, max_chunk=4)
    assert torch.equal(one.params, chunked.params) and one.history == chunked.history

    a, b = torch.from_numpy(_A.astype(np.float32)), torch.from_numpy(_B.astype(np.float32))
    r = lambda w: torch.tanh(a @ w) - 0.5 * b
    w0 = torch.linspace(0.0, 1.0, 8)
    whole, parts = run_lm(r, w0, 6, cg_iters=5, max_chunk=6), run_lm(r, w0, 6, cg_iters=5,
                                                                     max_chunk=2)
    assert torch.equal(whole[0], parts[0]) and torch.equal(whole[1], parts[1])


def test_polish_steps_round_up_to_whole_chunks(tmp_path):
    """max_chunk 80: L-BFGS chunks of 2 steps, LM of max(1, 80 // 104) = 1;
    5 L-BFGS steps run 6 and global_step counts all of them."""
    ps = PINNSolver(**ARCH, max_chunk=80, checkpoint_path=str(tmp_path), device="cpu")
    d = CavityData(**DATA)
    ps.set_boundary_data(X=d.boundary_data())
    ps.set_eq_training_data(X=d.training_data(), weights=d.sdf_weights)
    ps.train(num_epoch=2, lr=1e-3)
    ps.train(num_epoch=5, optimizer="lbfgs")
    assert len(ps.polish_stats["history"]) == 6 and ps.global_step == 8
    ps.train(num_epoch=2, optimizer="lm")
    assert len(ps.polish_stats["history"]) == 2 and ps.global_step == 10
    with pytest.raises(ValueError, match="optimizer"):
        ps.train(num_epoch=1, optimizer="sgd")
