"""PyTorch port: the random Fourier input embedding and the generic
nested-jvp engines on the CPU against the JAX package — B against JAX's
stream, the generic engines of both formulations in float64, the solver
with a Fourier-embedded net (velocity and streamfunction) in float32, and a
JAX checkpoint of a Fourier net read by the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nsfnet_tpu.training.lm as jax_lm
from jax.flatten_util import ravel_pytree
from nsfnet_tpu.data.cavity import CavityData as JaxCavityData
from nsfnet_tpu.models import mlp as jmlp
from nsfnet_tpu.ops import derivatives as jd
from nsfnet_tpu.training.solver import PINNSolver as JaxSolver
from nsfnet_tpu.training.state import Batch as JaxBatch
from nsfnet_tpu.training.step import StageScalars as JaxStageScalars
from nsfnet_tpu.training.step import make_residual_fn as jax_make_residual_fn
from nsfnet_tpu_torch.data.cavity import CavityData
from nsfnet_tpu_torch.models import mlp as tmlp
from nsfnet_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from nsfnet_tpu_torch.models.mlp import flatten_params
from nsfnet_tpu_torch.ops import derivatives as td
from nsfnet_tpu_torch.training import solver as solver_mod
from nsfnet_tpu_torch.training.lm import run_lm
from nsfnet_tpu_torch.training.solver import PINNSolver, resolve_engine
from nsfnet_tpu_torch.training.state import Batch
from nsfnet_tpu_torch.training.step import make_residual_fn

torch.set_num_threads(2)

ARCH = dict(Re=100, layers=2, layers_1=2, hidden_size=8, hidden_size_1=4, N_f=300,
            alpha_evm=0.03, bc_weight=10, eq_weight=1, seed=7, evm_update_freq=2,
            log_interval=1, checkpoint_freq=10**9, fourier_features=4, fourier_sigma=2.0)
DATA = dict(N_f=300, sort_training_points=False, sdf_enabled=True, coord_transform=True, seed=3)


@pytest.mark.parametrize("seed,m,sigma", [(0, 16, 3.0), (7, 8, 1.0), (123, 64, 10.0),
                                          (2**31 - 1, 5, 2.0)])
def test_fourier_b_matrix_matches_jax(seed, m, sigma):
    """The numpy copy of JAX's threefry stream: the uniform bits equal, B
    within 2e-6 of max|B| (erfinv's float32 rounding; bitwise at most
    entries)."""
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(tmlp.jax_random_bits32(seed, (2, m)),
                                  np.asarray(jax.random.bits(key, (2, m), jnp.uint32)))
    ref = np.asarray(jmlp.fourier_b_matrix(2, m, sigma, seed))
    got = tmlp.fourier_b_matrix(2, m, sigma, seed).numpy()
    assert got.dtype == np.float32 and got.shape == (2, m)
    assert np.abs(got - ref).max() <= 2e-6 * np.abs(ref).max()


def _x64_mlp(sizes, n=300, seed=0):
    p = jax.jit(jmlp.init_mlp, static_argnums=(1, 2))(jax.random.PRNGKey(seed), sizes,
                                                      jnp.float64)
    x = np.random.default_rng(seed).uniform(-1.0, 1.0, (n, 2))
    return p, params_from_numpy(jax.device_get(p), dtype=torch.float64), x


def _max_diff(ref, got):
    return max(float(np.abs(np.asarray(r) - g.detach().numpy()).max()) for r, g in zip(ref, got))


def test_generic_engines_match_jax_in_float64(x64):
    """On a Fourier MLP (JAX's B handed to the port's functional form):
    derivatives_2d, first_derivatives_2d, psi_p_derivatives_2d and the
    generic psi_p_uv against JAX's, each stream within 1e-10; and on a plain
    (psi, p) MLP psi_p_derivatives_2d against the port's closed form."""
    m = 4
    b = jmlp.fourier_b_matrix(2, m, 2.0, 0, jnp.float64)
    bt = torch.from_numpy(np.array(b))
    for outs in (3, 2):
        jp, tp, x = _x64_mlp((2 + 2 * m, 8, 8, outs))
        xt, xj = torch.from_numpy(x), jnp.asarray(x)
        japply = lambda p, z: jmlp.mlp_apply(p, jmlp.fourier_embed(z, b))
        tapply = lambda z: tmlp.mlp_apply(tp, tmlp.fourier_embed(z, bt))
        ref = jax.jit(lambda p, z: (
            jd.derivatives_2d(lambda u: japply(p, u), z),
            jd.first_derivatives_2d(lambda u: japply(p, u), z),
            jd.psi_p_derivatives_2d(lambda u: japply(p, u), z, 1.7),
            jd.psi_p_uv(lambda u: japply(p, u), z, 1.7)))(jp, xj)
        assert _max_diff(ref[0], td.derivatives_2d(tapply, xt)) <= 1e-10
        assert _max_diff(ref[1], td.first_derivatives_2d(tapply, xt)) <= 1e-10
        if outs == 2:
            assert _max_diff(ref[2], td.psi_p_derivatives_2d(tapply, xt, 1.7)) <= 1e-10
            assert _max_diff([ref[3]], [td.psi_p_uv_generic(tapply, xt, 1.7)]) <= 1e-10

    jp, tp, x = _x64_mlp((2, 8, 8, 2))
    xt = torch.from_numpy(x)
    ref = jax.jit(lambda p, z: jd.psi_p_derivatives_2d(lambda u: jmlp.mlp_apply(p, u), z, 1.7))(
        jp, jnp.asarray(x))
    generic = td.psi_p_derivatives_2d(lambda z: tmlp.mlp_apply(tp, z), xt, 1.7)
    assert _max_diff(ref, generic) <= 1e-10
    assert _max_diff([g.numpy() for g in generic],
                     td.mlp_psi_derivatives_2d(tp, xt, 1.7)) <= 1e-10


def _pair(tmp_path, **kw):
    arch = {**ARCH, **kw}
    js = JaxSolver(**arch, mesh_devices=1, matmul_precision="highest",
                   checkpoint_path=str(tmp_path / "jax"))
    jdata = JaxCavityData(**DATA, use_native=False)
    js.set_boundary_data(X=jdata.boundary_data())
    js.set_eq_training_data(X=jdata.training_data(), weights=jdata.sdf_weights)
    js.set_coordinate_transform(jdata.coord_scale)
    ps = PINNSolver(**arch, checkpoint_path=str(tmp_path / "port"), device="cpu")
    pdata = CavityData(**DATA)
    ps.set_params(params_from_numpy(jax.device_get(js.state.params)),
                  params_from_numpy(jax.device_get(js.state.params_evm)) if ps.evm else None)
    ps.set_boundary_data(X=pdata.boundary_data())
    ps.set_eq_training_data(X=pdata.training_data(), weights=pdata.sdf_weights)
    ps.set_coordinate_transform(pdata.coord_scale)
    return js, ps


@pytest.mark.parametrize("formulation", ["velocity", "streamfunction"])
def test_adam_matches_jax_solver(tmp_path, formulation):
    """A Fourier ev-NSFnet (m 4, sigma 2), each package building its own B:
    the first gradient of both nets within rtol 5e-4 / atol 5e-6, then 5
    Adam steps with every logged metric within rtol 2e-5; float32."""
    js, ps = _pair(tmp_path, formulation=formulation)
    assert ps.engine == js.engine == "xla" and ps.net.sizes[0] == 2 + 2 * 4
    js._ensure_ready()
    ps._ensure_ready()
    sc = js._stage_scalars(1e-3)
    jg = jax.jit(jax.grad(lambda pa, b, v: js._loss_fn(pa, b, v, sc)[0]))(
        (js.state.params, js.state.params_evm), js._batch, js.state.vis_t_minus)
    st = ps.state
    leaves = [st.params.detach().clone().requires_grad_(True),
              st.params_evm.detach().clone().requires_grad_(True)]
    total, _ = ps._loss_fn(tuple(leaves), ps._batch, st.vis_t_minus, ps._stage_scalars(1e-3))
    for ref, got in zip(jg, torch.autograd.grad(total, leaves)):
        np.testing.assert_allclose(got.numpy(),
                                   flatten_params(params_from_numpy(jax.device_get(ref))).numpy(),
                                   rtol=5e-4, atol=5e-6)
    js.train(num_epoch=5, lr=1e-3)
    ps.train(num_epoch=5, lr=1e-3)
    jh = np.asarray(js._loss_history)[:, 1:]  # total, eq, bc, eq1..eq4
    ph = np.asarray([(m.total, m.equation, m.boundary, m.eq1, m.eq2, m.eq3, m.eq4)
                     for _, m in ps.loss_history])
    assert jh.shape == ph.shape == (5, 7)
    np.testing.assert_allclose(ph, jh, rtol=2e-5, atol=0)
    assert ph[-1, 0] < ph[0, 0]
    if formulation == "streamfunction":
        assert np.all(ph[:, 5] == 0.0)  # continuity exact by construction


def test_jax_fourier_checkpoint_keeps_its_function(tmp_path, monkeypatch):
    """A JAX Fourier net's checkpoint (plain (W, b) layers, first fan_in
    2 + 2m) loads into the port, which rebuilds B from the config: the
    predictions agree within 1e-5 of their scale. A plain MLP solver and
    another m refuse it; the port's own checkpoint of that net, whose
    sidecar stamps sigma, is refused by a solver of another sigma (its B
    would differ). No kernel wrapper is called, even on "pallas"."""
    def refuse(*a, **kw):
        raise AssertionError("a kernel wrapper was called for a Fourier net")

    for name in ("fused_residual_loss", "mlp_streams", "psi_streams"):
        monkeypatch.setattr(solver_mod, name, refuse)
    assert resolve_engine("auto", "cuda", "mlp", fourier_features=4) == "xla"
    assert resolve_engine("pallas", "cuda", "mlp", fourier_features=4) == "xla"

    js, _ = _pair(tmp_path)
    path = js.save("fourier.ckpt", directory=str(tmp_path))
    ps = PINNSolver(**{**ARCH, "seed": 1}, engine="pallas", device="cpu")
    assert ps.engine == "xla"
    ps.load(path)
    g = np.linspace(0.0, 1.0, 21, dtype=np.float32)
    x, y = (a.reshape(-1) for a in np.meshgrid(g, g))
    ref = np.concatenate([np.asarray(a) for a in js.neural_net_u(x, y)[:3]], axis=1)
    got = np.concatenate([t.numpy() for t in ps.neural_net_u(x, y)[:3]], axis=1)
    assert ref.shape == got.shape == (441, 3)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    for kw in (dict(fourier_features=0), dict(fourier_features=3)):
        other = PINNSolver(**{**ARCH, **kw}, device="cpu")
        with pytest.raises(ValueError, match="architecture does not match"):
            other.load(path)
    own = ps.save("own.ckpt", directory=str(tmp_path))
    PINNSolver(**ARCH, device="cpu").load(own)
    with pytest.raises(ValueError, match="fourier_sigma"):
        PINNSolver(**{**ARCH, "fourier_sigma": 3.0}, device="cpu").load(own)


@pytest.mark.parametrize("formulation", ["velocity", "streamfunction"])
def test_lm_matches_jax_in_float64(tmp_path, x64, formulation):
    """LM on a Fourier ev-NSFnet (m 4, sigma 2): the solver's residual (the
    generic nested-jvp engine, so each Gauss-Newton product is one more
    level of forward mode over it) through run_lm against the JAX
    package's run_lm on the JAX solver's engine for that net, float64, JAX's
    B in both: params, history and damping within 1e-9. The residual and
    its jvp agree to 1e-15 of their scale, but J^T J is so ill-conditioned
    here (third derivatives of a sigma-2 embedding) that CG loses its
    Krylov basis's orthogonality: fp32 LM parts by % of the loss between
    the packages at any cg_iters, and float64 at 10 iterations too
    (measured, streamfunction: 3% of the loss from a fresh net). 5 CG
    iterations keep float64 at 1e-12. Then the solver's own train_lm,
    float32: 2 steps lower the loss."""
    ps = PINNSolver(**ARCH, formulation=formulation, checkpoint_path=str(tmp_path),
                    device="cpu")
    m, sigma = ARCH["fourier_features"], ARCH["fourier_sigma"]
    jb_matrix = jmlp.fourier_b_matrix(2, m, sigma, 0)
    with torch.no_grad():
        ps.net.b_matrix.copy_(torch.from_numpy(np.array(jb_matrix)))
    pd = CavityData(**DATA)
    ps.set_boundary_data(X=pd.boundary_data())
    ps.set_eq_training_data(X=pd.training_data(), weights=pd.sdf_weights)
    ps.set_coordinate_transform(pd.coord_scale)
    ps.train(num_epoch=2, lr=1e-3)
    f64 = lambda t: t.double() if torch.is_tensor(t) else t
    pb, pv = Batch(*map(f64, ps._batch)), ps.state.vis_t_minus.double()
    kw = dict(coord_scale=ps.coord_scale, alpha_e=ps.alpha_e, alpha_s=ps.alpha_s,
              entropy_weight=ps.entropy_residual_weight, evm=True)
    res = make_residual_fn(engine=ps._engine("xla"), apply_main=ps._uvp_apply(),
                           apply_evm=ps._apply_evm(), **kw)
    w0, split = ps._flat_state()
    sc = ps._stage_scalars(1.0)
    cg, steps = 5, 2
    w, h, lam = run_lm(lambda w_: res(split(w_), pb, pv, sc), w0.double(), steps, cg_iters=cg)

    jnet = jmlp.MLP(num_ins=2, num_outs=ps.net.sizes[-1], num_layers=ARCH["layers"],
                    hidden_size=ARCH["hidden_size"], fourier_features=m, fourier_sigma=sigma)
    japply = jnet.apply
    if formulation == "streamfunction":
        s_ = ps.coord_scale
        jengine = lambda p, x: jd.psi_p_derivatives_2d(lambda z: japply(p, z), x, s_)
        juvp = lambda p, x: jd.psi_p_uv(lambda z: japply(p, z), x, s_)
    else:
        jengine = lambda p, x: jd.derivatives_2d(lambda z: japply(p, z), x)
        juvp = japply
    jres = jax_make_residual_fn(engine=jengine, apply_main=juvp, apply_evm=jmlp.mlp_apply, **kw)
    to64 = lambda a: jnp.asarray(a.numpy() if torch.is_tensor(a) else a, jnp.float64)
    jbatch = JaxBatch(**{k: None if v is None else to64(v) for k, v in pb._asdict().items()})
    jp = tuple(tuple(tuple(map(to64, wb)) for wb in params_to_numpy(net))
               for net in (ps.params(), ps.params_evm()))
    jsc = JaxStageScalars(*map(to64, sc))
    jw, jh, jlam = jax_lm.run_lm(lambda pa: jres(pa, jbatch, to64(pv), jsc), jp, steps,
                                 cg_iters=cg)
    assert np.asarray(jh)[-1] < np.asarray(jh)[0]
    np.testing.assert_allclose(w.numpy(), np.asarray(ravel_pytree(jw)[0]), rtol=0, atol=1e-9)
    np.testing.assert_allclose(np.asarray(h), np.asarray(jh), rtol=1e-9)
    assert lam == pytest.approx(float(jlam), rel=1e-12)

    with torch.no_grad():
        start = float((res(split(w0), ps._batch, ps.state.vis_t_minus, sc) ** 2).sum())
    ps.train_lm(2, cg_iters=cg)
    hist = ps.polish_stats["history"]
    assert np.all(np.isfinite(hist)) and hist[-1] < start
