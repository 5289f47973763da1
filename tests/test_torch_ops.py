"""PyTorch port: residuals, losses and the fused residual-loss engine against
the JAX package.

The port's fused loss runs its plain version here (CPU tensors); the JAX
fused loss runs its Pallas kernel in interpret mode, as the JAX package's
own tests do. The kernels themselves are held against the plain version on
the card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsfnet_tpu.models.mlp import init_mlp as jax_init_mlp
from nsfnet_tpu.models.mlp import mlp_apply as jax_mlp_apply
from nsfnet_tpu.ops import losses as JL
from nsfnet_tpu.ops import residuals as JR
from nsfnet_tpu.ops.derivatives import mlp_derivatives_2d as jax_mlp_derivatives_2d
from nsfnet_tpu.ops.pallas_residual import make_fused_residual_loss
from nsfnet_tpu.training.state import Batch as JBatch
from nsfnet_tpu.training.step import StageScalars as JStageScalars
from nsfnet_tpu.training.step import make_loss_fn as jax_make_loss_fn
from nsfnet_tpu_torch.models.convert import params_from_numpy
from nsfnet_tpu_torch.models.mlp import flatten_params, layer_sizes, mlp_apply, unflatten_params
from nsfnet_tpu_torch.ops import fused_residual as fr
from nsfnet_tpu_torch.ops import losses as L
from nsfnet_tpu_torch.ops import mlp_streams as ms
from nsfnet_tpu_torch.ops import psi_streams as psi
from nsfnet_tpu_torch.ops import residuals as R
from nsfnet_tpu_torch.ops.derivatives import mlp_derivatives_2d
from nsfnet_tpu_torch.training.state import Batch
from nsfnet_tpu_torch.training.step import StageScalars, make_loss_fn
from nsfnet_tpu_torch.utils import profiling

torch.set_num_threads(2)


def _inputs(n, seed=0, tail=37):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, (n, 2)).astype(np.float32)
    e = (0.1 * rng.standard_normal((n, 1))).astype(np.float32)
    vis_t = np.abs(0.01 * rng.standard_normal((n, 1))).astype(np.float32)
    eq_w = rng.uniform(0.2, 1.8, (n, 1)).astype(np.float32)
    eq_w[-tail:] = 0.0  # zero-weight padded tail
    return x, e, vis_t, eq_w


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ residuals


@pytest.mark.parametrize("evm", [True, False])
def test_residuals_match_jax(x64, evm):
    jp = jax_init_mlp(jax.random.PRNGKey(2), (2, 16, 16, 3), dtype=jnp.float64)
    x, e, vis_t, _ = (a.astype(np.float64) for a in _inputs(48, seed=2))
    derivs = jax_mlp_derivatives_2d(jp, jnp.asarray(x))
    tderivs = tuple(_t(d) for d in derivs)
    if evm:
        ref = JR.ev_ns_residuals(derivs, jnp.asarray(e), jnp.asarray(vis_t), 250.0, 2.0)
        got = R.ev_ns_residuals(tderivs, _t(e), _t(vis_t), 250.0, 2.0)
        names = ("eq1", "eq2", "eq3", "eq4")
    else:
        ref = JR.ns_residuals(derivs, 250.0, 2.0)
        got = R.ns_residuals(tderivs, 250.0, 2.0)
        names = ("eq1", "eq2", "eq3")
        assert got.eq4 is None
    for k in names:
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(ref, k)),
                                   rtol=1e-12, atol=1e-14)  # same fp64 algebra


def test_vis_t_carry_matches_jax():
    _, e, vis_t, _ = _inputs(40, seed=4)
    np.testing.assert_array_equal(R.next_vis_t(_t(vis_t * 3), 0.01).numpy(),
                                  np.asarray(JR.next_vis_t(jnp.asarray(vis_t * 3), 0.01)))
    e_t = _t(e).requires_grad_(True)
    carry = R.update_vis_t_minus(e_t, 0.05)
    assert not carry.requires_grad  # detached, like stop_gradient
    np.testing.assert_allclose(carry.numpy(), np.asarray(JR.update_vis_t_minus(
        jnp.asarray(e), jnp.float32(0.05))), rtol=1e-7)


# --------------------------------------------------------------- losses


def test_losses_match_jax():
    x, e, vis_t, w = _inputs(64, seed=6)
    r = x[:, :1]
    count = float((w > 0).sum())
    np.testing.assert_allclose(L.masked_sum_sq(_t(r), _t(w)).item(),
                               float(JL.masked_sum_sq(jnp.asarray(r), jnp.asarray(w))),
                               rtol=1e-6)
    np.testing.assert_allclose(L.masked_mean_sq(_t(r), _t(w), count).item(),
                               float(JL.masked_mean_sq(jnp.asarray(r), jnp.asarray(w), count)),
                               rtol=1e-6)
    got = L.boundary_loss(_t(x[:, :1]), _t(x[:, 1:]), _t(e), _t(vis_t), _t(w), count)
    ref = JL.boundary_loss(*(jnp.asarray(a) for a in (x[:, :1], x[:, 1:], e, vis_t, w)), count)
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)  # fp32 sums, 64 terms

    for evm in (True, False):
        res = R.Residuals(_t(x[:, :1]), _t(x[:, 1:]), _t(e), _t(vis_t) if evm else None)
        jres = JR.Residuals(*(jnp.asarray(a) for a in (x[:, :1], x[:, 1:], e)),
                            jnp.asarray(vis_t) if evm else None, None, jnp.asarray(x))
        tot, parts = L.equation_loss(res, _t(w), count, 0.1)
        jtot, jparts = JL.equation_loss(jres, jnp.asarray(w), count, 0.1)
        np.testing.assert_allclose(tot.item(), float(jtot), rtol=1e-6)
        np.testing.assert_allclose([p.item() for p in parts],
                                   [float(p) for p in jparts], rtol=1e-6)


def test_masked_l2_norm_matches_jax():
    x, _, _, w = _inputs(64, seed=7)
    r = x[:, :1]
    np.testing.assert_allclose(L.masked_l2_norm(_t(r), _t(w)).item(),
                               float(JL.masked_l2_norm(jnp.asarray(r), jnp.asarray(w))),
                               rtol=1e-6)  # fp32 sum of 64 terms, then a root
    # the 1e-30 under the root: a zero residual has a finite (zero) gradient
    z = torch.zeros(8, 1, requires_grad=True)
    (g,) = torch.autograd.grad(L.masked_l2_norm(z, torch.ones(8, 1)), [z])
    assert torch.isfinite(g).all() and torch.count_nonzero(g) == 0


# ------------------------------------------------------------ fused loss

FUSED_CASES = {
    # name: (sizes, n, coord_scale, Re, evm)
    "evm": ((2, 32, 32, 32, 3), 512, 2.0, 100.0, True),
    "evm_multi_tile": ((2, 16, 16, 3), 1024, 1.0, 3000.0, True),
    "vanilla": ((2, 24, 24, 3), 512, 2.0, 400.0, False),
}


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_loss_matches_jax_pallas(case):
    sizes, n, scale, re, evm = FUSED_CASES[case]
    jp = jax_init_mlp(jax.random.PRNGKey(11), sizes)
    x, e, vis_t, w = _inputs(n, seed=11)
    ct = np.array([0.7, 1.3, 0.9, 0.4][: 4 if evm else 3], np.float32)
    jfused = make_fused_residual_loss("highest", scale, evm)  # interpret mode on CPU
    jx, je, jv, jw = (jnp.asarray(a) for a in (x, e, vis_t, w))

    if evm:
        jfn = lambda p, ee: jnp.sum(jfused(p, jx, ee, jv, jw, jnp.float32(re)) * ct)
        jsums = jfused(jp, jx, je, jv, jw, jnp.float32(re))
        jgp, jge = jax.grad(jfn, argnums=(0, 1))(jp, je)
    else:
        jfn = lambda p: jnp.sum(jfused(p, jx, jw, jnp.float32(re)) * ct)
        jsums = jfused(jp, jx, jw, jnp.float32(re))
        jgp, jge = jax.grad(jfn)(jp), None

    flat = flatten_params(params_from_numpy(jp)).requires_grad_(True)
    et = _t(e).requires_grad_(True)
    sums = fr.fused_residual_loss(flat, sizes, _t(x), et if evm else None,
                                  _t(vis_t) if evm else None, _t(w), re,
                                  coord_scale=scale, evm=evm, precision="highest")
    # the JAX package's bar between its kernel and its XLA engine
    # (tests/test_pallas_residual.py:55-61)
    np.testing.assert_allclose(sums.detach().numpy(), np.asarray(jsums), rtol=2e-5, atol=1e-7)

    grads = torch.autograd.grad((sums * _t(ct)).sum(), [flat, et] if evm else [flat])
    for (gw, gb), (rw, rb) in zip(unflatten_params(grads[0], sizes), jgp):
        # gradient bar: fp32 reverse sweeps in another order (rtol 5e-4 / atol 5e-6)
        np.testing.assert_allclose(gw.numpy(), np.asarray(rw), rtol=5e-4, atol=5e-6)
        np.testing.assert_allclose(gb.numpy(), np.asarray(rb), rtol=5e-4, atol=5e-6)
    if evm:
        np.testing.assert_allclose(grads[1].numpy(), np.asarray(jge), rtol=5e-4, atol=5e-6)
        assert np.all(grads[1].numpy()[-37:] == 0.0)  # zero-weight tail: no cotangent


def test_fused_loss_cpu_path_launches_no_kernel():
    fr.reset_launch_counts()
    sizes = (2, 8, 8, 3)
    flat = flatten_params(params_from_numpy(jax_init_mlp(jax.random.PRNGKey(0), sizes)))
    x, e, vis_t, w = (_t(a) for a in _inputs(64, tail=3))
    s = fr.fused_residual_loss(flat, sizes, x, e, vis_t, w, 100.0)
    assert s.shape == (4,) and torch.isfinite(s).all()
    assert fr.launch_counts == {"fused_residual_fwd": 0, "fused_residual_bwd": 0}
    with pytest.raises(ValueError):
        fr.fused_residual_loss(flat, sizes, x, e, vis_t, w, 100.0, precision="bf16")


def test_partial_reduce_counter_is_registered_and_idle_on_the_cpu():
    """The backward kernels count the floats they reduce into their gradient
    partials, read through the recorder as `partial_reduce.<kernel>`; the
    plain version on the CPU reduces nothing."""
    for mod in (fr, ms, psi):
        mod.reset_launch_counts()
    sizes = (2, 8, 8, 3)
    flat = flatten_params(params_from_numpy(jax_init_mlp(jax.random.PRNGKey(0), sizes)))
    flat.requires_grad_(True)
    x, e, vis_t, w = (_t(a) for a in _inputs(64, tail=3))
    fr.fused_residual_loss(flat, sizes, x, e, vis_t, w, 100.0).sum().backward()
    assert flat.grad is not None and torch.isfinite(flat.grad).all()
    counts = profiling.counts()
    assert {k: counts[f"partial_reduce.{k}"] for mod in (fr, ms, psi)
            for k in mod.partial_reduce} == {
        "fused_residual_bwd": 0, "mlp_streams_bwd": 0, "psi_streams_bwd": 0}


def test_fused_loss_never_falls_back_off_the_cpu():
    """A tensor that is neither on the CPU nor on a card goes to the kernel
    wrapper, which refuses it instead of running the plain version."""
    sizes = (2, 8, 8, 3)
    flat = torch.zeros(sum(i * o + o for i, o in zip(sizes[:-1], sizes[1:])), device="meta")
    x = torch.zeros((64, 2), device="meta")
    col = torch.zeros((64, 1), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fr.fused_residual_loss(flat, sizes, x, col, col, col, 100.0)


def test_tile_choice_and_bounds_accounting():
    # kernels 1+2: 32-point tiles where they fit, a ragged last tile masked
    assert fr.LOSS_TILES == (32, 16) and fr.LOSS_BLOCKS == 132
    assert fr.pick_loss_tile(80, "high") == (32, 80)  # the whole weight, one block per SM
    assert fr.loss_smem_bytes(32, 80, 80, 2) == 180_032  # two 28,160 B weight slots
    assert fr.pick_loss_tile(80, "highest") == (32, 80)
    assert fr.pick_loss_tile(80, "default") == (32, 80)
    # every width the configs and tests use launches at "high" (the configs' name)
    for h, tiling in {16: (32, 16), 24: (32, 32), 112: (32, 112), 120: (32, 64),
                      160: (16, 160), 224: (16, 32), 288: (16, 16)}.items():
        assert fr.pick_loss_tile(h, "high") == tiling, h
        assert fr.loss_smem_bytes(*tiling, h, 2) <= fr._MAX_SMEM
        tile, panel = tiling
        assert fr.ROW_ALIGN % 16 == 0 and panel % 16 == 0 and (-(-h // 16) * 16) % panel == 0
    with pytest.raises(ValueError):
        fr.pick_loss_tile(300, "high")
    with pytest.raises(ValueError):  # six passes need a third part: the widest do not fit
        fr.pick_loss_tile(224, "highest")
    fwd, bwd = fr.flop_counts(layer_sizes(2, 3, 6, 80), 120_000)
    assert fwd == 120_000 * (5 * 5 * 2 * 80 * 80 + 5 * 2 * 80 * 3)  # ~0.32 MFLOP/point
    assert bwd == 3 * fwd
    # the pass counts: bf16 products issued per fp32 product
    assert [fr.passes(p) for p in ("default", "high", "highest")] == [1, 3, 6]
    b_fwd, b_bwd = fr.byte_counts(layer_sizes(2, 3, 6, 80), 120_000, True)
    assert b_fwd == 120_000 * 20 + 4 * 32883 + 16
    assert b_bwd == b_fwd + 4 * 32883 + 4 * 120_000
    # kernel 2's own traffic at the flagship size: the tape and the partial
    t = fr.bwd_traffic(layer_sizes(2, 3, 6, 80), 120_000, "high")
    assert t["tape_written"] == 3750 * 32 * 80 * 4 * 26  # t0 + 5 x (t, 4 tangents)
    assert t["tape_read"] == t["tape_written"] + 3750 * 32 * 80 * 4 * 21
    assert t["partial_rmw"] == 3750 * 32883 * 8
    assert t["cuda_core_scratch_written"] == 120_000 * 50 * 80 * 4  # 1.92 GB
    assert t["cuda_core_partial_rmw"] == 7500 * 32883 * 8  # 1.97 GB
    # the split weights, staged once per product layer by the recompute and
    # once by the reverse sweep, every tile: 2 parts of 2 bytes at "high"
    assert t["weights_staged"] == 3750 * 10 * 2 * 80 * 80 * 2  # 0.96 GB
    t = fr.bwd_traffic(layer_sizes(2, 3, 6, 160), 120_000, "high")
    assert t["partial_rmw"] == 7500 * 129_763 * 8  # 7.79 GB: the 6x160 campaign step
    assert t["weights_staged"] == 7500 * 10 * 2 * 160 * 160 * 2  # 7.68 GB


# The resident plans of kernels 1-4 as whole-panel staging chose them, and
# the weight ring each takes: (tile, panel), (depth, K-extent), by width and
# name ("highest" at 224 and 288 takes the streamed plan).
RING_PLANS = {
    (80, "highest"): ((32, 80), (2, 16)), (80, "high"): ((32, 80), (2, 80)),
    (80, "default"): ((32, 80), (2, 80)),
    (120, "highest"): ((16, 64), (2, 64)), (120, "high"): ((32, 64), (2, 64)),
    (120, "default"): ((32, 128), (2, 128)),
    (160, "highest"): ((16, 32), (2, 80)), (160, "high"): ((16, 160), (2, 80)),
    (160, "default"): ((32, 160), (2, 160)),
    (224, "high"): ((16, 32), (2, 224)), (224, "default"): ((32, 112), (1, 224)),
    (288, "high"): ((16, 16), (2, 144)), (288, "default"): ((32, 32), (2, 144))}


@pytest.mark.parametrize("h", [80, 120, 160, 224, 288])
def test_weight_ring_slots_leave_the_plans_as_they_were(h):
    """The ring's slot rule (tc_mlp.cuh tc_ring, its twin `ring_plan`):
    the plan is the one whole-panel staging chose, and the ring takes two
    slots of the widest K-extent that fits beside it (a multiple of 16
    dividing the padded width; below the whole panel only where each warp
    has at most one unit), else one slot of the whole panel, whose block is
    that of whole-panel staging."""
    hp = -(-h // 16) * 16
    for name in fr.PRECISIONS:
        parts = fr.PARTS[name]
        if (h, name) not in RING_PLANS:
            assert fr.loss_plan(h, name).streamed
            continue
        plan, ring = RING_PLANS[(h, name)]
        assert fr.pick_loss_tile(h, name) == ms.pick_bwd_tile(h, name) == plan
        assert fr.ring_plan(*plan, h, parts) == ring
        (tile, panel), (depth, kx) = plan, ring
        cut = (tile // 16) * (panel // 16) <= fr.TC_WARPS  # at most one unit a warp
        extents = [k for k in range(16, hp + 1, 16) if hp % k == 0 and (k == hp or cut)]
        assert kx in extents
        rest = fr._resident_rest(tile, h, parts, 3)
        smem = fr.loss_smem_bytes(tile, panel, h, parts)
        assert smem <= fr._MAX_SMEM
        assert smem == rest + depth * fr._slot_bytes(panel, kx, parts)
        fits = [k for k in extents if rest + 2 * fr._slot_bytes(panel, k, parts) <= fr._MAX_SMEM]
        assert (depth, kx) == ((2, max(fits)) if fits else (1, hp))
    # the benchmark's two widths at "high": 2 x 80 rows / columns a slot
    assert fr.ring_plan(32, 80, 80, 2) == (2, 80) and fr.ring_plan(16, 160, 160, 2) == (2, 80)
    assert fr.loss_smem_bytes(16, 160, 160, 2) == 229_056


def test_weight_ring_counters_of_one_launch_at_6x160():
    """`weight_stream` of one launch of kernels 1 and 2 at 6x160 / N =
    120,000, "high": 7,500 tiles of 16 points, 5 product layers (10 in the
    backward), 2 K-slots of 80 a product; all but each of the 132 blocks'
    first loaded while a product ran. The counters are registered and idle
    on the CPU, where the plain version runs."""
    sizes, n = layer_sizes(2, 3, 6, 160), 120_000
    plan = fr.loss_plan(160, "high")
    assert plan == fr.Plan(16, 160)
    assert fr.weight_stream(sizes, n, plan, "high") == (75_000, 74_868)
    assert fr.weight_stream(sizes, n, plan, "high", reverse=True) == (150_000, 149_868)
    # depth 1 (224 at "default") and the streamed plan prefetch nothing
    s224 = layer_sizes(2, 3, 6, 224)
    assert fr.weight_stream(s224, n, fr.loss_plan(224, "default"), "default", True) == (
        3750 * 10 * 2, 0)
    s352 = layer_sizes(2, 3, 6, 352)
    p352 = fr.loss_plan(352, "high")
    assert p352.streamed and fr.weight_stream(s352, n, p352, "high") == (
        7500 * 5 * 3 * 3, 0)  # N-panels of 128, 128, 96; K-panels of 128
    for mod in (fr, ms):
        mod.reset_launch_counts()
    slots, pre = {"k": 0}, {"k": 0}
    fr.count_weight_stream(slots, pre, "k", sizes, n, plan, "high", True)
    fr.count_weight_stream(slots, pre, "k", sizes, n, plan, "high", True)
    assert (slots, pre) == ({"k": 300_000}, {"k": 299_736})
    flat = flatten_params(params_from_numpy(jax_init_mlp(jax.random.PRNGKey(0), (2, 8, 8, 3))))
    flat.requires_grad_(True)
    x, e, vis_t, w = (_t(a) for a in _inputs(64, tail=3))
    fr.fused_residual_loss(flat, (2, 8, 8, 3), x, e, vis_t, w, 100.0).sum().backward()
    counts = profiling.counts()
    for what in ("weight_slots", "weight_prefetch"):
        assert {k: counts[f"{what}.{k}"] for k in (*fr.launch_counts, *ms.launch_counts)} == {
            "fused_residual_fwd": 0, "fused_residual_bwd": 0, "mlp_streams_fwd": 0,
            "mlp_streams_bwd": 0}


# ------------------------------------------------------------ loss fn


def test_loss_fn_engine_and_fused_branches_match_jax():
    sizes, sizes_1 = (2, 16, 16, 3), (2, 8, 1)
    jp = jax_init_mlp(jax.random.PRNGKey(8), sizes)
    jpe = jax_init_mlp(jax.random.PRNGKey(9), sizes_1)
    x, e, vis_t, w = _inputs(256, seed=8, tail=16)
    rng = np.random.default_rng(9)
    xb = rng.uniform(0, 1, (64, 2)).astype(np.float32)
    ub = rng.uniform(0, 1, (64, 2)).astype(np.float32)
    bm = np.ones((64, 1), np.float32)
    bm[-4:] = 0.0
    n_f, n_b = 240.0, 60.0
    jbatch = JBatch(*(jnp.asarray(a) for a in (x[:, :1], x[:, 1:], w)), jnp.float32(n_f),
                    *(jnp.asarray(a) for a in (xb[:, :1], xb[:, 1:], ub[:, :1], ub[:, 1:], bm)),
                    jnp.float32(n_b))
    jloss = jax_make_loss_fn(jax_mlp_derivatives_2d, jax_mlp_apply, jax_mlp_apply, 2.0, 1.0,
                             0.0, 0.1, True)
    jsc = JStageScalars(*(jnp.float32(v) for v in (1e-3, 0.05, 500.0, 10.0)))
    jtotal, (jm, jvtm) = jloss((jp, jpe), jbatch, jnp.asarray(vis_t), jsc)

    batch = Batch(*(_t(a) for a in (x[:, :1], x[:, 1:], w)), n_f,
                  *(_t(a) for a in (xb[:, :1], xb[:, 1:], ub[:, :1], ub[:, 1:], bm)), n_b)
    flat = flatten_params(params_from_numpy(jp))
    flat_e = flatten_params(params_from_numpy(jpe))
    apply = lambda s: (lambda f, z: mlp_apply(unflatten_params(f, s), z))
    sc = StageScalars(1e-3, 0.05, 500.0, 10.0)
    engine = lambda f, z: mlp_derivatives_2d(unflatten_params(f, sizes), z)
    fused = lambda f, z, ee, vt, ww, re: fr.fused_residual_loss(
        f, sizes, z, ee, vt, ww, re, coord_scale=2.0, evm=True)
    for kw in (dict(engine=engine), dict(engine=None, fused_eq_loss=fused)):
        loss = make_loss_fn(apply_main=apply(sizes), apply_evm=apply(sizes_1),
                            coord_scale=2.0, alpha_e=1.0, entropy_weight=0.1, evm=True, **kw)
        total, (m, vtm) = loss((flat, flat_e), batch, _t(vis_t), sc)
        # fp32 on both sides, sums over 256 points in another order
        np.testing.assert_allclose([v.item() for v in m], [float(v) for v in jm], rtol=2e-5,
                                   atol=1e-9)
        # alpha*|e|: an fp32 network output, so near-zero entries carry
        # relative error; compare them to an absolute floor
        np.testing.assert_allclose(vtm.numpy(), np.asarray(jvtm), rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("evm", [True, False], ids=["evm", "vanilla"])
def test_l2_loss_fn_matches_jax(evm):
    """loss_mode L2, the reference v1's un-normalised norms: metrics and
    the main-net gradient against the JAX loss function."""
    sizes, sizes_1 = (2, 16, 16, 3), (2, 8, 1)
    jp = jax_init_mlp(jax.random.PRNGKey(8), sizes)
    jpe = jax_init_mlp(jax.random.PRNGKey(9), sizes_1) if evm else None
    x, _, vis_t, w = _inputs(256, seed=12, tail=16)
    rng = np.random.default_rng(13)
    xb = rng.uniform(0, 1, (64, 2)).astype(np.float32)
    ub = rng.uniform(0, 1, (64, 2)).astype(np.float32)
    bm = np.ones((64, 1), np.float32)
    bm[-4:] = 0.0
    n_f, n_b = 240.0, 60.0
    jbatch = JBatch(*(jnp.asarray(a) for a in (x[:, :1], x[:, 1:], w)), jnp.float32(n_f),
                    *(jnp.asarray(a) for a in (xb[:, :1], xb[:, 1:], ub[:, :1], ub[:, 1:], bm)),
                    jnp.float32(n_b))
    jloss = jax_make_loss_fn(jax_mlp_derivatives_2d, jax_mlp_apply,
                             jax_mlp_apply if evm else None, 2.0, 1.0, 0.0, 0.1, evm,
                             loss_mode="L2")
    jsc = JStageScalars(*(jnp.float32(v) for v in (1e-3, 0.05, 500.0, 10.0)))
    jvt = jnp.asarray(vis_t) if evm else None
    (_, (jm, _)), jg = jax.value_and_grad(
        lambda p: jloss((p, jpe), jbatch, jvt, jsc), has_aux=True)(jp)

    batch = Batch(*(_t(a) for a in (x[:, :1], x[:, 1:], w)), n_f,
                  *(_t(a) for a in (xb[:, :1], xb[:, 1:], ub[:, :1], ub[:, 1:], bm)), n_b)
    flat = flatten_params(params_from_numpy(jp)).requires_grad_(True)
    flat_e = flatten_params(params_from_numpy(jpe)) if evm else None
    apply = lambda s: (lambda f, z: mlp_apply(unflatten_params(f, s), z))
    engine = lambda f, z: mlp_derivatives_2d(unflatten_params(f, sizes), z)
    kw = dict(engine=engine, apply_main=apply(sizes), apply_evm=apply(sizes_1) if evm else None,
              coord_scale=2.0, alpha_e=1.0, entropy_weight=0.1, evm=evm)
    loss = make_loss_fn(**kw, loss_mode="L2")
    total, (m, _) = loss((flat, flat_e), batch, _t(vis_t) if evm else None,
                         StageScalars(1e-3, 0.05, 500.0, 10.0))
    # fp32 on both sides, sums over 256 points in another order
    np.testing.assert_allclose([v.item() for v in m], [float(v) for v in jm], rtol=2e-5,
                               atol=1e-9)
    # no 1/n: the L2 boundary loss is the norms' sum, not the MSE mode's means
    mse_total, (mse, _) = make_loss_fn(**kw)((flat, flat_e), batch,
                                             _t(vis_t) if evm else None,
                                             StageScalars(1e-3, 0.05, 500.0, 10.0))
    assert m.boundary.item() > 5 * mse.boundary.item()
    (g,) = torch.autograd.grad(total, [flat])
    for (gw, gb), (rw, rb) in zip(unflatten_params(g, sizes), jg):
        np.testing.assert_allclose(gw.numpy(), np.asarray(rw), rtol=5e-4, atol=5e-6)
        np.testing.assert_allclose(gb.numpy(), np.asarray(rb), rtol=5e-4, atol=5e-6)


def test_l2_loss_fn_refuses_the_fused_loss_and_unknown_modes():
    kw = dict(engine=None, apply_main=None, apply_evm=None, coord_scale=1.0, alpha_e=1.0)
    with pytest.raises(ValueError, match="MSE-mode only"):
        make_loss_fn(**kw, loss_mode="L2", fused_eq_loss=lambda *a: None)
    with pytest.raises(ValueError, match="loss_mode"):
        make_loss_fn(**kw, loss_mode="L1")
