"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version at small sizes, bitwise determinism, and the autograd wiring.

Marked `gpu`; every test skips (from its fixture) where no CUDA card is
present. On the card: `python -m pytest tests/test_torch_gpu.py -m gpu`.
"""

import ctypes

import numpy as np
import pytest
import torch

from nsfnet_tpu_torch.models.mlp import flatten_params, init_mlp, unflatten_params
from nsfnet_tpu_torch.ops import fused_residual as fr
from nsfnet_tpu_torch.ops import losses as L
from nsfnet_tpu_torch.ops import mlp_streams as ms
from nsfnet_tpu_torch.ops import pass_checks as pc
from nsfnet_tpu_torch.ops import psi_residual as pr
from nsfnet_tpu_torch.ops import psi_streams as psi
from nsfnet_tpu_torch.ops import residuals as R
from nsfnet_tpu_torch.training.solver import PINNSolver

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # exact fp32 plain version
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = old


def _inputs(sizes, n, dev, seed=0):
    rng = np.random.default_rng(seed)
    flat = flatten_params(init_mlp(sizes, torch.Generator().manual_seed(seed)))
    x = rng.uniform(-1, 1, (n, 2))
    e = 0.1 * rng.standard_normal((n, 1))
    vis_t = np.abs(0.01 * rng.standard_normal((n, 1)))
    w = rng.uniform(0.2, 1.8, (n, 1))
    w[-37:] = 0.0
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()
    return flat.to(dev), t(x), t(e), t(vis_t), t(w)


# (sizes, n, coord_scale, Re, evm): widths 16 / 24 / 80 / 120, a one-layer
# net, EVM and vanilla; n = 528 and 1040 leave a ragged 16-point last tile
# after the 32-point tiles
CASES = [((2, 16, 16, 3), 528, 2.0, 100.0, True),
         ((2, 24, 24, 3), 512, 1.0, 400.0, False),
         ((2, 32, 32, 32, 3), 512, 2.0, 100.0, True),
         ((2, 80, 80, 80, 3), 1040, 1.0, 2000.0, True),
         ((2, 120, 120, 120, 3), 528, 1.0, 400.0, False),
         ((2, 16, 3), 272, 1.0, 100.0, True)]
# max|diff| / max|plain| per sum and per gradient tensor, kernel against the
# plain version at the same name: only the order of fp32 sums differs, and at
# "default" a one-ulp bf16 flip where an fp32 carry lies on a rounding edge
TOL = {"highest": 2e-5, "high": 2e-5, "default": 1e-4}
# kernels 4 and 6 against random cotangents: at "default" a carry on a bf16
# rounding edge that flips moves the point's later carries by ~2^-8 and can
# flip more of them, and random cotangents sum with cancellation, so a few
# flipped points reach ~2e-4 of a gradient tensor's max (measured on the card)
BWD_TOL = {**TOL, "default": 5e-4}
# kernels 3 and 5, per stream against the plain version at the same name
# (max|diff| / max|plain|): only the order of fp32 sums differs, but a carry
# on a rounding edge of its last bf16 part flips and moves its point by about
# that part's last bit of one term: ~2^-16 at "high" (3.0e-5 measured at
# width 24), ~2^-8 at "default", which is held norm-wise (||diff|| /
# ||plain||) at the bar of ops/pass_checks.py (1.6e-4 measured here, up to
# 1.0e-3 at full width; PERF.md, section 6)
FWD_TOL = {**TOL, "high": 1e-4, "default": pc.DEFAULT_NORM_TOL}


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def _check_pair(cuda, sizes, n, scale, re, evm, precision, seed=0):
    flat, x, e, vis_t, w = _inputs(sizes, n, cuda, seed)
    if not evm:
        e = vis_t = None
    sums = fr.fused_fwd(flat, sizes, x, e, vis_t, w, re, scale, evm, precision)
    with torch.no_grad():
        ref = fr.plain_residual_sums(unflatten_params(flat, sizes), x, e, vis_t, w, re, scale,
                                     evm, precision)
    assert ((sums - ref).abs() / ref.abs()).max().item() <= TOL[precision], (sums, ref)
    ct = torch.tensor([0.7, 1.3, 0.9, 0.4][: 4 if evm else 3], device=cuda)
    dflat, g_e = fr.fused_bwd(flat, sizes, x, e, vis_t, w, re, ct, scale, evm, precision)
    fr_ = flat.clone().requires_grad_(True)
    targets = [fr_]
    if evm:
        e = e.clone().requires_grad_(True)
        targets.append(e)
    s = fr.plain_residual_sums(unflatten_params(fr_, sizes), x, e, vis_t, w, re, scale, evm,
                               precision)
    grads = torch.autograd.grad(s, targets, ct)
    for (kw, kb), (pw, pb) in zip(unflatten_params(dflat, sizes), unflatten_params(grads[0], sizes)):
        assert _rel(kw, pw) <= TOL[precision] and _rel(kb, pb) <= TOL[precision]
    if evm:
        assert _rel(g_e, grads[1]) <= TOL[precision]
        assert torch.all(g_e[-37:] == 0.0)  # zero-weight tail


@pytest.mark.parametrize("precision", fr.PRECISIONS)
@pytest.mark.parametrize("sizes,n,scale,re,evm", CASES)
def test_kernels_match_plain_version(cuda, sizes, n, scale, re, evm, precision):
    _check_pair(cuda, sizes, n, scale, re, evm, precision)


@pytest.mark.parametrize("h", [112, 160, 224, 288])
def test_wide_nets_launch_at_high(cuda, h):
    """The configs' widths: smaller tiles and weight panels, at "high"."""
    _check_pair(cuda, (2, h, h, 3), 528, 1.0, 2000.0, True, "high")


@pytest.mark.parametrize("h", [16, 40, 80, 120, 128, 160])
def test_tile_choice_agrees_with_the_library(cuda, h):
    # the tile rules size the blocks without the libraries; the sources own
    # the layouts, the weight ring's depth and K-extent among them
    hp = -(-h // 16) * 16
    kx, ring = ctypes.c_int(), fr._lib().nsf_fused_loss_ring
    ring.argtypes, ring.restype = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)], ctypes.c_int
    for parts in (1, 2, 3):
        for tile in fr.LOSS_TILES:
            for panel in range(16, hp + 1, 16):
                if hp % panel == 0:
                    assert (fr._lib().nsf_fused_loss_smem_bytes(tile, panel, h, 3, parts, 0)
                            == fr.loss_smem_bytes(tile, panel, h, parts))
                    depth = ring(tile, panel, h, 3, parts, ctypes.byref(kx))
                    assert (depth, kx.value) == fr.ring_plan(tile, panel, h, parts)
    for name in fr.PRECISIONS:
        assert fr.loss_smem_bytes(*fr.pick_loss_tile(h, name), h, fr.PARTS[name]) <= fr._MAX_SMEM
    # kernels 3 and 4 take the pair's rule (the five-stream library's count:
    # test_backward_tile_choice_agrees_with_the_library)
    for name in fr.PRECISIONS:
        assert fr.loss_smem_bytes(*ms.pick_bwd_tile(h, name), h, fr.PARTS[name]) <= fr._MAX_SMEM


@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("h", [80, 160])
@pytest.mark.parametrize("precision", fr.PRECISIONS)
def test_kernels_are_bitwise_deterministic(cuda, precision, h, streamed):
    """Kernel 2 adds every tile into its block's partial by reductions
    (tc_mlp.cuh red_add): with many tiles a block (32,768 points: 7-8 tiles
    of 32 or 15-16 of 16 on each of the 132 blocks), on either plan, two
    launches give the same bits."""
    sizes = (2, h, h, h, 3)
    plan = fr.Plan(16, 48, 32) if streamed else None
    flat, x, e, vis_t, w = _inputs(sizes, 32768, cuda, seed=1)
    ct = torch.tensor([1.0, 1.0, 1.0, 0.1], device=cuda)
    a = fr.fused_fwd(flat, sizes, x, e, vis_t, w, 2000.0, 1.0, True, precision, plan)
    b = fr.fused_fwd(flat, sizes, x, e, vis_t, w, 2000.0, 1.0, True, precision, plan)
    assert torch.equal(a, b)
    (d1, g1), (d2, g2) = (fr.fused_bwd(flat, sizes, x, e, vis_t, w, 2000.0, ct, 1.0, True,
                                       precision, plan) for _ in range(2))
    assert torch.equal(d1, d2) and torch.equal(g1, g2)


def test_autograd_function_launches_both_kernels(cuda):
    sizes = (2, 16, 16, 3)
    flat, x, e, vis_t, w = _inputs(sizes, 256, cuda, seed=2)
    flat.requires_grad_(True)
    e.requires_grad_(True)
    fr.reset_launch_counts()
    s = fr.fused_residual_loss(flat, sizes, x, e, vis_t, w, 100.0, precision="default")
    gflat, ge = torch.autograd.grad(s.sum(), [flat, e])
    assert fr.launch_counts == {"fused_residual_fwd": 1, "fused_residual_bwd": 1}
    # the name reaches the kernels: one bf16 pass is not the three of "high"
    with torch.no_grad():
        assert not torch.equal(s, fr.fused_fwd(flat, sizes, x, e, vis_t, w, 100.0, 1.0, True))
    assert gflat.shape == flat.shape and ge.shape == e.shape
    with pytest.raises(ValueError):  # unpadded batch: refused, no plain fallback
        fr.fused_residual_loss(flat, sizes, x[:250], e[:250], vis_t[:250], w[:250], 100.0)


def test_solver_on_the_card_matches_the_cpu(cuda):
    from nsfnet_tpu_torch.data.cavity import CavityData

    runs = []
    for dev in ("cuda", "cpu"):
        s = PINNSolver(Re=400, layers=3, layers_1=2, hidden_size=32, hidden_size_1=16,
                       N_f=500, evm_update_freq=2, log_interval=1, checkpoint_freq=10**9,
                       seed=3, device=dev)
        d = CavityData(N_f=500, sdf_enabled=True, sort_training_points=False, seed=1)
        s.set_boundary_data(X=d.boundary_data())
        s.set_eq_training_data(X=d.training_data(), weights=d.sdf_weights)
        s.train(num_epoch=4, lr=1e-3)
        runs.append(np.asarray([tuple(m) for _, m in s.loss_history]))
    np.testing.assert_allclose(runs[0], runs[1], rtol=1e-4, atol=1e-9)


# --------------------------------------------------------- stream engine

STREAM_CASES = [((2, 32, 32, 32, 3), 512), ((2, 120, 120, 120, 3), 1040), ((2, 40, 40, 1), 272)]


def _stream_inputs(sizes, n, dev, seed=0):
    flat, x, *_ = _inputs(sizes, n, dev, seed)
    gen = torch.Generator().manual_seed(seed + 100)
    cts = [torch.randn((n, sizes[-1]), generator=gen).to(dev) for _ in range(5)]
    return flat, x, cts


def _assert_grads_match_passes(dflat, ref, sizes, precision, tol=TOL):
    """Per gradient tensor, max|diff| / max|plain| within tol[precision]."""
    for (kw, kb), (pw, pb) in zip(unflatten_params(dflat, sizes), unflatten_params(ref, sizes)):
        assert _rel(kw, pw) <= tol[precision] and _rel(kb, pb) <= tol[precision], \
            (_rel(kw, pw), _rel(kb, pb))


def _assert_streams_match_passes(got, ref, precision):
    """Per stream within FWD_TOL[precision]: max|diff| / max|plain|, or at
    "default" ||diff|| / ||plain||."""
    assert len(got) == len(ref)
    errs = pc.norm_rels(got, ref) if precision == "default" else [
        _rel(g, r) for g, r in zip(got, ref)]
    assert max(errs) <= FWD_TOL[precision], errs


def _assert_forward_matches_passes(got, plain, precision):
    """A forward kernel's streams against plain(precision), the plain
    version at that name (_assert_streams_match_passes), each bar checked
    to tell the name from the next (ops/pass_checks.py): at "high" also
    within the smoke's bar of exact fp32 (plain(None)) and separated from
    it, where the plain "highest" passes are not (exact fp32 sits at 1 by
    construction); at "default" the plain "high" passes miss the norm-wise
    bar against the plain one pass."""
    with torch.no_grad():
        ref = plain(precision)
        _assert_streams_match_passes(got, ref, precision)
        if precision == "high":
            exact = plain(None)
            assert max(_rel(g, r) for g, r in zip(got, exact)) <= 1e-4
            assert pc.separation(got, ref, exact) <= pc.HIGH_SEP
            assert pc.separation(plain("highest"), ref, exact) > pc.HIGH_SEP
        if precision == "default":
            assert max(pc.norm_rels(plain("high"), ref)) > FWD_TOL["default"]


@pytest.mark.parametrize("sizes,n", STREAM_CASES)
def test_stream_kernels_match_plain_version(cuda, sizes, n):
    flat, x, cts = _stream_inputs(sizes, n, cuda)
    _assert_forward_matches_passes(ms.streams_fwd(flat, sizes, x, "high"),
                                   lambda at: ms.plain_mlp_streams(flat, sizes, x, at), "high")
    dflat = ms.streams_bwd(flat, sizes, x, cts, "high")
    _assert_grads_match_passes(dflat, ms.plain_mlp_streams_bwd(flat, sizes, x, cts, "high"),
                               sizes, "high")


# Kernel 4 at each name: widths 16 / 24 / 40 / 80 / 120, K = 1, 2, 3 and 5
# (a width without its own template), a one-hidden-layer net; n = 528, 1040
# and 272 leave a ragged last tile after the 32-point tiles.
STREAM_BWD_CASES = [((2, 16, 16, 3), 528), ((2, 24, 24, 2), 512), ((2, 40, 40, 40, 1), 272),
                    ((2, 80, 80, 80, 3), 1040), ((2, 120, 120, 120, 3), 528), ((2, 16, 3), 272),
                    ((2, 32, 32, 5), 512)]


@pytest.mark.parametrize("precision", fr.PRECISIONS)
@pytest.mark.parametrize("sizes,n", STREAM_BWD_CASES)
def test_stream_backward_matches_plain_passes(cuda, sizes, n, precision):
    flat, x, cts = _stream_inputs(sizes, n, cuda, seed=5)
    dflat = ms.streams_bwd(flat, sizes, x, cts, precision)
    _assert_grads_match_passes(dflat, ms.plain_mlp_streams_bwd(flat, sizes, x, cts, precision),
                               sizes, precision, BWD_TOL)
    if precision == "high":  # and within the smoke's bar of exact fp32
        exact = ms.plain_mlp_streams_bwd(flat, sizes, x, cts)
        for (kw, kb), (pw, pb) in zip(unflatten_params(dflat, sizes),
                                      unflatten_params(exact, sizes)):
            assert _rel(kw, pw) <= 1e-4 and _rel(kb, pb) <= 1e-4


@pytest.mark.parametrize("precision", fr.PRECISIONS)
@pytest.mark.parametrize("sizes,n", STREAM_BWD_CASES)
def test_stream_forward_matches_plain_passes(cuda, sizes, n, precision):
    flat, x, _ = _stream_inputs(sizes, n, cuda, seed=6)
    _assert_forward_matches_passes(ms.streams_fwd(flat, sizes, x, precision),
                                   lambda at: ms.plain_mlp_streams(flat, sizes, x, at), precision)


@pytest.mark.parametrize("precision", fr.PRECISIONS)
def test_stream_kernels_are_bitwise_deterministic(cuda, precision):
    sizes = (2, 120, 120, 120, 3)
    flat, x, cts = _stream_inputs(sizes, 8208, cuda, seed=1)  # a ragged last tile of 16
    a, b = ms.streams_fwd(flat, sizes, x, precision), ms.streams_fwd(flat, sizes, x, precision)
    assert all(torch.equal(s, t) for s, t in zip(a, b))
    assert torch.equal(ms.streams_bwd(flat, sizes, x, cts, precision),
                       ms.streams_bwd(flat, sizes, x, cts, precision))


def test_stream_autograd_takes_partial_and_strided_cotangents(cuda):
    """A loss on some streams and some columns: autograd hands the backward
    zeros for the unused streams and slice-scattered cotangents."""
    sizes = (2, 16, 16, 3)
    flat, x, _ = _stream_inputs(sizes, 256, cuda, seed=2)
    loss = lambda st: (st[1][:, 0:1] ** 2).mean() + (st[0][:, 2:3] * st[4][:, 0:1]).mean()
    flat.requires_grad_(True)
    ms.reset_launch_counts()
    (g,) = torch.autograd.grad(loss(ms.mlp_streams(flat, sizes, x)), [flat])
    assert ms.launch_counts == {"mlp_streams_fwd": 1, "mlp_streams_bwd": 1}
    # the plain version at the entry point's name, "high", forward and backward
    (ref,) = torch.autograd.grad(
        loss(fr.emulated_derivatives(unflatten_params(flat, sizes), x, fr.PARTS["high"])), [flat])
    torch.testing.assert_close(g, ref, rtol=5e-4, atol=2e-6)
    with pytest.raises(ValueError):  # unpadded batch: refused, no plain fallback
        ms.mlp_streams(flat, sizes, x[:250])


def test_precision_name_reaches_the_backward_kernels(cuda):
    """Through autograd, the entry points hand their name to kernels 4 and
    6: one bf16 pass is not the three of "high"."""
    for mod, engine, sizes in ((ms, ms.mlp_streams, (2, 16, 16, 3)),
                               (psi, psi.psi_streams, (2, 16, 16, 2))):
        flat, x, _ = _stream_inputs(sizes, 256, cuda, seed=3)
        flat.requires_grad_(True)
        grads = {}
        for name in ("default", "high"):
            mod.reset_launch_counts()
            bundle = engine(flat, sizes, x, precision=name)
            (grads[name],) = torch.autograd.grad(sum((b ** 2).sum() for b in bundle), [flat])
            assert all(v == 1 for v in mod.launch_counts.values()), mod.launch_counts
        assert not torch.equal(grads["default"], grads["high"])
        with pytest.raises(ValueError, match="precision"):
            engine(flat, sizes, x, precision="fp64")


def test_precision_name_reaches_the_forward_kernels(cuda):
    """The entry points hand their name to kernels 3 and 5: one bf16 pass is
    not the three of "high", and each name gives its plain version's passes."""
    for mod, engine, fwd, plain, sizes in (
            (ms, ms.mlp_streams, ms.streams_fwd, ms.plain_mlp_streams, (2, 16, 16, 3)),
            (psi, psi.psi_streams, psi.psi_fwd, psi.plain_psi_streams, (2, 16, 16, 2))):
        flat, x, _ = _stream_inputs(sizes, 256, cuda, seed=7)
        out = {}
        for name in ("default", "high"):
            mod.reset_launch_counts()
            with torch.no_grad():
                out[name] = engine(flat, sizes, x, precision=name)
                assert list(mod.launch_counts.values()) == [1, 0], mod.launch_counts
                raw = fwd(flat, sizes, x, name)
                _assert_streams_match_passes(raw, plain(flat, sizes, x, name), name)
        assert not all(torch.equal(a, b) for a, b in zip(out["default"], out["high"]))
        with pytest.raises(ValueError, match="precision"):
            fwd(flat, sizes, x, "fp64")


def _cavity_run(dev, **kw):
    from nsfnet_tpu_torch.data.cavity import CavityData

    s = PINNSolver(**{**dict(Re=400, layers=3, layers_1=2, hidden_size=32, hidden_size_1=16,
                             N_f=500, evm_update_freq=2, log_interval=1,
                             checkpoint_freq=10**9, seed=3, device=dev), **kw})
    d = CavityData(N_f=500, sdf_enabled=True, sort_training_points=False, seed=1)
    s.set_boundary_data(X=d.boundary_data())
    s.set_eq_training_data(X=d.training_data(), weights=d.sdf_weights)
    s.train(num_epoch=4, lr=1e-3)
    return np.asarray([tuple(m) for _, m in s.loss_history]), s.state.params.detach().cpu()


def test_unfused_engine_matches_fused_loss_on_the_card(cuda, monkeypatch):
    """N_f = 500 pads to 512: kernels 3+4 -> residuals -> masked sums
    against kernels 1+2, the same four Adam steps, both about exact fp32
    (all four kernels at "highest")."""
    monkeypatch.delenv("NSFNET_FUSED_LOSS", raising=False)
    fr.reset_launch_counts()
    fused, p_fused = _cavity_run("cuda", engine="pallas", matmul_precision="highest")
    assert fr.launch_counts == {"fused_residual_fwd": 4, "fused_residual_bwd": 4}
    monkeypatch.setenv("NSFNET_FUSED_LOSS", "0")
    fr.reset_launch_counts()
    ms.reset_launch_counts()
    unfused, p_unfused = _cavity_run("cuda", engine="pallas", matmul_precision="highest")
    assert ms.launch_counts == {"mlp_streams_fwd": 4, "mlp_streams_bwd": 4}
    assert not any(fr.launch_counts.values())
    np.testing.assert_allclose(unfused, fused, rtol=1e-4, atol=1e-9)
    torch.testing.assert_close(p_unfused, p_fused, rtol=0, atol=5e-6)


def test_l2_solver_on_the_card_matches_the_cpu(cuda):
    kw = dict(loss_mode="L2", evm=False, layers_1=None)
    ms.reset_launch_counts()
    on_card, _ = _cavity_run("cuda", **kw)
    assert ms.launch_counts == {"mlp_streams_fwd": 4, "mlp_streams_bwd": 4}
    on_cpu, _ = _cavity_run("cpu", **kw)
    np.testing.assert_allclose(on_card, on_cpu, rtol=1e-4, atol=1e-9)


# ------------------------------------------- order-3 streamfunction engine

# the last is a one-hidden-layer net: only the analytic first layer with its
# direct dW0 terms and the head
PSI_CASES = [((2, 32, 32, 32, 2), 512), ((2, 120, 120, 120, 2), 1040), ((2, 40, 40, 1), 272),
             ((2, 16, 2), 256)]


def _psi_inputs(sizes, n, dev, seed=0):
    flat, x, *_ = _inputs(sizes, n, dev, seed)
    gen = torch.Generator().manual_seed(seed + 200)
    cts = [torch.randn((n, sizes[-1]), generator=gen).to(dev) for _ in range(13)]
    return flat, x, cts


@pytest.mark.parametrize("sizes,n", PSI_CASES)
def test_psi_kernels_match_plain_version(cuda, sizes, n):
    flat, x, cts = _psi_inputs(sizes, n, cuda)
    got = psi.psi_fwd(flat, sizes, x, "high")
    assert len(got) == 13
    _assert_forward_matches_passes(got, lambda at: psi.plain_psi_streams(flat, sizes, x, at),
                                   "high")
    _assert_grads_match_passes(psi.psi_bwd(flat, sizes, x, cts, "high"),
                               psi.plain_psi_streams_bwd(flat, sizes, x, cts, "high"), sizes,
                               "high")


# Kernel 6 at each name: widths 16 / 24 / 40 / 80 / 120 (16- and 8-point
# tiles, whole weights and panels), K = 2 and K = 1, 3 (no template of
# their own), a one-hidden-layer net.
PSI_BWD_CASES = [((2, 16, 16, 2), 256), ((2, 24, 24, 24, 2), 512), ((2, 40, 40, 40, 2), 512),
                 ((2, 80, 80, 80, 2), 528), ((2, 120, 120, 120, 2), 1040), ((2, 16, 2), 256),
                 ((2, 32, 32, 1), 272), ((2, 32, 32, 3), 256)]


@pytest.mark.parametrize("precision", fr.PRECISIONS)
@pytest.mark.parametrize("sizes,n", PSI_BWD_CASES)
def test_psi_backward_matches_plain_passes(cuda, sizes, n, precision):
    flat, x, cts = _psi_inputs(sizes, n, cuda, seed=5)
    dflat = psi.psi_bwd(flat, sizes, x, cts, precision)
    _assert_grads_match_passes(dflat, psi.plain_psi_streams_bwd(flat, sizes, x, cts, precision),
                               sizes, precision, BWD_TOL)
    if precision == "high":  # and within the smoke's bar of exact fp32
        exact = psi.plain_psi_streams_bwd(flat, sizes, x, cts)
        for (kw, kb), (pw, pb) in zip(unflatten_params(dflat, sizes),
                                      unflatten_params(exact, sizes)):
            assert _rel(kw, pw) <= 1e-4 and _rel(kb, pb) <= 1e-4


def test_psi_kernels_take_zero_cotangents(cuda):
    """The bundle never reads a_p, a_m (streams 3, 4): zero there, and zero
    everywhere but one stream."""
    sizes, n = (2, 32, 32, 32, 2), 512
    flat, x, cts = _psi_inputs(sizes, n, cuda, seed=4)
    cts[3], cts[4] = torch.zeros_like(cts[3]), torch.zeros_like(cts[4])
    _assert_grads_match_passes(psi.psi_bwd(flat, sizes, x, cts, "high"),
                               psi.plain_psi_streams_bwd(flat, sizes, x, cts, "high"), sizes,
                               "high")
    only = [torch.zeros_like(c) for c in cts]
    only[11] = cts[11]
    _assert_grads_match_passes(psi.psi_bwd(flat, sizes, x, only, "high"),
                               psi.plain_psi_streams_bwd(flat, sizes, x, only, "high"), sizes,
                               "high")


# Kernel 5 at each name: kernel 6's widths, K = 1, 2, 3, 5, a one-hidden-layer net
PSI_FWD_CASES = PSI_BWD_CASES + [((2, 24, 24, 5), 272)]


@pytest.mark.parametrize("precision", fr.PRECISIONS)
@pytest.mark.parametrize("sizes,n", PSI_FWD_CASES)
def test_psi_forward_matches_plain_passes(cuda, sizes, n, precision):
    flat, x, _ = _psi_inputs(sizes, n, cuda, seed=6)
    _assert_forward_matches_passes(psi.psi_fwd(flat, sizes, x, precision),
                                   lambda at: psi.plain_psi_streams(flat, sizes, x, at), precision)


@pytest.mark.parametrize("precision", fr.PRECISIONS)
def test_psi_kernels_are_bitwise_deterministic(cuda, precision):
    sizes = (2, 80, 80, 80, 2)
    flat, x, cts = _psi_inputs(sizes, 8192, cuda, seed=1)
    a, b = psi.psi_fwd(flat, sizes, x, precision), psi.psi_fwd(flat, sizes, x, precision)
    assert all(torch.equal(s, t) for s, t in zip(a, b))
    assert torch.equal(psi.psi_bwd(flat, sizes, x, cts, precision),
                       psi.psi_bwd(flat, sizes, x, cts, precision))


@pytest.mark.parametrize("h", [16, 40, 80, 112, 120, 128, 160, 192])
def test_backward_tile_choice_agrees_with_the_library(cuda, h):
    """Kernels 3-6 size their blocks without the libraries: each library
    exports one count for its forward and backward, and the sources own
    the layouts (tc_smem, psi_smem)."""
    hp = -(-h // 16) * 16
    panels = [p for p in range(16, hp + 1, 16) if hp % p == 0]
    for parts in (1, 2, 3):
        for k in (1, 2, 3):
            for panel in panels:
                for tile in fr.LOSS_TILES:
                    assert (ms._lib().nsf_mlp_streams_smem_bytes(tile, panel, h, k, parts, 0)
                            == fr.loss_smem_bytes(tile, panel, h, parts, k))
                for tile in psi.PSI_BWD_TILES:
                    assert (psi._lib().nsf_psi_streams_smem_bytes(tile, panel, h, k, parts, 0)
                            == psi.bwd_smem_bytes(tile, panel, h, parts, k))
    for name in fr.PRECISIONS:
        for k in (2, 3):
            for pick, count in ((ms.pick_bwd_tile, fr.loss_smem_bytes),
                                (psi.pick_bwd_tile, psi.bwd_smem_bytes)):
                try:
                    tile, panel = pick(h, name, k)
                except ValueError:
                    continue
                assert count(tile, panel, h, fr.PARTS[name], k) <= fr._MAX_SMEM


def test_backward_widths_and_names(cuda):
    """Every name launches kernels 4 and 6 at the configs' widths (4x40,
    6x80, 4x120) on a resident plan; a width and name that fits no resident
    plan (psi 160 and five-stream 208 at "highest") launches on the
    streamed plan and matches the plain passes."""
    for h in (40, 80, 120):
        for name in fr.PRECISIONS:
            ms.pick_bwd_tile(h, name)
            psi.pick_bwd_tile(h, name)
    assert psi.pick_bwd_tile(80, "high") == (16, 80)
    assert psi.pick_bwd_tile(80, "highest")[0] == psi.pick_bwd_tile(120, "high")[0] == 8
    sizes = (2, 160, 160, 2)
    flat, x, cts = _psi_inputs(sizes, 256, cuda)
    assert psi.psi_plan(160, "highest").streamed
    launched = psi.launch_counts["psi_streams_bwd"]
    _assert_grads_match_passes(psi.psi_bwd(flat, sizes, x, cts, "highest"),
                               psi.plain_psi_streams_bwd(flat, sizes, x, cts, "highest"), sizes,
                               "highest")
    assert psi.launch_counts["psi_streams_bwd"] == launched + 1
    sizes = (2, 208, 208, 3)
    flat, x, cts = _stream_inputs(sizes, 256, cuda)
    assert fr.loss_plan(208, "highest").streamed
    launched = ms.launch_counts["mlp_streams_bwd"]
    _assert_grads_match_passes(ms.streams_bwd(flat, sizes, x, cts, "highest"),
                               ms.plain_mlp_streams_bwd(flat, sizes, x, cts, "highest"), sizes,
                               "highest")
    assert ms.launch_counts["mlp_streams_bwd"] == launched + 1


# The streamed plan: the first width at each name that no resident plan
# fits, and 1024 (3 hidden layers)
FIRST_STREAMED = {("velocity", "default"): 561, ("velocity", "high"): 289,
                  ("velocity", "highest"): 193, ("streamfunction", "default"): 433,
                  ("streamfunction", "high"): 209, ("streamfunction", "highest"): 145}


@pytest.mark.parametrize("h", [145, 193, 209, 289, 352, 433, 561, 1024, 2048])
def test_streamed_plan_counts_agree_with_the_library(cuda, h):
    """The libraries' counts of the streamed plan (shared memory, the
    global regions of one block) equal the Python twins the plans are
    chosen by."""
    for parts in (1, 2, 3):
        for k in (1, 2, 3):
            for kpanel in (16, 64, 128):
                for tile, panel in ((16, 160), (16, 96), (32, 80)):
                    assert (fr._lib().nsf_fused_loss_smem_bytes(tile, panel, h, k, parts, kpanel)
                            == fr.loss_smem_bytes(tile, panel, h, parts, k, kpanel))
                    assert (ms._lib().nsf_mlp_streams_smem_bytes(tile, panel, h, k, parts, kpanel)
                            == fr.loss_smem_bytes(tile, panel, h, parts, k, kpanel))
                for panel in (80, 48):
                    assert (psi._lib().nsf_psi_streams_smem_bytes(16, panel, h, k, parts, kpanel)
                            == psi.bwd_smem_bytes(16, panel, h, parts, k, kpanel))
            for tile in fr.LOSS_TILES:
                assert (fr._lib().nsf_fused_loss_carry_floats(tile, h, k, parts)
                        == ms._lib().nsf_mlp_streams_carry_floats(tile, h, k, parts)
                        == fr.carry_floats(tile, h, k, parts))
            for tile in psi.PSI_BWD_TILES:
                assert (psi._lib().nsf_psi_streams_carry_floats(tile, h, k, parts)
                        == psi.carry_floats(tile, h, k, parts))


# The streamed widths' bars, those of chip_smoke.py's full-width checks
# (FWD_TOL, BWD_TOL, DEFAULT_BWD_TOL): the tensor cores' fp32 accumulation runs H / 16 steps
# per pass, and at H = 1024 it moves a sum or a stream by up to ~3e-5 of its
# max from the plain version (2.7e-5 measured for kernel 1's sums at
# "highest", 2.6e-5 for a stream of kernel 5; PERF.md, section 6), past the
# 2e-5 of TOL, which was measured at H <= 120. At "default" the backwards
# take the smoke's 1e-3 (kernel 4 read 5.0e-4 at H = 1024 here, past the
# 5e-4 of BWD_TOL) and g_e is held norm-wise at it: one bf16 pass, and a
# deeper net has more carries a point whose rounding-edge flips move it
# (1.4e-4 / 1.9e-4 norm-wise at H = 561 / 1024 on the card); the forwards
# at "default" norm-wise, as there. Against exact fp32 no forward is held
# closer than the plain "high" passes themselves sit (PERF.md, section 6).
WIDE_TOL = 1e-4
WIDE_DEFAULT_TOL = 1e-3


def _rel_all(got, ref, precision):
    if precision == "default":
        return max(pc.norm_rels(got, ref))
    return max(_rel(g, r) for g, r in zip(got, ref))


def _check_wide_forward(got, plain, precision, h):
    with torch.no_grad():
        ref = plain(precision)
        assert _rel_all(got, ref, precision) <= (
            pc.DEFAULT_NORM_TOL if precision == "default" else WIDE_TOL)
        if precision == "high":
            exact = plain(None)
            assert max(_rel(g, r) for g, r in zip(got, exact)) <= max(
                WIDE_TOL, max(_rel(p, r) for p, r in zip(ref, exact)))
            if h <= pc.HIGH_SEP_MAX_K:
                assert pc.separation(got, ref, exact) <= pc.HIGH_SEP


def _check_wide_grads(got, ref, sizes, precision):
    tol = WIDE_DEFAULT_TOL if precision == "default" else WIDE_TOL
    for (kw, kb), (pw, pb) in zip(unflatten_params(got, sizes), unflatten_params(ref, sizes)):
        assert _rel(kw, pw) <= tol and _rel(kb, pb) <= tol


@pytest.mark.parametrize("wide", [True, False])
@pytest.mark.parametrize("formulation,precision", sorted(FIRST_STREAMED))
def test_streamed_kernels_match_plain_passes(cuda, formulation, precision, wide):
    """Each of the six kernels on the streamed plan, at the first width
    refused by every resident plan and at 1024, against its plain version
    at the same name (kernels 1+2 with a ragged last tile and a zero-weight
    tail)."""
    h = 1024 if wide else FIRST_STREAMED[(formulation, precision)]
    if formulation == "streamfunction":
        sizes = (2, h, h, h, 2)
        assert psi.psi_plan(h, precision).streamed
        flat, x, cts = _psi_inputs(sizes, 272, cuda, seed=7)
        _check_wide_forward(psi.psi_fwd(flat, sizes, x, precision),
                            lambda at: psi.plain_psi_streams(flat, sizes, x, at), precision, h)
        _check_wide_grads(psi.psi_bwd(flat, sizes, x, cts, precision),
                          psi.plain_psi_streams_bwd(flat, sizes, x, cts, precision), sizes,
                          precision)
        return
    sizes = (2, h, h, h, 3)
    assert fr.loss_plan(h, precision).streamed and fr.loss_plan(h, precision).streamed
    flat, x, e, vis_t, w = _inputs(sizes, 528, cuda, seed=7)
    ct = torch.tensor([0.7, 1.3, 0.9, 0.4], device=cuda)
    sums = fr.fused_fwd(flat, sizes, x, e, vis_t, w, 2000.0, 1.0, True, precision)
    dflat, g_e = fr.fused_bwd(flat, sizes, x, e, vis_t, w, 2000.0, ct, 1.0, True, precision)
    fl, er = flat.clone().requires_grad_(True), e.clone().requires_grad_(True)
    ref = fr.plain_residual_sums(unflatten_params(fl, sizes), x, er, vis_t, w, 2000.0, 1.0,
                                 True, precision)
    d_ref, ge_ref = torch.autograd.grad(ref, [fl, er], ct)
    assert ((sums - ref).abs() / ref.abs()).max().item() <= WIDE_TOL
    _check_wide_grads(dflat, d_ref, sizes, "high")
    assert _rel_all([g_e], [ge_ref], precision) <= (
        WIDE_DEFAULT_TOL if precision == "default" else WIDE_TOL)
    assert torch.all(g_e[-37:] == 0.0)
    flat, x, cts = _stream_inputs(sizes, 272, cuda, seed=7)
    _check_wide_forward(ms.streams_fwd(flat, sizes, x, precision),
                        lambda at: ms.plain_mlp_streams(flat, sizes, x, at), precision, h)
    _check_wide_grads(ms.streams_bwd(flat, sizes, x, cts, precision),
                      ms.plain_mlp_streams_bwd(flat, sizes, x, cts, precision), sizes, precision)


@pytest.mark.parametrize("precision", fr.PRECISIONS)
def test_streamed_plan_at_a_resident_tile_is_bitwise_the_resident_plan(cuda, precision):
    """Forced onto a resident plan's tile, the streamed plan accumulates in
    the same k order: all six kernels give the resident plan's outputs
    bitwise (kernels 1+2 at 32-point tiles too)."""
    sizes = (2, 80, 80, 80, 3)
    flat, x, e, vis_t, w = _inputs(sizes, 1040, cuda, seed=8)
    ct = torch.tensor([0.7, 1.3, 0.9, 0.4], device=cuda)
    tile = fr.loss_plan(80, precision).tile
    for plan in (None, fr.Plan(tile, 48, 32)):
        got = (fr.fused_fwd(flat, sizes, x, e, vis_t, w, 2000.0, 1.0, True, precision, plan),
               *fr.fused_bwd(flat, sizes, x, e, vis_t, w, 2000.0, ct, 1.0, True, precision,
                             plan))
        if plan is None:
            ref = got
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    flat, x, cts = _stream_inputs(sizes, 1040, cuda, seed=8)
    outs = [(*ms.streams_fwd(flat, sizes, x, precision, plan),
             ms.streams_bwd(flat, sizes, x, cts, precision, plan))
            for plan in (None, fr.Plan(tile, 64, 16))]
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    sizes = (2, 48, 48, 48, 2)
    flat, x, cts = _psi_inputs(sizes, 1040, cuda, seed=8)
    assert psi.pick_bwd_tile(48, precision)[0] == 16
    outs = [(*psi.psi_fwd(flat, sizes, x, precision, plan),
             psi.psi_bwd(flat, sizes, x, cts, precision, plan))
            for plan in (None, fr.Plan(16, 32, 32))]
    assert all(torch.equal(a, b) for a, b in zip(*outs))


@pytest.mark.parametrize("h", [16, 40, 80, 112, 120, 128])
def test_psi_tile_choice_agrees_with_the_library(cuda, h):
    """Kernel 5 takes kernel 6's rule and count (the library's count:
    test_backward_tile_choice_agrees_with_the_library): every tile divides
    the batch padding, 16 points up to h = 112."""
    for tile in psi.PSI_BWD_TILES:
        assert fr.ROW_ALIGN % tile == 0
    tile, panel = psi.pick_bwd_tile(h, "high")
    assert psi.bwd_smem_bytes(tile, panel, h, 2) <= fr._MAX_SMEM
    assert tile == (16 if h <= 112 else 8)


def _momentum_loss(bundle):
    """The momentum-shaped loss of tests/test_pallas_psi.py:41-63."""
    o, ox, oy, oxx, oyy = bundle
    u, v = o[:, 0:1], o[:, 1:2]
    eq1 = u * ox[:, 0:1] + v * oy[:, 0:1] + ox[:, 2:3] - 0.01 * (oxx[:, 0:1] + oyy[:, 0:1])
    eq2 = u * ox[:, 1:2] + v * oy[:, 1:2] + oy[:, 2:3] - 0.01 * (oxx[:, 1:2] + oyy[:, 1:2])
    return (eq1**2 + eq2**2).mean() + (o**2).mean()


def test_psi_autograd_takes_the_bundle_cotangents(cuda):
    """Through the bundle, autograd hands the backward zeros for a_p, a_m
    and column-scattered (strided) cotangents for the rest."""
    sizes = (2, 32, 32, 32, 2)
    flat, x, _ = _psi_inputs(sizes, 512, cuda, seed=2)
    flat.requires_grad_(True)
    psi.reset_launch_counts()
    bundle = psi.psi_streams(flat, sizes, x, uv_scale=2.0)
    (g,) = torch.autograd.grad(_momentum_loss(bundle), [flat])
    assert psi.launch_counts == {"psi_streams_fwd": 1, "psi_streams_bwd": 1}
    # the bundle and the gradient against the plain version at the entry
    # point's name, "high"
    from nsfnet_tpu_torch.ops.derivatives import assemble_psi_bundle
    emulated = assemble_psi_bundle(
        psi.emulated_psi_streams(unflatten_params(flat, sizes), x, fr.PARTS["high"]), 2.0)
    for got, ref in zip(bundle, emulated):
        torch.testing.assert_close(got, ref, rtol=2e-5, atol=2e-6 * max(ref.abs().max().item(), 1.0))
    (ref,) = torch.autograd.grad(_momentum_loss(emulated), [flat])
    torch.testing.assert_close(g, ref, rtol=5e-4, atol=5e-6)
    with pytest.raises(ValueError):  # unpadded batch: refused, no plain fallback
        psi.psi_streams(flat, sizes, x[:250])
    with pytest.raises(ValueError, match="head"):
        psi.psi_streams(flat[:-1], (2, 32, 32, 32, 1), x)


def test_streamfunction_solver_kernel_engine_matches_closed_form(cuda, monkeypatch):
    """N_f = 500 pads to 512: four Adam steps of the (psi, p) formulation
    through kernels 5+6 against the closed-form engine on the card and
    against the CPU."""
    monkeypatch.delenv("NSFNET_PALLAS_PSI", raising=False)
    kw = dict(formulation="streamfunction")
    psi.reset_launch_counts()
    fr.reset_launch_counts()
    pr.reset_launch_counts()
    kernel, p_kernel = _cavity_run("cuda", engine="pallas", **kw)
    assert psi.launch_counts == {"psi_streams_fwd": 4, "psi_streams_bwd": 4}
    assert pr.launch_counts == {"psi_residual_fwd": 4, "psi_residual_bwd": 4}
    assert not any(fr.launch_counts.values())
    psi.reset_launch_counts()
    closed, p_closed = _cavity_run("cuda", engine="xla", **kw)
    monkeypatch.setenv("NSFNET_PALLAS_PSI", "0")
    switched, _ = _cavity_run("cuda", **kw)  # auto, switched off: the closed form
    assert not any(psi.launch_counts.values())
    np.testing.assert_array_equal(switched, closed)
    np.testing.assert_allclose(kernel, closed, rtol=1e-4, atol=1e-9)
    assert not kernel[:, 6].any()  # eq3 == 0 exactly
    torch.testing.assert_close(p_kernel, p_closed, rtol=0, atol=5e-6)
    on_cpu, _ = _cavity_run("cpu", **kw)
    np.testing.assert_allclose(kernel, on_cpu, rtol=1e-4, atol=1e-9)


# ------------------------------------------- streamfunction residual glue

def _glue_inputs(n, dev, seed):
    gen = torch.Generator().manual_seed(seed)
    streams = tuple(torch.randn((n, 2), generator=gen).to(dev) for _ in range(13))
    e = (0.1 * torch.randn((n, 1), generator=gen)).to(dev)
    vis_t = (0.01 * torch.randn((n, 1), generator=gen)).abs().to(dev)
    w = torch.rand((n, 1), generator=gen) * 1.6 + 0.2
    w[-37:] = 0.0
    return streams, e, vis_t, w.to(dev)


# the glue kernels against their plain version: fp32 both, only the order of
# the sums and the contraction of products into fused multiply-adds differ
GLUE_TOL = 1e-5


@pytest.mark.parametrize("evm", [True, False], ids=["evm", "vanilla"])
@pytest.mark.parametrize("n,scale", [(512, 1.0), (1040, 0.5), (120_000, 2.0)])
def test_psi_glue_kernels_match_plain_version(cuda, n, scale, evm):
    streams, e, vis_t, w = _glue_inputs(n, cuda, seed=n % 97)
    if not evm:
        e = vis_t = None
    got = pr.residual_fwd(streams, e, vis_t, w, 2000.0, scale, evm)
    want = pr.plain_psi_residual_sums(streams, e, vis_t, w, 2000.0, scale, evm)
    assert got.shape == want.shape and got[2].item() == 0.0
    torch.testing.assert_close(got, want, rtol=GLUE_TOL, atol=0)
    ct = torch.tensor([0.7, -1.3, 0.4, 2.1][:4 if evm else 3], device=cuda)
    cts, g_e = pr.residual_bwd(streams, e, vis_t, w, ct, 2000.0, scale, evm)
    ref, ref_e = pr.plain_psi_residual_bwd(streams, e, vis_t, w, ct, 2000.0, scale, evm)
    for q, (a, b) in enumerate(zip(cts, ref)):
        assert a.is_contiguous() and _rel(a, b) <= GLUE_TOL, q
    if evm:
        assert _rel(g_e, ref_e) <= GLUE_TOL
        assert pr.residual_bwd(streams, e, vis_t, w, ct, 2000.0, scale, evm, want_e=False)[1] \
            is None
    else:
        assert g_e is None
    # bitwise repeatable
    assert torch.equal(pr.residual_fwd(streams, e, vis_t, w, 2000.0, scale, evm), got)
    again, _ = pr.residual_bwd(streams, e, vis_t, w, ct, 2000.0, scale, evm)
    assert all(torch.equal(a, b) for a, b in zip(again, cts))


@pytest.mark.parametrize("precision", fr.PRECISIONS)
@pytest.mark.parametrize("evm", [True, False], ids=["evm", "vanilla"])
def test_psi_residual_loss_matches_the_unfused_kernel_path(cuda, evm, precision):
    """Kernel 5 -> glue -> kernel 6 against kernel 5 -> the PyTorch bundle,
    residuals and sums -> kernel 6, at one name: the sums, and the
    gradients wrt the weights and e, with one launch of each kernel."""
    sizes, n = (2, 80, 80, 80, 2), 1040
    flat, x, e, vis_t, w = _inputs(sizes, n, cuda, seed=9)
    if not evm:
        e = vis_t = None
    ct = torch.tensor([1.0, 0.5, 0.3, 0.1][:4 if evm else 3], device=cuda)

    def run(fused):
        f = flat.clone().requires_grad_(True)
        ee = e.clone().requires_grad_(True) if evm else None
        if fused:
            sums = fr.fused_residual_loss(f, sizes, x, ee, vis_t, w, 2000.0, coord_scale=2.0,
                                          evm=evm, precision=precision,
                                          formulation="streamfunction")
        else:
            derivs = psi.psi_streams(f, sizes, x, 2.0, precision)
            res = (R.ev_ns_residuals(derivs, ee, vis_t, 2000.0, 2.0) if evm
                   else R.ns_residuals(derivs, 2000.0, 2.0))
            eqs = [res.eq1, res.eq2, res.eq3] + ([res.eq4] if evm else [])
            sums = torch.stack([L.masked_sum_sq(q, w) for q in eqs])
        grads = torch.autograd.grad((sums * ct).sum(), [f] + ([ee] if evm else []))
        return sums.detach(), grads

    for mod in (psi, pr, fr):
        mod.reset_launch_counts()
    sums, grads = run(True)
    assert psi.launch_counts == {"psi_streams_fwd": 1, "psi_streams_bwd": 1}
    assert pr.launch_counts == {"psi_residual_fwd": 1, "psi_residual_bwd": 1}
    assert not any(fr.launch_counts.values())
    ref_sums, ref_grads = run(False)
    torch.testing.assert_close(sums, ref_sums, rtol=GLUE_TOL, atol=0)
    # the same kernel 6 on cotangents a few fp32 ulps apart: at "default" one
    # may cross a bf16 rounding edge of its single part (BWD_TOL)
    tol = max(1e-4, BWD_TOL[precision])
    for (gw, gb), (rw, rb) in zip(unflatten_params(grads[0], sizes),
                                  unflatten_params(ref_grads[0], sizes)):
        assert _rel(gw, rw) <= tol and _rel(gb, rb) <= tol
    if evm:
        assert _rel(grads[1], ref_grads[1]) <= GLUE_TOL


def test_stacked_boundary_pass_matches_psi_p_uv_on_the_card(cuda):
    """The streamfunction Adam step's boundary pass at the flagship's size
    (6x80, 2,052 points): the stacked pass against psi_p_uv and autograd,
    both fp32, apart only in the order of each product's sums."""
    from nsfnet_tpu_torch.ops.derivatives import psi_p_uv, psi_p_uv_stacked

    sizes, n = (2, 80, 80, 80, 80, 80, 80, 2), 2052
    flat, x, *_ = _inputs(sizes, n, cuda, seed=11)
    g = torch.randn((n, 3), generator=torch.Generator().manual_seed(12)).to(cuda)
    a, b = flat.clone().requires_grad_(True), flat.clone().requires_grad_(True)
    got = psi_p_uv_stacked(a, sizes, x, 2.0)
    want = psi_p_uv(unflatten_params(b, sizes), x, 2.0)
    assert _rel(got, want) <= 1e-5
    (ga,) = torch.autograd.grad(got, [a], g)
    (gb,) = torch.autograd.grad(want, [b], g)
    for (gw, gbias), (rw, rbias) in zip(unflatten_params(ga, sizes), unflatten_params(gb, sizes)):
        assert _rel(gw, rw) <= 1e-4 and _rel(gbias, rbias) <= 1e-4


# --------------------------------------------------------- campaign path

def _campaign_solver(dev, tmp_path, **kw):
    from nsfnet_tpu_torch.data.cavity import CavityData

    s = PINNSolver(**{**dict(Re=400, layers=3, layers_1=2, hidden_size=32, hidden_size_1=16,
                             N_f=500, evm_update_freq=3, log_interval=1000, seed=3,
                             checkpoint_freq=4, checkpoint_path=str(tmp_path)), **kw},
                   device=dev)
    d = CavityData(N_f=s.N_f, sdf_enabled=True, sort_training_points=False, seed=1)
    s.attach_dataset(d)
    s.set_boundary_data(X=d.boundary_data())
    s.set_eq_training_data(X=d.training_data(), weights=d.sdf_weights)
    return s


def test_campaign_resume_and_rollback_on_the_card_are_bit_exact(cuda, tmp_path):
    """Through kernels 1+2 on the card: a mid-stage resume from a checkpoint
    and the rollback after a launch error both end where the uninterrupted
    stage ends, bit for bit."""
    whole = _campaign_solver("cuda", tmp_path / "whole")
    fr.reset_launch_counts()
    whole.train(num_epoch=10, lr=1e-3)
    assert fr.launch_counts == {"fused_residual_fwd": 10, "fused_residual_bwd": 10}
    mid = f"{whole._ckpt_dir()}/model_cavity_loop4.ckpt"
    resumed = _campaign_solver("cuda", tmp_path / "resumed", seed=9)
    resumed.load(mid)
    resumed.train(num_epoch=10, lr=1e-3, resume_in_stage=True)

    flaky = _campaign_solver("cuda", tmp_path / "flaky")
    flaky._ensure_ready()
    real, calls = flaky._runner, []

    def runner(state, batch, sc, n_steps):
        calls.append(n_steps)
        if len(calls) == 4:
            real(state, batch, sc, 1)
            raise fr.KernelLaunchError("injected")
        return real(state, batch, sc, n_steps)

    flaky._runner = runner
    flaky.train(num_epoch=10, lr=1e-3)
    for s in (resumed, flaky):
        for key in ("params", "params_evm", "vis_t_minus"):
            assert torch.equal(getattr(s.state, key), getattr(whole.state, key)), key


def test_jax_campaign_checkpoint_on_the_card_matches_the_cpu(cuda):
    """The committed Re=4000 6x160 checkpoint loaded on the card: its
    predictions against the same load on the CPU, and the RAR keep set its
    scores pick. The scores themselves are held point-wise on unconverged
    weights (test_residuals_at_on_the_card_matches_the_cpu): here each is a
    small difference of O(1) terms."""
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "artifacts", "live_re4000_r4b", "latest.ckpt")
    g = np.linspace(0.0, 1.0, 33, dtype=np.float32)
    gx, gy = (a.reshape(-1, 1) for a in np.meshgrid(g, g))
    out = {}
    for dev in ("cuda", "cpu"):
        s = PINNSolver(Re=4000, layers=6, layers_1=4, hidden_size=160, hidden_size_1=40,
                       N_f=1024, alpha_evm=0.002, device=dev)
        s.load(path)
        out[dev] = ([t.cpu() for t in s.predict((gx, gy))], s.residuals_at(gx, gy, chunk=512))
    for a, b in zip(out["cuda"][0], out["cpu"][0]):
        torch.testing.assert_close(a, b, rtol=0, atol=5e-6)
    # the points RAR keeps: the top quarter of the scores, as rar_training_data
    # takes them (argpartition of the negated scores)
    keep = {dev: set(np.argpartition(-out[dev][1], g.size ** 2 // 4 - 1)[:g.size ** 2 // 4])
            for dev in out}
    assert keep["cuda"] == keep["cpu"], len(keep["cuda"] ^ keep["cpu"])


def test_residuals_at_on_the_card_matches_the_cpu(cuda):
    """The RAR score on unconverged weights (EVM, coordinate transform on,
    a ragged last chunk), card against CPU, both in exact fp32."""
    rng = np.random.default_rng(3)
    px, py = rng.uniform(-1, 1, (2, 1300, 1)).astype(np.float32)
    arch = dict(Re=400, layers=3, layers_1=2, hidden_size=32, hidden_size_1=16, N_f=64,
                alpha_evm=0.05, seed=4)
    cpu = PINNSolver(**arch, device="cpu")
    card = PINNSolver(**arch, device="cuda")
    card.set_params([(w.cuda(), b.cuda()) for w, b in cpu.params()],
                    [(w.cuda(), b.cuda()) for w, b in cpu.params_evm()])
    for s in (cpu, card):
        s.set_coordinate_transform(2.0)
    np.testing.assert_allclose(card.residuals_at(px, py, chunk=512),
                               cpu.residuals_at(px, py, chunk=512), rtol=1e-5, atol=1e-7)


# ------------------------------------------------- second-order polish

def test_v1_recipe_shape_kernels_match_plain_version(cuda):
    """Kernels 1+2 at configs/re2000_nsfnet.yaml's shape (4x120, no EVM,
    40,000 points) at the path's name and tile."""
    _check_pair(cuda, (2, 120, 120, 120, 120, 3), 40_000, 1.0, 2000.0, False, "high")


def _polish_pair(evm=True, hidden=24, n_f=500, re=400.0, adam_steps=10):
    from nsfnet_tpu_torch.data.cavity import CavityData

    out = []
    for dev in ("cuda", "cpu"):
        s = PINNSolver(Re=re, layers=2, layers_1=2 if evm else None, evm=evm,
                       hidden_size=hidden, hidden_size_1=hidden // 2, N_f=n_f,
                       evm_update_freq=2, log_interval=1, checkpoint_freq=10**9, seed=3,
                       device=dev)
        d = CavityData(N_f=n_f, sdf_enabled=True, sort_training_points=False, seed=1)
        s.set_boundary_data(X=d.boundary_data())
        s.set_eq_training_data(X=d.training_data(), weights=d.sdf_weights)
        s.train(num_epoch=adam_steps, lr=1e-3)
        out.append(s)
    return out


@pytest.mark.parametrize("evm", [True, False])
def test_lbfgs_on_the_card_matches_the_cpu(cuda, evm):
    """The closed-form exact-fp32 loss on both devices: the line search
    takes the same decisions, the histories differ by the sums' order."""
    card, cpu = _polish_pair(evm)
    for s in (card, cpu):
        s.train(num_epoch=4, optimizer="lbfgs")
    assert card.polish_stats["evaluations"] == cpu.polish_stats["evaluations"]
    np.testing.assert_allclose(card.polish_stats["history"], cpu.polish_stats["history"],
                               rtol=1e-4)


@pytest.mark.parametrize("micro", [1, 3])
def test_lm_on_the_card_matches_the_cpu(cuda, micro):
    """LM full and over 3 slices, card against CPU, on a net small enough
    (8 wide, 64 points) for 40 CG iterations to converge: with CG stopped
    early, fp32 CG over an ill-conditioned J^T J amplifies the devices'
    summation-order differences into different steps. Converged, the port
    and the JAX package agree to 1e-4 of the loss on the CPU
    (tests/test_torch_polish.py): the bar is 5e-4."""
    card, cpu = _polish_pair(hidden=8, n_f=64, re=100.0, adam_steps=2)
    for s in (card, cpu):
        s.train_lm(2, cg_iters=40, microbatches=micro)
    h = card.polish_stats["history"]
    assert h[-1] < h[0]
    np.testing.assert_allclose(h, cpu.polish_stats["history"], rtol=5e-4)
    torch.testing.assert_close(card.state.params.cpu(), cpu.state.params, rtol=0, atol=5e-4)
    assert card.global_step == cpu.global_step == 4


# --------------------------------------------- microbatching, process groups

@pytest.mark.parametrize("micro", [2, 4])
def test_microbatched_step_on_the_card_matches_the_full_batch(cuda, tmp_path, micro):
    """Through kernels 1+2: `micro` launches of each per step, each on its
    slice of the padded batch, and 6 steps (the EVM gate firing at 3)
    within float tolerance of the full batch's (the same sums, in another
    order); the card's microbatched run within 1e-4 of the CPU's."""
    runs = {}
    for key, dev, m in (("full", "cuda", 1), ("micro", "cuda", micro), ("cpu", "cpu", micro)):
        s = _campaign_solver(dev, tmp_path / key, microbatches=m, log_interval=1,
                             checkpoint_freq=10**9)
        fr.reset_launch_counts()
        s.train(num_epoch=6, lr=1e-3)
        runs[key] = (s, dict(fr.launch_counts), dict(fr.launch_rows))
    s, counts, rows = runs["micro"]
    n = s._batch.x_f.shape[0]
    assert n % (micro * fr.ROW_ALIGN) == 0
    assert counts == {"fused_residual_fwd": 6 * micro, "fused_residual_bwd": 6 * micro}
    assert rows == {"fused_residual_fwd": 6 * n, "fused_residual_bwd": 6 * n}
    assert runs["full"][1] == {"fused_residual_fwd": 6, "fused_residual_bwd": 6}
    assert runs["cpu"][1] == {"fused_residual_fwd": 0, "fused_residual_bwd": 0}
    hist = lambda s_: np.asarray([list(m_) for _, m_ in s_.loss_history])
    np.testing.assert_allclose(hist(s), hist(runs["full"][0]), rtol=1e-5, atol=1e-12)
    torch.testing.assert_close(s.state.params, runs["full"][0].state.params, rtol=0, atol=1e-5)
    np.testing.assert_allclose(hist(s), hist(runs["cpu"][0]), rtol=1e-4, atol=1e-9)


def test_world_one_nccl_group_matches_no_group_bitwise(cuda, tmp_path, monkeypatch):
    """A 1-rank NCCL process group (its one all-reduce per step, the carry
    gathered at save) against no group: bitwise equal params, carry and
    checkpoint carry."""
    import socket

    import torch.distributed as dist

    from nsfnet_tpu_torch.parallel import mesh as pmesh

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    env = {"WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(port)}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    alone = _campaign_solver("cuda", tmp_path / "alone", checkpoint_freq=10**9)
    alone.train(num_epoch=6, lr=1e-3)
    path_alone = alone.save("end.ckpt")
    assert pmesh.initialize_distributed("cuda") == (0, 1, 0)
    try:
        assert dist.get_backend() == "nccl"
        grouped = _campaign_solver("cuda", tmp_path / "grouped", checkpoint_freq=10**9)
        assert grouped.group is not None and grouped.world_size == 1
        grouped.train(num_epoch=6, lr=1e-3)
        path_grouped = grouped.save("end.ckpt")
    finally:
        dist.destroy_process_group()
    for key in ("params", "params_evm", "vis_t_minus"):
        assert torch.equal(getattr(grouped.state, key), getattr(alone.state, key)), key
    a, b = (torch.load(p, weights_only=True) for p in (path_alone, path_grouped))
    assert torch.equal(a["vis_t_minus"], b["vis_t_minus"])
