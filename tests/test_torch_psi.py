"""PyTorch port: the order-3 streamfunction derivative engine against the
JAX package.

The closed-form engine is held against the JAX functions at float64. The
kernel entry point `psi_streams` runs its plain version here (CPU tensors)
and is held against nsfnet_tpu.ops.pallas_psi (its Pallas kernels in
interpret mode, as tests/test_pallas_psi.py runs them on the CPU) on the
same numpy-seeded weights and points. The CUDA kernels themselves are held
against that plain version on the card (tests/test_torch_gpu.py,
chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsfnet_tpu.models.mlp import init_mlp as jax_init_mlp
from nsfnet_tpu.models.mlp import mlp_apply as jax_mlp_apply
from nsfnet_tpu.ops import derivatives as JD
from nsfnet_tpu.ops import pallas_psi as JP
from nsfnet_tpu.ops.pallas_mlp import TILE
from nsfnet_tpu_torch.models.convert import params_from_numpy
from nsfnet_tpu_torch.models.mlp import (flatten_params, layer_sizes, param_count,
                                         unflatten_params)
from nsfnet_tpu_torch.ops import derivatives as D
from nsfnet_tpu_torch.ops import psi_streams as psi

torch.set_num_threads(2)

N = 512  # the JAX kernel's tile
assert N == TILE

NETS = {"3x32": (2, 32, 32, 32, 2), "1x16": (2, 16, 2)}  # the latter: first layer + head only
jax_fused_psi = JP.make_fused_psi_derivatives("highest")


def _setup(sizes, seed=0, n=N):
    """Weights U(+-1/sqrt(fan_in)) and points U(0, 1), from numpy."""
    rng = np.random.default_rng(seed)
    params = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        b = 1.0 / np.sqrt(fan_in)
        params.append((rng.uniform(-b, b, (fan_in, fan_out)).astype(np.float32),
                       rng.uniform(-b, b, (fan_out,)).astype(np.float32)))
    x = rng.uniform(0.0, 1.0, (n, 2)).astype(np.float32)
    jp = tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in params)
    flat = flatten_params(params_from_numpy(params))
    return jp, jnp.asarray(x), flat, torch.from_numpy(x)


def _momentum_loss(bundle, mean):
    """The momentum-shaped loss of tests/test_pallas_psi.py:41-63: it touches
    every slot of the bundle."""
    o, ox, oy, oxx, oyy = bundle
    u, v = o[:, 0:1], o[:, 1:2]
    eq1 = u * ox[:, 0:1] + v * oy[:, 0:1] + ox[:, 2:3] - 0.01 * (oxx[:, 0:1] + oyy[:, 0:1])
    eq2 = u * ox[:, 1:2] + v * oy[:, 1:2] + oy[:, 2:3] - 0.01 * (oxx[:, 1:2] + oyy[:, 1:2])
    return mean(eq1**2 + eq2**2) + mean(o**2)


# ------------------------------------------------ closed form, float64


@pytest.mark.parametrize("uv_scale", [1.0, 1.7])
def test_closed_form_engine_matches_jax_float64(x64, uv_scale):
    jp = jax_init_mlp(jax.random.PRNGKey(3), (2, 32, 32, 32, 2), dtype=jnp.float64)
    x = np.random.default_rng(3).uniform(-1.0, 1.0, (64, 2))
    ref = JD.mlp_psi_derivatives_2d(jp, jnp.asarray(x), uv_scale)
    got = D.mlp_psi_derivatives_2d(params_from_numpy(jp, dtype=torch.float64),
                                   torch.from_numpy(x), uv_scale)
    assert len(got) == 5
    for r, g in zip(ref, got):
        assert tuple(g.shape) == (64, 3)
        # same fp64 algebra; third-order terms reach O(10)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-9, atol=1e-12)
    # continuity is exact by construction: v_y is the negated u_x array
    assert torch.equal(got[1][:, 0], -got[2][:, 1])


@pytest.mark.parametrize("uv_scale", [1.0, 2.0])
def test_psi_p_uv_matches_jax_float64(x64, uv_scale):
    jp = jax_init_mlp(jax.random.PRNGKey(5), (2, 24, 24, 2), dtype=jnp.float64)
    x = np.random.default_rng(5).uniform(-1.0, 1.0, (40, 2))
    ref = JD.psi_p_uv(lambda z: jax_mlp_apply(jp, z), jnp.asarray(x), uv_scale)
    tp = params_from_numpy(jp, dtype=torch.float64)
    got = D.psi_p_uv(tp, torch.from_numpy(x), uv_scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-9, atol=1e-13)
    # the values are the first slot of the derivative bundle
    bundle = D.mlp_psi_derivatives_2d(tp, torch.from_numpy(x), uv_scale)
    torch.testing.assert_close(got, bundle[0], rtol=1e-12, atol=1e-14)


def test_tanh_chain_matches_jax(x64):
    t = np.tanh(np.linspace(-3.0, 3.0, 41))
    for g, r in zip(D.tanh_chain(torch.from_numpy(t)), JD.tanh_chain(jnp.asarray(t))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-13, atol=1e-15)


# ------------------------------- the engine against the JAX Pallas engine


@pytest.mark.parametrize("net", sorted(NETS))
def test_bundle_matches_jax_pallas(net):
    sizes = NETS[net]
    jp, jx, flat, x = _setup(sizes)
    ref = jax_fused_psi(jp, jx, 1.7)  # interpret mode on the CPU
    got = psi.psi_streams(flat, sizes, x, 1.7, precision="highest")
    assert len(got) == 5
    for g, r in zip(got, ref):
        assert tuple(g.shape) == (N, 3)
        # the JAX package's bar between its kernel and its XLA engine
        # (tests/test_pallas_psi.py:27-29): fp32 products summed in another order
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("net", sorted(NETS))
def test_raw_streams_match_jax_pallas(net):
    """The thirteen raw streams, before the bundle's third-order
    cancellation, against the JAX kernel's own outputs."""
    sizes = NETS[net]
    jp, jx, flat, x = _setup(sizes, seed=4)
    ref = JP._fwd_pallas(jp, jx, "highest")
    got = psi.plain_psi_streams(flat, sizes, x)
    assert len(got) == len(ref) == 13
    for g, r in zip(got, ref):
        assert tuple(g.shape) == (N, 2)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("net", sorted(NETS))
def test_gradients_match_jax_pallas(net):
    sizes = NETS[net]
    jp, jx, flat, x = _setup(sizes, seed=1)
    jgrads = jax.grad(lambda p: _momentum_loss(jax_fused_psi(p, jx, 2.0), jnp.mean))(jp)
    flat.requires_grad_(True)
    (gflat,) = torch.autograd.grad(
        _momentum_loss(psi.psi_streams(flat, sizes, x, 2.0), torch.mean), [flat])
    for (gw, gb), (rw, rb) in zip(unflatten_params(gflat, sizes), jgrads):
        # the JAX package's own bar (tests/test_pallas_psi.py:59-63)
        np.testing.assert_allclose(gw.numpy(), np.asarray(rw), rtol=5e-4, atol=5e-6)
        np.testing.assert_allclose(gb.numpy(), np.asarray(rb), rtol=5e-4, atol=5e-6)


@pytest.mark.parametrize("net", sorted(NETS))
def test_plain_backward_matches_jax_vjp(net):
    """plain_psi_streams_bwd is what the CUDA backward is held against on
    the card: here it is held against the JAX kernel's vjp on the same
    thirteen cotangents, the two streams the bundle never reads all zero."""
    sizes = NETS[net]
    jp, jx, flat, x = _setup(sizes, seed=2)
    rng = np.random.default_rng(3)
    cts = [rng.standard_normal((N, 2)).astype(np.float32) for _ in range(13)]
    cts[3][:] = 0.0
    cts[4][:] = 0.0
    jgrads = JP._bwd_pallas(jp, jx, tuple(jnp.asarray(c) for c in cts), "highest")
    gflat = psi.plain_psi_streams_bwd(flat, sizes, x, [torch.from_numpy(c) for c in cts])
    assert gflat.shape == flat.shape and not flat.requires_grad
    for (gw, gb), (rw, rb) in zip(unflatten_params(gflat, sizes), jgrads):
        # N-point sums of O(1..10) terms: the floor is relative to each tensor's size
        tol = 2e-6 * max(np.abs(np.asarray(rw)).max(), 1.0)
        np.testing.assert_allclose(gw.numpy(), np.asarray(rw), rtol=5e-4, atol=tol)
        np.testing.assert_allclose(gb.numpy(), np.asarray(rb), rtol=5e-4, atol=tol)


# ------------------------------------------------------------- the wrapper


def test_x_gets_no_gradient():
    sizes = NETS["1x16"]
    _, _, flat, x = _setup(sizes, n=64)
    x.requires_grad_(True)
    flat.requires_grad_(True)
    out = psi.psi_streams(flat, sizes, x)
    gflat, gx = torch.autograd.grad(out[0].sum() + out[3].sum(), [flat, x], allow_unused=True)
    assert gx is None and torch.count_nonzero(gflat) > 0


def test_cpu_path_launches_no_kernel():
    psi.reset_launch_counts()
    sizes = NETS["3x32"]
    _, _, flat, x = _setup(sizes, n=50)  # the plain version needs no padding
    flat.requires_grad_(True)
    out = psi.psi_streams(flat, sizes, x)
    torch.autograd.grad(sum(t.sum() for t in out), [flat])
    assert psi.launch_counts == {"psi_streams_fwd": 0, "psi_streams_bwd": 0}
    with pytest.raises(ValueError, match="precision"):
        psi.psi_streams(flat, sizes, x, precision="bf16")
    with pytest.raises(ValueError, match="head"):
        psi.psi_streams(flat, (2, 32, 32, 32, 3), x)


def test_never_falls_back_off_the_cpu(monkeypatch):
    """A tensor that is neither on the CPU nor on a card goes to the kernel
    wrapper, which refuses it; the plain version must not run."""
    def boom(*a, **k):
        raise AssertionError("the plain version ran for a tensor off the CPU")
    monkeypatch.setattr(psi, "plain_psi_streams", boom)
    sizes = NETS["3x32"]
    flat = torch.zeros(param_count(sizes), device="meta")
    x = torch.zeros((64, 2), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        psi.psi_streams(flat, sizes, x)
    with pytest.raises(ValueError, match="CUDA"):
        psi.psi_bwd(flat, sizes, x, [torch.zeros((64, 2), device="meta")] * 13)
    with pytest.raises(ValueError, match="13"):
        psi.psi_bwd(flat, sizes, x, [torch.zeros((64, 2), device="meta")] * 5)


def test_tile_and_bounds_accounting_at_the_flagship_width():
    sizes = layer_sizes(2, 2, 6, 80)
    # kernels 5 and 6 share one rule: 16 points and the whole weight at 6x80
    # "high", 8 points where 16 do not fit
    assert psi.pick_bwd_tile(80, "high") == (16, 80)
    assert psi.bwd_smem_bytes(16, 80, 80, 2) == 182_144  # one block per SM
    assert psi.pick_bwd_tile(120, "high") == (8, 128)
    assert psi.bwd_smem_bytes(16, 16, 120, 2) > 232_448  # 16 points do not fit at any panel
    assert psi.pick_bwd_tile(40, "high") == (16, 48)
    assert all(16 % psi.pick_bwd_tile(h)[0] == 0 for h in range(8, 129, 8))
    assert param_count(sizes) == 32_802
    fwd, bwd = psi.flop_counts(sizes, 120_000)
    assert fwd == 120_000 * (13 * 2 * 80 * 80 * 5 + 13 * 2 * 80 * 2) == 100_339_200_000
    assert bwd == 120_000 * (3 * 13 * 2 * 80 * 80 * 5 + 2 * 13 * 2 * 80 * 2) == 300_518_400_000
    b_fwd, b_bwd = psi.byte_counts(sizes, 120_000)
    assert b_fwd == 120_000 * (8 + 104) + 4 * 32_802  # reads 8 B, writes 104 B per point
    assert b_bwd == b_fwd + 4 * 32_802
