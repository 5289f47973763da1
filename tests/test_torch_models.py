"""PyTorch port: MLP and closed-form derivative engine against the JAX
package (float64, `x64` fixture) and against torch.func jvp-of-jvp.

JAX and torch draw different weights from one seed, so every comparison
initialises with JAX and carries the weights across with
models/convert.py; inputs come from a numpy seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsfnet_tpu.models.mlp import init_mlp as jax_init_mlp
from nsfnet_tpu.models.mlp import mlp_apply as jax_mlp_apply
from nsfnet_tpu.ops.derivatives import mlp_derivatives_2d as jax_mlp_derivatives_2d
from nsfnet_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from nsfnet_tpu_torch.models.mlp import (
    MLP,
    flatten_params,
    init_mlp,
    layer_sizes,
    mlp_apply,
    param_count,
    unflatten_params,
)
from nsfnet_tpu_torch.ops.derivatives import mlp_derivatives_2d

torch.set_num_threads(2)

SIZES = (2, 32, 32, 32, 3)


def _jax_params(sizes, seed=0, dtype=jnp.float32):
    return jax_init_mlp(jax.random.PRNGKey(seed), sizes, dtype=dtype)


def _points(n=64, seed=0):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, (n, 2))


def test_layer_sizes_and_count():
    assert layer_sizes(2, 3, 6, 80) == (2, 80, 80, 80, 80, 80, 80, 3)
    assert param_count(layer_sizes(2, 3, 6, 80)) == 2 * 80 + 80 + 5 * (80 * 80 + 80) + 80 * 3 + 3


def test_mlp_apply_matches_jax_float64(x64):
    jp = _jax_params(SIZES, dtype=jnp.float64)
    x = _points()
    ref = np.asarray(jax_mlp_apply(jp, jnp.asarray(x)))
    tp = params_from_numpy(jp, dtype=torch.float64)
    got = mlp_apply(tp, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-14)  # same fp64 algebra


def test_mlp_derivatives_match_jax_float64(x64):
    jp = _jax_params(SIZES, seed=3, dtype=jnp.float64)
    x = _points(seed=3)
    ref = jax_mlp_derivatives_2d(jp, jnp.asarray(x))
    got = mlp_derivatives_2d(params_from_numpy(jp, dtype=torch.float64), torch.from_numpy(x))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-11, atol=1e-13)


def test_mlp_derivatives_match_torch_func_jvp_of_jvp():
    jp = _jax_params(SIZES, seed=5)
    params = params_from_numpy(jp, dtype=torch.float64)
    x = torch.from_numpy(_points(32, seed=5))
    f = lambda z: mlp_apply(params, z)
    ex = torch.zeros_like(x)
    ex[:, 0] = 1.0
    ey = torch.zeros_like(x)
    ey[:, 1] = 1.0

    def sweep(v):
        first = lambda z: torch.func.jvp(f, (z,), (v,))[1]
        d1 = first(x)
        d2 = torch.func.jvp(first, (x,), (v,))[1]
        return d1, d2

    fx, fxx = sweep(ex)
    fy, fyy = sweep(ey)
    out, dx, dy, dxx, dyy = mlp_derivatives_2d(params, x)
    for got, ref in zip((out, dx, dy, dxx, dyy), (f(x), fx, fy, fxx, fyy)):
        torch.testing.assert_close(got, ref, rtol=1e-11, atol=1e-13)  # fp64, same math


def test_params_numpy_roundtrip_and_flat_views():
    jp = _jax_params((2, 8, 8, 3), seed=1)
    tp = params_from_numpy(jp)
    back = params_to_numpy(tp)
    for (w, b), (w2, b2) in zip(jp, back):
        np.testing.assert_array_equal(np.asarray(w), w2)
        np.testing.assert_array_equal(np.asarray(b), b2)
    flat = flatten_params(tp)
    assert flat.numel() == param_count((2, 8, 8, 3))
    for (w, b), (w2, b2) in zip(tp, unflatten_params(flat, (2, 8, 8, 3))):
        assert torch.equal(w, w2) and torch.equal(b, b2)
    with pytest.raises(ValueError):
        unflatten_params(flat[:-1], (2, 8, 8, 3))


@pytest.mark.parametrize("k", [1, 2])
def test_conversion_carries_other_heads(k):
    """The (psi, p) head of the streamfunction formulation (K = 2) and the
    EVM net's single output: a JAX-initialised net gives the same outputs on
    both sides after the copy."""
    sizes = (2, 8, 8, k)
    jp = _jax_params(sizes, seed=2)
    tp = params_from_numpy(jp)
    assert tp[-1][0].shape == (8, k) and tp[-1][1].shape == (k,)
    assert flatten_params(tp).numel() == param_count(sizes)
    x = _points(16, seed=2).astype(np.float32)
    np.testing.assert_allclose(mlp_apply(tp, torch.from_numpy(x)).numpy(),
                               np.asarray(jax_mlp_apply(jp, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)  # fp32 products, other summation order
    for (w, b), (w2, b2) in zip(jp, params_to_numpy(unflatten_params(flatten_params(tp), sizes))):
        np.testing.assert_array_equal(np.asarray(w), w2)
        np.testing.assert_array_equal(np.asarray(b), b2)


def test_init_mlp_is_seeded_and_bounded():
    sizes = (2, 20, 20, 3)
    a = init_mlp(sizes, torch.Generator().manual_seed(4))
    b = init_mlp(sizes, torch.Generator().manual_seed(4))
    c = init_mlp(sizes, torch.Generator().manual_seed(5))
    assert all(torch.equal(x, y) for pa, pb in zip(a, b) for x, y in zip(pa, pb))
    assert not torch.equal(a[0][0], c[0][0])
    for (w, bias), fan_in in zip(a, sizes[:-1]):
        bound = fan_in ** -0.5
        assert w.abs().max() <= bound and bias.abs().max() <= bound
        assert w.abs().max() > 0.5 * bound  # uniform over the whole interval


def test_mlp_module_uses_one_flat_parameter():
    net = MLP(2, 3, 2, 16, torch.Generator().manual_seed(0))
    assert [n for n, _ in net.named_parameters()] == ["flat"]
    x = torch.rand(10, 2)
    torch.testing.assert_close(net(x), mlp_apply(net.params(), x), rtol=0, atol=0)
    net(x).sum().backward()
    assert net.flat.grad is not None and net.flat.grad.shape == net.flat.shape


def test_widen_mlp_params_preserves_the_function():
    """Net2Net widening (tests/test_solver.py:237-249): the widened net
    computes the donor's function; new units send exactly zero to the old
    units and the head, and get random incoming weights from the generator."""
    from nsfnet_tpu_torch.models.mlp import widen_mlp_params

    p = params_from_numpy(_jax_params((2, 16, 16, 16, 3), seed=3))
    x = torch.as_tensor(_points(37, seed=4), dtype=torch.float32)
    wide = widen_mlp_params(p, 24, torch.Generator().manual_seed(5))
    assert [tuple(w.shape) for w, _ in wide] == [(2, 24), (24, 24), (24, 24), (24, 3)]
    for li, (w, b) in enumerate(wide):
        fi, fo = p[li][0].shape
        assert torch.equal(w[:fi, :fo], p[li][0]) and torch.equal(b[:fo], p[li][1])
        assert torch.count_nonzero(w[fi:, :fo]) == 0 and torch.count_nonzero(b[fo:]) == 0
        if w.shape[1] > fo:
            assert torch.count_nonzero(w[:, fo:]) == w[:, fo:].numel()
    torch.testing.assert_close(mlp_apply(wide, x), mlp_apply(p, x), rtol=0, atol=1e-6)
    again = widen_mlp_params(p, 24, torch.Generator().manual_seed(5))
    assert all(torch.equal(a, b) for pa, pb in zip(wide, again) for a, b in zip(pa, pb))
