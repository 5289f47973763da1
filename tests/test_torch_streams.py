"""PyTorch port: the five-stream derivative engine against the JAX package.

The same numpy-seeded weights and points go through
nsfnet_tpu.ops.pallas_mlp.fused_mlp_derivatives (its Pallas kernels in
interpret mode, as tests/test_pallas_mlp.py runs them on the CPU) and through
the port's `mlp_streams`, which runs its plain version here (CPU tensors).
The CUDA kernels themselves are held against that plain version on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsfnet_tpu.ops.pallas_mlp import TILE, fused_mlp_derivatives
from nsfnet_tpu_torch.models.convert import params_from_numpy
from nsfnet_tpu_torch.models.mlp import (flatten_params, layer_sizes, param_count,
                                         unflatten_params)
from nsfnet_tpu_torch.ops import fused_residual as fr
from nsfnet_tpu_torch.ops import mlp_streams as ms

torch.set_num_threads(2)

N = 512  # the JAX kernel's tile divides it
assert N % TILE == 0

NETS = {"main_k3": (2, 32, 32, 32, 3), "evm_k1": (2, 16, 16, 1)}


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


def _pinn_loss(streams, mean, k):
    """The PINN-shaped loss of tests/test_pallas_mlp.py:42-60 (K = 3), or a
    loss on all five streams (K = 1)."""
    o, ox, oy, oxx, oyy = streams
    if k == 1:
        return sum(mean(t**2) for t in streams)
    u, v = o[:, 0:1], o[:, 1:2]
    eq1 = u * ox[:, 0:1] + v * oy[:, 0:1] + ox[:, 2:3] - 0.01 * (oxx[:, 0:1] + oyy[:, 0:1])
    eq2 = u * ox[:, 1:2] + v * oy[:, 1:2] + oy[:, 2:3] - 0.01 * (oxx[:, 1:2] + oyy[:, 1:2])
    eq3 = ox[:, 0:1] + oy[:, 1:2]
    return mean(eq1**2 + eq2**2 + eq3**2) + mean(o**2)


def _subset_loss(streams, mean, k):
    """Only some streams and only some columns: d/dy and d2/dx2 get no
    cotangent at all, the value stream only in its last column."""
    o, ox, _, _, oyy = streams
    return mean(ox[:, 0:1] ** 2) + mean(o[:, k - 1:k] * oyy[:, 0:1])


def _assert_grads_match(gflat, sizes, jgrads):
    for (gw, gb), (rw, rb) in zip(unflatten_params(gflat, sizes), jgrads):
        # the JAX package's bar between its kernel and its XLA engine
        # (tests/test_pallas_mlp.py:57-59): fp32 reverse sweeps in another order
        np.testing.assert_allclose(gw.numpy(), np.asarray(rw), rtol=5e-4, atol=2e-6)
        np.testing.assert_allclose(gb.numpy(), np.asarray(rb), rtol=5e-4, atol=2e-6)


@pytest.mark.parametrize("net", sorted(NETS))
def test_streams_match_jax_pallas(net):
    sizes = NETS[net]
    jp, jx, flat, x = _setup(sizes)
    ref = fused_mlp_derivatives(jp, jx)  # interpret mode on the CPU
    got = ms.mlp_streams(flat, sizes, x, precision="highest")
    assert len(got) == 5
    for g, r in zip(got, ref):
        assert tuple(g.shape) == (N, sizes[-1])
        # fp32 products summed in another order (tests/test_pallas_mlp.py:27)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("loss", [_pinn_loss, _subset_loss], ids=["pinn", "subset"])
@pytest.mark.parametrize("net", sorted(NETS))
def test_gradients_match_jax_pallas(net, loss):
    sizes = NETS[net]
    k = sizes[-1]
    jp, jx, flat, x = _setup(sizes, seed=1)
    jgrads = jax.grad(lambda p: loss(fused_mlp_derivatives(p, jx), jnp.mean, k))(jp)
    flat.requires_grad_(True)
    (gflat,) = torch.autograd.grad(loss(ms.mlp_streams(flat, sizes, x), torch.mean, k), [flat])
    _assert_grads_match(gflat, sizes, jgrads)


def test_plain_backward_matches_jax_vjp():
    """plain_mlp_streams_bwd is what the CUDA backward is held against on
    the card: here it is held against the JAX kernel's vjp on the same five
    cotangents, one of them all zero."""
    sizes = NETS["main_k3"]
    jp, jx, flat, x = _setup(sizes, seed=2)
    rng = np.random.default_rng(3)
    cts = [rng.standard_normal((N, 3)).astype(np.float32) for _ in range(5)]
    cts[2][:] = 0.0
    _, vjp = jax.vjp(lambda p: fused_mlp_derivatives(p, jx), jp)
    (jgrads,) = vjp(tuple(jnp.asarray(c) for c in cts))
    gflat = ms.plain_mlp_streams_bwd(flat, sizes, x, [torch.from_numpy(c) for c in cts])
    assert gflat.shape == flat.shape and not flat.requires_grad
    for (gw, gb), (rw, rb) in zip(unflatten_params(gflat, sizes), jgrads):
        # N-point sums of O(1) terms: absolute floor scaled to their size
        np.testing.assert_allclose(gw.numpy(), np.asarray(rw), rtol=5e-4, atol=2e-4)
        np.testing.assert_allclose(gb.numpy(), np.asarray(rb), rtol=5e-4, atol=2e-4)


def test_x_gets_no_gradient():
    sizes = NETS["evm_k1"]
    _, _, flat, x = _setup(sizes, n=64)
    x.requires_grad_(True)
    flat.requires_grad_(True)
    out = ms.mlp_streams(flat, sizes, x)
    gflat, gx = torch.autograd.grad(out[0].sum() + out[3].sum(), [flat, x], allow_unused=True)
    assert gx is None and torch.count_nonzero(gflat) > 0


def test_cpu_path_launches_no_kernel():
    ms.reset_launch_counts()
    sizes = NETS["evm_k1"]
    _, _, flat, x = _setup(sizes, n=50)  # the plain version needs no padding
    flat.requires_grad_(True)
    out = ms.mlp_streams(flat, sizes, x)
    torch.autograd.grad(sum(t.sum() for t in out), [flat])
    assert ms.launch_counts == {"mlp_streams_fwd": 0, "mlp_streams_bwd": 0}
    with pytest.raises(ValueError, match="precision"):
        ms.mlp_streams(flat, sizes, x, precision="bf16")


def test_never_falls_back_off_the_cpu(monkeypatch):
    """A tensor that is neither on the CPU nor on a card goes to the kernel
    wrapper, which refuses it; the plain version must not run."""
    def boom(*a, **k):
        raise AssertionError("the plain version ran for a tensor off the CPU")
    monkeypatch.setattr(ms, "plain_mlp_streams", boom)
    sizes = NETS["main_k3"]
    flat = torch.zeros(param_count(sizes), device="meta")
    x = torch.zeros((64, 2), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ms.mlp_streams(flat, sizes, x)
    with pytest.raises(ValueError, match="CUDA"):
        ms.streams_bwd(flat, sizes, x, [torch.zeros((64, 3), device="meta")] * 5)


def test_tile_and_bounds_accounting_at_the_v1_width():
    sizes = layer_sizes(2, 3, 4, 120)
    # kernels 3 and 4 take the rule of kernels 1+2: 32 points, two 64-unit
    # weight panels per layer at "high"; the whole weight at 6x80
    assert ms.pick_bwd_tile(120, "high") == fr.pick_loss_tile(120, "high") == (32, 64)
    assert fr.loss_smem_bytes(32, 64, 120, 2) == 224_896  # one block per SM
    assert ms.pick_bwd_tile(80, "high") == (32, 80)
    assert ms.pick_bwd_tile(120, "high", 1) == fr.pick_loss_tile(120, "high", 1)
    assert param_count(sizes) == 44_283
    fwd, bwd = ms.flop_counts(sizes, 40_000)
    assert fwd == 40_000 * (3 * 5 * 2 * 120 * 120 + 5 * 2 * 120 * 3)  # 435,600 FLOP/point
    assert bwd == 40_000 * (3 * 3 * 5 * 2 * 120 * 120 + 2 * 5 * 2 * 120 * 3)
    b_fwd, b_bwd = ms.byte_counts(sizes, 40_000)
    assert b_fwd == 40_000 * (8 + 60) + 4 * 44_283  # reads 8 B, writes 60 B per point
    assert b_bwd == b_fwd + 4 * 44_283
    # the flagship width does the same matrix work as the fused pair's forward
    flagship = layer_sizes(2, 3, 6, 80)
    assert ms.flop_counts(flagship, 120_000)[0] == fr.flop_counts(flagship, 120_000)[0]
