"""PyTorch port: the precision names of the fused residual loss.

The kernel pair (kernels 1+2) runs every hidden and head product on bf16
parts of its operands, as the JAX kernels do. Its plain version
(`plain_residual_sums(..., precision=name)`) applies the same passes with
torch bf16 casts; here it is held against the JAX package's fused loss at
"high" (bf16x3), whose Pallas kernels run in interpret mode as the JAX
package's own tests run them. JAX's "default" and "highest" compute fp32 in
interpret mode on the CPU, so those two names are held to the kernels on the
card only (tests/test_torch_gpu.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsfnet_tpu.models.mlp import init_mlp as jax_init_mlp
from nsfnet_tpu.ops.pallas_mlp import _bf16_split as jax_bf16_split
from nsfnet_tpu.ops.pallas_residual import make_fused_residual_loss
from nsfnet_tpu_torch.models.convert import params_from_numpy
from nsfnet_tpu_torch.models.mlp import flatten_params, unflatten_params
from nsfnet_tpu_torch.ops import fused_residual as fr
from nsfnet_tpu_torch.ops.derivatives import mlp_derivatives_2d

torch.set_num_threads(2)

# Bf16 products are exact in fp32, so the emulation and the JAX kernel differ
# only in the order of fp32 sums: 2e-6 on the sums and on each gradient
# tensor (max|diff| / max|JAX|), 4e-6 on g_e (eq4 = eq1 (u - 1/2) + eq2 (v -
# 1/2) - e cancels a digit). Exact fp32 misses these bars at both sizes
# (3.6e-6 .. 1.6e-5), so they tell bf16x3 from fp32.
SUM_TOL, GRAD_TOL, GE_TOL = 2e-6, 2e-6, 4e-6

CASES = {"evm": ((2, 16, 16, 3), True), "vanilla": ((2, 24, 24, 3), False)}


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, (n, 2)).astype(np.float32)
    e = (0.1 * rng.standard_normal((n, 1))).astype(np.float32)
    vis_t = np.abs(0.01 * rng.standard_normal((n, 1))).astype(np.float32)
    eq_w = rng.uniform(0.2, 1.8, (n, 1)).astype(np.float32)
    eq_w[-37:] = 0.0
    return x, e, vis_t, eq_w


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("parts", [1, 2, 3])
def test_bf16_split_reconstructs_its_input(parts):
    rng = np.random.default_rng(parts)
    a = torch.from_numpy((rng.standard_normal(4096) * 10.0 ** rng.uniform(-3, 3, 4096))
                         .astype(np.float32))
    split = fr.bf16_split(a, parts)
    assert len(split) == parts
    for p in split:  # each part is a bf16 value
        assert torch.equal(p, p.to(torch.bfloat16).float())
    rest = a - sum(split)
    assert torch.all(rest.abs() <= a.abs() * 2.0 ** (-8 * parts))
    if parts == 3:  # 24 bits of mantissa in three 8-bit parts
        assert torch.count_nonzero(rest) < a.numel() // 100


def test_bf16_split_is_jaxs_split():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((64, 48)).astype(np.float32)
    hi, lo = fr.bf16_split(torch.from_numpy(a), 2)
    jhi, jlo = jax_bf16_split(jnp.asarray(a))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi, np.float32))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo, np.float32))


@pytest.mark.parametrize("parts", [1, 2, 3])
def test_pass_dot_and_its_split_backward(parts):
    """The forward is the sum of the passes; the backward splits the
    cotangent too (JAX's _dot_nt / _dot_tn inside the custom_vjp)."""
    rng = np.random.default_rng(10 + parts)
    a = torch.from_numpy(rng.standard_normal((40, 24)).astype(np.float32)).requires_grad_(True)
    b = torch.from_numpy(rng.standard_normal((24, 16)).astype(np.float32)).requires_grad_(True)
    g = torch.from_numpy(rng.standard_normal((40, 16)).astype(np.float32))
    out = fr.pass_dot(a, b, parts)
    sa, sb, sg = fr.bf16_split(a.detach(), parts), fr.bf16_split(b.detach(), parts), \
        fr.bf16_split(g, parts)
    pairs = [(i, j) for i in range(parts) for j in range(parts - i)]
    assert len(pairs) == [1, 3, 6][parts - 1]
    ref = sum(sa[i].double() @ sb[j].double() for i, j in pairs)
    torch.testing.assert_close(out.double(), ref, rtol=1e-6, atol=1e-6)  # fp32 sums of 24
    ga, gb = torch.autograd.grad(out, [a, b], g)
    torch.testing.assert_close(
        ga.double(), sum(sg[i].double() @ sb[j].double().t() for i, j in pairs),
        rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(
        gb.double(), sum(sa[i].double().t() @ sg[j].double() for i, j in pairs),
        rtol=1e-6, atol=1e-5)  # fp32 sums of 40
    exact = a.detach().double() @ b.detach().double()
    err = ((out.detach().double() - exact).abs().max() / exact.abs().max()).item()
    assert err < [1e-2, 1e-4, 1e-6][parts - 1]  # one pass: bf16; three: ~2^-16; six: fp32


def test_emulated_engine_at_full_precision_is_the_closed_form():
    sizes = (2, 16, 16, 16, 3)
    params = params_from_numpy(jax_init_mlp(jax.random.PRNGKey(3), sizes))
    x = torch.from_numpy(_inputs(256, 3)[0])
    ref = mlp_derivatives_2d(params, x)
    for got, want in zip(fr.emulated_derivatives(params, x, 3), ref):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_high_matches_jax_fused_loss(case):
    sizes, evm = CASES[case]
    n, scale, re = 512, 2.0, 400.0
    jp = jax_init_mlp(jax.random.PRNGKey(5), sizes)
    x, e, vis_t, w = _inputs(n, 5)
    ct = np.array([0.7, 1.3, 0.9, 0.4][: 4 if evm else 3], np.float32)
    jfused = make_fused_residual_loss("high", scale, evm)  # interpret mode on CPU
    jx, je, jv, jw = (jnp.asarray(a) for a in (x, e, vis_t, w))
    if evm:
        jfn = lambda p, ee: jnp.sum(jfused(p, jx, ee, jv, jw, jnp.float32(re)) * ct)
        jsums = jfused(jp, jx, je, jv, jw, jnp.float32(re))
        jgp, jge = jax.grad(jfn, argnums=(0, 1))(jp, je)
    else:
        jfn = lambda p: jnp.sum(jfused(p, jx, jw, jnp.float32(re)) * ct)
        jsums = jfused(jp, jx, jw, jnp.float32(re))
        jgp, jge = jax.grad(jfn)(jp), None

    errs = {}
    for precision in ("high", None):
        flat = flatten_params(params_from_numpy(jp)).requires_grad_(True)
        et = torch.from_numpy(e).requires_grad_(True)
        sums = fr.plain_residual_sums(unflatten_params(flat, sizes), torch.from_numpy(x),
                                      et if evm else None,
                                      torch.from_numpy(vis_t) if evm else None,
                                      torch.from_numpy(w), re, scale, evm, precision=precision)
        grads = torch.autograd.grad((sums * torch.from_numpy(ct)).sum(),
                                    [flat, et] if evm else [flat])
        errs[precision] = (
            float(np.max(np.abs(sums.detach().numpy() - np.asarray(jsums))
                         / np.abs(np.asarray(jsums)))),
            max(_rel(a.numpy(), np.asarray(b))
                for pa, pb in zip(unflatten_params(grads[0], sizes), jgp) for a, b in zip(pa, pb)),
            _rel(grads[1].numpy(), np.asarray(jge)) if evm else 0.0)
    s, g, ge = errs["high"]
    assert s <= SUM_TOL and g <= GRAD_TOL and ge <= GE_TOL, errs
    # the bars discriminate: exact fp32 falls outside them
    s, g, ge = errs[None]
    assert s > SUM_TOL and g > GRAD_TOL and (ge > GE_TOL or not evm), errs


def test_cpu_entry_point_stays_exact_fp32():
    """On the CPU the entry point computes exact fp32 whatever the name (the
    solver's CPU path); only the kernels run the passes."""
    sizes = (2, 16, 16, 3)
    flat = flatten_params(params_from_numpy(jax_init_mlp(jax.random.PRNGKey(6), sizes)))
    x, e, vis_t, w = (torch.from_numpy(a) for a in _inputs(128, 6))
    exact = fr.plain_residual_sums(unflatten_params(flat, sizes), x, e, vis_t, w, 100.0)
    for name in fr.PRECISIONS:
        assert torch.equal(fr.fused_residual_loss(flat, sizes, x, e, vis_t, w, 100.0,
                                                  precision=name), exact)
    default = fr.plain_residual_sums(unflatten_params(flat, sizes), x, e, vis_t, w, 100.0,
                                     precision="default")
    assert not torch.equal(default, exact)
