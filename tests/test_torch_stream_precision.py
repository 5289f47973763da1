"""PyTorch port: the precision names of the stream engines.

Kernels 3 and 4 (the five-stream engine) and kernels 5 and 6 (the order-3
engine) run every hidden and head product on bf16 parts of their operands
at the name's passes, as the JAX kernels do. Their plain versions
(`plain_mlp_streams` / `plain_mlp_streams_bwd(..., precision=name)`,
`plain_psi_streams` / `plain_psi_streams_bwd(..., precision=name)`) apply
the same passes with torch bf16 casts; here they are held at "high"
(bf16x3) against the JAX package's kernels, whose Pallas code runs in
interpret mode as the JAX package's own tests run it. JAX's "default" and
"highest" compute fp32 in interpret mode on the CPU, so those two names are
held to the kernels on the card only (tests/test_torch_gpu.py,
chip_smoke.py). Every CPU entry point computes exact fp32 at every name.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsfnet_tpu.models.mlp import init_mlp as jax_init_mlp
from nsfnet_tpu.ops import pallas_mlp as JM
from nsfnet_tpu.ops import pallas_psi as JP
from nsfnet_tpu.ops.pallas_mlp import TILE, make_fused_mlp_derivatives
from nsfnet_tpu_torch.models.convert import params_from_numpy
from nsfnet_tpu_torch.models.mlp import flatten_params, unflatten_params
from nsfnet_tpu_torch.ops import fused_residual as fr
from nsfnet_tpu_torch.ops import mlp_streams as ms
from nsfnet_tpu_torch.ops import psi_streams as psi
from nsfnet_tpu_torch.ops.derivatives import mlp_psi_streams

torch.set_num_threads(2)

# Bf16 products are exact in fp32, so the emulation and the JAX kernel differ
# only in the order of fp32 sums and in the elementwise rounding of the
# adjoint: 2e-6 per gradient tensor (max|diff| / max|JAX|) for the
# five-stream engine, the bar of the fused loss's precision test; 4e-6 for
# the order-3 engine, whose third-order terms (d4 z1^3 against d2 z3) cancel
# a digit, as eq4 does for g_e there (2.5e-6 measured at this seed). Exact
# fp32 misses each bar (2.0e-5 for the order-3 engine; asserted below), so
# the bars tell bf16x3 from fp32.
GRAD_TOL, PSI_GRAD_TOL = 2e-6, 4e-6
# The forwards, per stream against JAX's "high" streams. The two sides run
# the same bf16x3 products on inputs that differ by the last bits of tanh
# (XLA's and torch's); where such a difference carries an operand across a
# rounding edge of its low bf16 part, that point moves by up to ~2^-16 of
# the term. So a point-wise bar only bounds those flips: FWD_MAX_TOL, 2e-5
# (max|diff| / max|JAX|; measured 1.3e-5 .. 1.6e-5 here), which exact fp32
# also meets at the margin (2.2e-5 .. 3.6e-5 on these nets, so it narrowly
# misses). The flips are rare, and bf16x3's own truncation is everywhere:
# norm-wise (||diff|| / ||JAX||) the plain "high" passes sit 1.9e-6 ..
# 3.3e-6 from JAX and exact fp32 1.2e-5 .. 2.4e-5, so FWD_NORM_TOL, 5e-6,
# tells bf16x3 from fp32 (asserted below).
FWD_MAX_TOL, FWD_NORM_TOL = 2e-5, 5e-6
N = TILE  # one JAX tile: 512 points

MLP_NETS = {"k3": (2, 16, 16, 3), "k1": (2, 16, 16, 1)}


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _setup(sizes, n_streams, seed):
    rng = np.random.default_rng(seed)
    jp = jax_init_mlp(jax.random.PRNGKey(seed), sizes)
    flat = flatten_params(params_from_numpy(jp))
    x = rng.uniform(-1.0, 1.0, (N, 2)).astype(np.float32)
    cts = [rng.standard_normal((N, sizes[-1])).astype(np.float32) for _ in range(n_streams)]
    return jp, flat, x, cts


def _grad_errors(plain_bwd, flat, sizes, x, cts, jgrads):
    """Worst per-tensor error of the plain backward against JAX's gradient,
    at "high" and in exact fp32."""
    errs = {}
    for precision in ("high", None):
        got = plain_bwd(flat, sizes, torch.from_numpy(x), [torch.from_numpy(c) for c in cts],
                        precision)
        errs[precision] = max(_rel(a.numpy(), np.asarray(b))
                              for pa, pb in zip(unflatten_params(got, sizes), jgrads)
                              for a, b in zip(pa, pb))
    return errs


def _fwd_errors(plain_fwd, flat, sizes, x, jstreams):
    """Per-stream errors of the plain forward against JAX's streams, at
    "high" and in exact fp32: (max-wise, norm-wise) worst over the streams."""
    errs = {}
    for precision in ("high", None):
        got = plain_fwd(flat, sizes, torch.from_numpy(x), precision)
        assert len(got) == len(jstreams)
        pairs = [(a.numpy(), np.asarray(b)) for a, b in zip(got, jstreams)]
        errs[precision] = (max(_rel(a, b) for a, b in pairs),
                           max(float(np.linalg.norm(a - b) / np.linalg.norm(b))
                               for a, b in pairs))
    return errs


@pytest.mark.parametrize("engine,sizes", [("mlp", MLP_NETS["k3"]), ("mlp", MLP_NETS["k1"]),
                                          ("psi", (2, 16, 16, 2))], ids=["k3", "k1", "psi"])
def test_plain_forward_at_high_matches_jax(engine, sizes):
    jp, flat, x, _ = _setup(sizes, 0, 15 if engine == "mlp" else 16)
    jax_mod, plain = (JM, ms.plain_mlp_streams) if engine == "mlp" else \
        (JP, psi.plain_psi_streams)
    # the JAX forward kernel at "high" (interpret mode on the CPU)
    jstreams = jax_mod._fwd_pallas(jp, jnp.asarray(x), "high")
    errs = _fwd_errors(plain, flat, sizes, x, jstreams)
    assert errs["high"][0] <= FWD_MAX_TOL and errs["high"][1] <= FWD_NORM_TOL, errs
    assert errs[None][1] > FWD_NORM_TOL, errs  # the norm-wise bar discriminates


@pytest.mark.parametrize("net", sorted(MLP_NETS))
def test_plain_stream_backward_at_high_matches_jax(net):
    sizes = MLP_NETS[net]
    jp, flat, x, cts = _setup(sizes, 5, 11)
    engine = make_fused_mlp_derivatives("high")  # interpret mode on the CPU
    _, vjp = jax.vjp(lambda p: engine(p, jnp.asarray(x)), jp)
    (jgrads,) = vjp(tuple(jnp.asarray(c) for c in cts))
    errs = _grad_errors(ms.plain_mlp_streams_bwd, flat, sizes, x, cts, jgrads)
    assert errs["high"] <= GRAD_TOL, errs
    assert errs[None] > GRAD_TOL, errs  # the bar discriminates


def test_plain_psi_backward_at_high_matches_jax():
    sizes = (2, 16, 16, 2)
    jp, flat, x, cts = _setup(sizes, 13, 12)
    # the JAX kernel's vjp of the 13 raw streams (interpret mode on the CPU)
    jgrads = JP._bwd_pallas(jp, jnp.asarray(x), tuple(jnp.asarray(c) for c in cts), "high")
    errs = _grad_errors(psi.plain_psi_streams_bwd, flat, sizes, x, cts, jgrads)
    assert errs["high"] <= PSI_GRAD_TOL, errs
    assert errs[None] > PSI_GRAD_TOL, errs  # the bar discriminates


def test_emulated_psi_streams_at_three_parts_is_the_closed_form():
    sizes = (2, 16, 16, 16, 2)
    jp, _, x, _ = _setup(sizes, 0, 13)
    params, xt = params_from_numpy(jp), torch.from_numpy(x)
    got, ref = psi.emulated_psi_streams(params, xt, 3), mlp_psi_streams(params, xt)
    assert len(got) == len(ref) == 13
    for g, r in zip(got, ref):
        # six passes keep ~24 bits; third-order streams are O(10) here
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6 * max(r.abs().max().item(), 1.0))
    one = psi.emulated_psi_streams(params, xt, 1)
    assert max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(one, ref)) > 1e-4


@pytest.mark.parametrize("engine", ["mlp", "psi"])
def test_cpu_entry_points_stay_exact_fp32(engine):
    """On the CPU the entry points compute exact fp32, forward and gradient,
    whatever the name (the solver's CPU path); only the kernels run the
    passes."""
    sizes = (2, 16, 16, 2)
    jp, flat, x, _ = _setup(sizes, 0, 14)
    xt = torch.from_numpy(x[:64])
    if engine == "mlp":
        fn = lambda f, name: ms.mlp_streams(f, sizes, xt, precision=name)
        plain = lambda f: ms.plain_mlp_streams(f, sizes, xt)
    else:
        fn = lambda f, name: psi.psi_streams(f, sizes, xt, 1.5, precision=name)
        plain = lambda f: psi.assemble_psi_bundle(psi.plain_psi_streams(f, sizes, xt), 1.5)
    loss = lambda out: sum((o ** 2).sum() for o in out)
    f = flat.clone().requires_grad_(True)
    ref = plain(f)
    (ref_g,) = torch.autograd.grad(loss(ref), [f])
    for name in fr.PRECISIONS:
        out = fn(f, name)
        assert all(torch.equal(a, b) for a, b in zip(out, ref))
        (g,) = torch.autograd.grad(loss(out), [f])
        assert torch.equal(g, ref_g)
