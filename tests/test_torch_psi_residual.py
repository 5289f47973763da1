"""PyTorch port: the streamfunction Adam step's two written-out passes on
the CPU. The residual glue (ops/psi_residual.py): the backward glue
kernel's chain rule, written out in `plain_psi_residual_bwd`, against
autograd of the unfused bundle -> residuals -> sums; the fused entry's
plain version against the unfused path, bitwise; the solver's routing of a
streamfunction MSE step on `pallas` through it. The boundary pass
(ops/derivatives.psi_p_uv_stacked): its stacked forward and written-out
backward against psi_p_uv and autograd. The kernels themselves run in
tests/test_torch_gpu.py."""

import numpy as np
import pytest
import torch

from nsfnet_tpu_torch.models.mlp import flatten_params, init_mlp, unflatten_params
from nsfnet_tpu_torch.ops import fused_residual as fr
from nsfnet_tpu_torch.ops import losses as L
from nsfnet_tpu_torch.ops import psi_residual as pr
from nsfnet_tpu_torch.ops import residuals as R
from nsfnet_tpu_torch.ops.derivatives import (N_PSI_STREAMS, _StackedPsiPUV, psi_p_uv,
                                              psi_p_uv_stacked)
from nsfnet_tpu_torch.ops.psi_streams import plain_psi_streams, psi_streams
from nsfnet_tpu_torch.training.solver import PINNSolver

torch.set_num_threads(2)


def _glue_inputs(n, seed):
    g = torch.Generator().manual_seed(seed)
    streams = tuple(torch.randn(n, 2, generator=g, dtype=torch.float64)
                    for _ in range(N_PSI_STREAMS))
    e = 0.1 * torch.randn(n, 1, generator=g, dtype=torch.float64)
    vis_t = (0.01 * torch.randn(n, 1, generator=g, dtype=torch.float64)).abs()
    w = torch.rand(n, 1, generator=g, dtype=torch.float64) * 1.6 + 0.2
    w[-5:] = 0.0
    return streams, e, vis_t, w


@pytest.mark.parametrize("evm", [True, False], ids=["evm", "vanilla"])
@pytest.mark.parametrize("scale", [1.0, 2.5])
def test_written_out_backward_matches_autograd(evm, scale):
    """Float64, so the two differ by rounding only: every stream's and e's
    cotangent of ct . S, S the sums of the unfused operations."""
    streams, e, vis_t, w = _glue_inputs(96, seed=int(scale * 10) + evm)
    if not evm:
        e = vis_t = None
    ct = torch.tensor([0.7, -1.3, 0.4, 2.1][:4 if evm else 3], dtype=torch.float64)
    leaves = [s.clone().requires_grad_(True) for s in streams]
    e_leaf = e.clone().requires_grad_(True) if evm else None
    sums = pr.plain_psi_residual_sums(leaves, e_leaf, vis_t, w, 400.0, scale, evm)
    assert sums.shape == (4 if evm else 3,) and sums[2].item() == 0.0  # continuity exact
    wrt = leaves + ([e_leaf] if evm else [])
    ref = torch.autograd.grad(sums, wrt, ct, allow_unused=True)
    cts, g_e = pr.plain_psi_residual_bwd(streams, e, vis_t, w, ct, 400.0, scale, evm)
    assert len(cts) == N_PSI_STREAMS and all(c.shape == (96, 2) for c in cts)
    for q, (got, want) in enumerate(zip(cts, ref[:N_PSI_STREAMS])):
        want = torch.zeros_like(got) if want is None else want
        torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-12, msg=f"stream {q}")
    # the streams the bundle never reads get exact zeros
    for q in (0, 3, 4):
        assert not cts[q].any()
    assert not torch.cat([cts[q][:, 1] for q in range(5, 13)]).any()
    if evm:
        torch.testing.assert_close(g_e, ref[-1], rtol=1e-10, atol=1e-12)
    else:
        assert g_e is None


@pytest.mark.parametrize("evm", [True, False], ids=["evm", "vanilla"])
def test_fused_entry_on_the_cpu_is_the_unfused_path(evm):
    """On the CPU `fused_residual_loss(..., formulation="streamfunction")`
    runs the unfused path's operations: the same sums and gradient, bit for
    bit."""
    sizes = (2, 16, 16, 2)
    flat = flatten_params(init_mlp(sizes, torch.Generator().manual_seed(3)))
    rng = np.random.default_rng(1)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32)
    x = t(rng.uniform(-1, 1, (64, 2)))
    e = t(0.1 * rng.standard_normal((64, 1))) if evm else None
    vis_t = t(np.abs(0.01 * rng.standard_normal((64, 1)))) if evm else None
    w = t(rng.uniform(0.2, 1.8, (64, 1)))
    a = flat.clone().requires_grad_(True)
    got = fr.fused_residual_loss(a, sizes, x, e, vis_t, w, 2000.0, coord_scale=2.0, evm=evm,
                                 formulation="streamfunction")
    b = flat.clone().requires_grad_(True)
    derivs = psi_streams(b, sizes, x, 2.0)
    res = (R.ev_ns_residuals(derivs, e, vis_t, 2000.0, 2.0) if evm
           else R.ns_residuals(derivs, 2000.0, 2.0))
    eqs = [res.eq1, res.eq2, res.eq3] + ([res.eq4] if evm else [])
    want = torch.stack([L.masked_sum_sq(q, w) for q in eqs])
    assert torch.equal(got, want)
    (ga,) = torch.autograd.grad(got.sum(), [a])
    (gb,) = torch.autograd.grad(want.sum(), [b])
    assert torch.equal(ga, gb)
    sums = pr.plain_psi_residual_sums(plain_psi_streams(flat, sizes, x), e, vis_t, w, 2000.0,
                                      2.0, evm)
    assert torch.equal(sums, want.detach())


def test_entry_refuses_what_it_does_not_take():
    sizes = (2, 8, 8, 3)
    flat = flatten_params(init_mlp(sizes, torch.Generator().manual_seed(0)))
    x, w = torch.zeros(16, 2), torch.ones(16, 1)
    with pytest.raises(ValueError, match="head"):
        pr.psi_residual_loss(flat, sizes, x, None, None, w, 100.0, evm=False)
    with pytest.raises(ValueError, match="formulation"):
        fr.fused_residual_loss(flat, sizes, x, None, None, w, 100.0, evm=False,
                               formulation="vorticity")
    with pytest.raises(ValueError, match="CUDA"):  # the launchers take card tensors only
        pr.residual_fwd(tuple(torch.zeros(16, 2) for _ in range(N_PSI_STREAMS)), None, None, w,
                        100.0, 1.0, False)


@pytest.mark.parametrize("evm", [True, False], ids=["evm", "vanilla"])
def test_solver_routes_the_streamfunction_mse_step_through_the_fused_entry(evm, monkeypatch):
    """`pallas` with the fused loss on: one fused call a step, with the
    formulation; NSFNET_FUSED_LOSS=0 or L2 mode: none."""
    monkeypatch.delenv("NSFNET_FUSED_LOSS", raising=False)
    import nsfnet_tpu_torch.training.solver as solver_mod

    seen = []
    real = solver_mod.fused_residual_loss

    def spy(*args, **kwargs):
        seen.append(kwargs["formulation"])
        return real(*args, **kwargs)

    monkeypatch.setattr(solver_mod, "fused_residual_loss", spy)
    rng = np.random.default_rng(0)

    def run(**kw):
        kw = {**dict(evm=evm, layers_1=2 if evm else None), **kw}
        s = PINNSolver(layers=2, hidden_size=8, hidden_size_1=8, N_f=64,
                       formulation="streamfunction", engine="pallas", device="cpu", **kw)
        s.set_boundary_data(X=tuple(rng.uniform(size=(16, 1)) for _ in range(4)))
        s.set_eq_training_data(X=(rng.uniform(size=(64, 1)), rng.uniform(size=(64, 1))))
        s.run_steps(2, 1e-3)

    run()
    assert seen == ["streamfunction"] * 2
    seen.clear()
    run(loss_mode="L2")
    monkeypatch.setenv("NSFNET_FUSED_LOSS", "0")
    run()
    assert seen == []


@pytest.mark.parametrize("sizes", [(2, 16, 16, 16, 2), (2, 12, 2), (2, 24, 24, 3)])
@pytest.mark.parametrize("uv_scale", [1.0, 2.5])
def test_stacked_boundary_pass_matches_psi_p_uv_and_autograd(sizes, uv_scale):
    """Float64: the values and the gradient of a random cotangent, against
    psi_p_uv and autograd through it; a one-hidden-layer net and a wider
    head too."""
    flat = flatten_params(init_mlp(sizes, torch.Generator().manual_seed(5))).double()
    x = torch.as_tensor(np.random.default_rng(2).uniform(-1, 1, (40, 2)))
    g = torch.as_tensor(np.random.default_rng(3).standard_normal((40, 3)))
    a = flat.clone().requires_grad_(True)
    got = _StackedPsiPUV.apply(a, x, sizes, uv_scale)
    b = flat.clone().requires_grad_(True)
    want = psi_p_uv(unflatten_params(b, sizes), x, uv_scale)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-13)
    (ga,) = torch.autograd.grad(got, [a], g)
    (gb,) = torch.autograd.grad(want, [b], g)
    torch.testing.assert_close(ga, gb, rtol=1e-11, atol=1e-13)


def test_stacked_boundary_pass_runs_psi_p_uv_on_the_cpu():
    sizes = (2, 16, 16, 2)
    flat = flatten_params(init_mlp(sizes, torch.Generator().manual_seed(1)))
    x = torch.rand(32, 2)
    assert torch.equal(psi_p_uv_stacked(flat, sizes, x, 2.0),
                       psi_p_uv(unflatten_params(flat, sizes), x, 2.0))
    # float32 through the written-out pass: fp32 rounding only
    torch.testing.assert_close(_StackedPsiPUV.apply(flat, x, sizes, 2.0),
                               psi_p_uv(unflatten_params(flat, sizes), x, 2.0),
                               rtol=1e-5, atol=1e-6)
