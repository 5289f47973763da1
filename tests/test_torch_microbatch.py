"""PyTorch port: the microbatched training step on the CPU — `microbatches`
2 and 4 against the JAX solver's make_microbatched_train_step at the same
count and against the port's own full batch, on the velocity formulation
with the EVM net (the fused residual loss, and the five-stream engine with
it off) and on the streamfunction formulation; the kernel wrappers run
their plain versions on CPU tensors. The L2 loss refuses microbatching, as
the JAX solver does (tests/test_solver.py:416).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from nsfnet_tpu.data.cavity import CavityData as JaxCavityData
from nsfnet_tpu.training.solver import PINNSolver as JaxSolver
from nsfnet_tpu_torch.data.cavity import CavityData
from nsfnet_tpu_torch.models.convert import params_from_numpy
from nsfnet_tpu_torch.models.mlp import flatten_params
from nsfnet_tpu_torch.ops.fused_residual import ROW_ALIGN
from nsfnet_tpu_torch.training.solver import PINNSolver
from nsfnet_tpu_torch.training.step import make_grad_fn

torch.set_num_threads(2)

ARCH = dict(Re=400, layers=2, layers_1=2, hidden_size=16, hidden_size_1=8, N_f=300,
            alpha_evm=0.03, bc_weight=10, eq_weight=1, seed=7, evm_update_freq=2,
            log_interval=1, checkpoint_freq=10**9)
DATA = dict(N_f=300, sort_training_points=False, sdf_enabled=True, coord_transform=True,
            seed=3)
STEPS = 5
# variant: (formulation, NSFNET_FUSED_LOSS)
VARIANTS = {"fused": ("velocity", None), "unfused": ("velocity", "0"),
            "streamfunction": ("streamfunction", None)}


@functools.lru_cache(maxsize=None)
def _jax_run(formulation: str, micro: int):
    """The JAX solver at `micro` microbatches (its XLA engine): its initial
    weights, its full-batch gradient there (port layout), and STEPS Adam
    steps' metrics (total, eq, bc, eq1..eq4)."""
    js = JaxSolver(**ARCH, formulation=formulation, microbatches=micro, mesh_devices=1,
                   matmul_precision="highest", checkpoint_path="/nonexistent")
    jd = JaxCavityData(**DATA, use_native=False)
    js.set_boundary_data(X=jd.boundary_data())
    js.set_eq_training_data(X=jd.training_data(), weights=jd.sdf_weights)
    js.set_coordinate_transform(jd.coord_scale)
    js._ensure_ready()
    weights = (jax.device_get(js.state.params), jax.device_get(js.state.params_evm))
    sc = js._stage_scalars(1e-3)
    grads = jax.jit(jax.grad(lambda pa, b, v: js._loss_fn(pa, b, v, sc)[0]))(
        (js.state.params, js.state.params_evm), js._batch, js.state.vis_t_minus)
    flat = lambda tree: flatten_params(params_from_numpy(jax.device_get(tree))).numpy()
    js.train(num_epoch=STEPS, lr=1e-3)
    return weights, [flat(g) for g in grads], np.asarray(js._loss_history)[:, 1:]


def _port(tmp_path, monkeypatch, variant, micro):
    formulation, fused = VARIANTS[variant]
    if fused is None:
        monkeypatch.delenv("NSFNET_FUSED_LOSS", raising=False)
    else:
        monkeypatch.setenv("NSFNET_FUSED_LOSS", fused)
    s = PINNSolver(**ARCH, formulation=formulation, microbatches=micro, engine="pallas",
                   checkpoint_path=str(tmp_path), device="cpu")
    d = CavityData(**DATA)
    s.set_boundary_data(X=d.boundary_data())
    s.set_eq_training_data(X=d.training_data(), weights=d.sdf_weights)
    s.set_coordinate_transform(d.coord_scale)
    weights, _, _ = _jax_run(formulation, 2)  # the initial weights: any count
    s.set_params(params_from_numpy(weights[0]), params_from_numpy(weights[1]))
    return s


def _grads(s):
    """The port's gradient of both nets at its current state, through its
    own step's gradient function (make_grad_fn at its microbatch count)."""
    s._ensure_ready()
    st = s.state
    leaves = [st.params.detach().clone().requires_grad_(True),
              st.params_evm.detach().clone().requires_grad_(True)]
    grads, _, _ = make_grad_fn(s._make_loss(), s.microbatches)(
        tuple(leaves), leaves, s._batch, st.vis_t_minus, s._stage_scalars(1e-3))
    return [g.numpy() for g in grads]


def _history(s):
    return np.asarray([(m.total, m.equation, m.boundary, m.eq1, m.eq2, m.eq3, m.eq4)
                       for _, m in s.loss_history])


@pytest.mark.parametrize("micro", [2, 4])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_microbatched_step_matches_jax_and_the_full_batch(tmp_path, monkeypatch, variant,
                                                          micro):
    """From the JAX solver's initial weights: the port's first gradient at
    `micro` slices within rtol 5e-4 / atol 5e-6 of JAX's full-batch
    gradient, then 5 Adam steps (the EVM net updating at stage epochs 2 and
    4) with every logged metric within rtol 2e-5 of the JAX solver's
    microbatched run, float32 on both sides; against the port's own full
    batch the same sums in another order: metrics within rtol 2e-6, params
    within 1e-6."""
    formulation, _ = VARIANTS[variant]
    _, jgrads, jhist = _jax_run(formulation, micro)
    s = _port(tmp_path / "m", monkeypatch, variant, micro)
    rows = s._eq_pad_size(ARCH["N_f"])
    assert rows % (micro * ROW_ALIGN) == 0  # every slice whole kernel tiles
    for got, ref in zip(_grads(s), jgrads):
        np.testing.assert_allclose(got, ref, rtol=5e-4, atol=5e-6)
    s.train(num_epoch=STEPS, lr=1e-3)
    assert s.state.opt_evm.count == 2 and s.state.vis_t_minus.shape == (rows, 1)
    hist = _history(s)
    assert hist.shape == jhist.shape == (STEPS, 7)
    np.testing.assert_allclose(hist, jhist, rtol=2e-5, atol=0)
    assert hist[-1, 0] < hist[0, 0]

    full = _port(tmp_path / "full", monkeypatch, variant, 1)
    full.train(num_epoch=STEPS, lr=1e-3)
    np.testing.assert_allclose(hist, _history(full), rtol=2e-6, atol=1e-12)
    for a, b in ((s.state.params, full.state.params),
                 (s.state.params_evm, full.state.params_evm)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    real = ARCH["N_f"]
    torch.testing.assert_close(s.state.vis_t_minus[:real], full.state.vis_t_minus[:real],
                               rtol=1e-5, atol=1e-9)


def test_l2_loss_refuses_microbatching():
    """An L2 norm is not a sum of per-slice parts (nsfnet_tpu solver.py:152-153)."""
    with pytest.raises(ValueError, match="microbatching"):
        PINNSolver(**{**ARCH, "evm": False, "layers_1": None}, loss_mode="L2", microbatches=2,
                   device="cpu")
    with pytest.raises(ValueError):
        JaxSolver(**{**ARCH, "evm": False, "layers_1": None}, loss_mode="L2", microbatches=2,
                  mesh_devices=1)
