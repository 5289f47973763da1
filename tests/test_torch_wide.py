"""PyTorch port: nets wider than any resident plan of the kernels, on the
CPU, against the JAX package. The port's PINNSolver on engine "pallas" at
2x352 "high" (velocity, the fused residual loss) and 2x224 "high"
(streamfunction), each from the JAX solver's initial weights, against the
JAX solver on its Pallas engine, whose kernels run in interpret mode here
(the port's wrappers run their plain versions on CPU tensors); and the
Net2Net widening 288 -> 352 of both packages, each widened net computing its
donor's function."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsfnet_tpu.data.cavity import CavityData as JaxCavityData
from nsfnet_tpu.models import mlp as jax_mlp
from nsfnet_tpu.training.solver import PINNSolver as JaxSolver
from nsfnet_tpu_torch.data.cavity import CavityData
from nsfnet_tpu_torch.models import mlp as port_mlp
from nsfnet_tpu_torch.models.convert import params_from_numpy
from nsfnet_tpu_torch.models.mlp import flatten_params
from nsfnet_tpu_torch.ops import fused_residual as fr
from nsfnet_tpu_torch.ops import psi_streams as ps
from nsfnet_tpu_torch.training.solver import PINNSolver

torch.set_num_threads(2)

ARCH = dict(Re=2000, layers=2, layers_1=2, hidden_size_1=8, N_f=64, alpha_evm=0.03,
            bc_weight=10, eq_weight=1, seed=7, evm_update_freq=2, log_interval=1,
            checkpoint_freq=10**9, matmul_precision="high")
DATA = dict(N_f=64, sort_training_points=False, sdf_enabled=True, coord_transform=True,
            seed=3)


def _jax_loss_and_grads(formulation, h):
    """The JAX solver on its Pallas engine (interpret mode on the CPU): its
    initial weights, and its loss and gradient there (port layout)."""
    js = JaxSolver(**ARCH, hidden_size=h, formulation=formulation, engine="pallas",
                   mesh_devices=1, checkpoint_path="/nonexistent")
    assert js.engine == "pallas"
    jd = JaxCavityData(**DATA, use_native=False)
    js.set_boundary_data(X=jd.boundary_data())
    js.set_eq_training_data(X=jd.training_data(), weights=jd.sdf_weights)
    js.set_coordinate_transform(jd.coord_scale)
    js._ensure_ready()
    loss = js._make_loss("pallas", None)
    sc = js._stage_scalars(1e-3)
    weights = (js.state.params, js.state.params_evm)
    value, grads = jax.value_and_grad(
        lambda pa: loss(pa, js._batch, js.state.vis_t_minus, sc)[0])(weights)
    flat = lambda tree: flatten_params(params_from_numpy(jax.device_get(tree))).numpy()
    return jax.device_get(weights), float(value), [flat(g) for g in grads]


def _port_loss_and_grads(formulation, h, weights):
    s = PINNSolver(**ARCH, hidden_size=h, formulation=formulation, engine="pallas",
                   checkpoint_path="/nonexistent", device="cpu")
    assert s.engine == "pallas"
    d = CavityData(**DATA)
    s.set_boundary_data(X=d.boundary_data())
    s.set_eq_training_data(X=d.training_data(), weights=d.sdf_weights)
    s.set_coordinate_transform(d.coord_scale)
    s.set_params(params_from_numpy(weights[0]), params_from_numpy(weights[1]))
    s._ensure_ready()
    leaves = [s.state.params.detach().clone().requires_grad_(True),
              s.state.params_evm.detach().clone().requires_grad_(True)]
    value = s._make_loss()(tuple(leaves), s._batch, s.state.vis_t_minus,
                           s._stage_scalars(1e-3))[0]
    grads = torch.autograd.grad(value, leaves)
    return float(value.detach()), [g.numpy() for g in grads]


@pytest.mark.parametrize("formulation,h", [("velocity", 352), ("streamfunction", 224)])
def test_wide_solver_matches_the_jax_solver(formulation, h):
    """A width no resident plan fits at "high" (the card streams the
    carries there): the port's loss within rtol 2e-5 of the JAX solver's and
    its gradients within rtol 5e-4 / atol 5e-6, float32 on both sides (the
    JAX kernels' bf16x3 passes against the port's exact fp32 plain version
    on the CPU)."""
    plan = ps.psi_plan(h, "high") if formulation == "streamfunction" else fr.loss_plan(h, "high")
    assert plan.streamed
    weights, jval, jgrads = _jax_loss_and_grads(formulation, h)
    pval, pgrads = _port_loss_and_grads(formulation, h, weights)
    np.testing.assert_allclose(pval, jval, rtol=2e-5)
    for got, ref in zip(pgrads, jgrads):
        np.testing.assert_allclose(got, ref, rtol=5e-4, atol=5e-6)


def test_widening_288_to_352_preserves_the_function_in_both_packages():
    """Net2Net 288 -> 352 (nsfnet_tpu/models/mlp.py widen_mlp_params, the
    port's models/mlp.py widen_mlp_params): the two draw their new incoming
    weights from different generators, so each widened net is held to its
    own donor's outputs on the same points, and both donors are the same
    net."""
    sizes = jax_mlp.layer_sizes(2, 3, 3, 288)
    donor = jax_mlp.init_mlp(jax.random.PRNGKey(11), sizes)
    x = np.random.default_rng(5).uniform(0.0, 1.0, (512, 2)).astype(np.float32)
    jax_wide = jax_mlp.widen_mlp_params(donor, 352, jax.random.PRNGKey(12))
    port_donor = params_from_numpy(jax.device_get(donor))
    port_wide = port_mlp.widen_mlp_params(port_donor, 352, torch.Generator().manual_seed(12))
    assert [tuple(w.shape) for w, _ in port_wide] == [tuple(w.shape) for w, _ in jax_wide]
    assert port_wide[1][0].shape == (352, 352) and port_wide[-1][0].shape == (352, 3)
    j_donor = np.asarray(jax_mlp.mlp_apply(donor, jnp.asarray(x)))
    j_wide = np.asarray(jax_mlp.mlp_apply(jax_wide, jnp.asarray(x)))
    with torch.no_grad():
        p_donor = port_mlp.mlp_apply(port_donor, torch.from_numpy(x)).numpy()
        p_wide = port_mlp.mlp_apply(port_wide, torch.from_numpy(x)).numpy()
    scale = np.abs(j_donor).max()
    np.testing.assert_allclose(p_donor, j_donor, rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(j_wide, j_donor, rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(p_wide, p_donor, rtol=0, atol=1e-6 * scale)
    # the new units are live (nonzero incoming weights) and feed nothing
    assert np.abs(np.asarray(port_wide[1][0][:, 288:])).max() > 0
    assert not np.asarray(port_wide[2][0][288:, :288]).any()
    assert not np.asarray(jax_wide[-1][0][288:]).any()
