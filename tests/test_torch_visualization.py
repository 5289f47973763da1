"""PyTorch port: the figures (utils/visualization.py) on the Agg backend:
each function writes its PNG, and the grids it plots match the JAX
package's (nsfnet_tpu/utils/visualization.py) from the same weights within
1e-5 (fp32 on both sides, each summing in its own order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsfnet_tpu.models.kan import bspline_basis as jax_bspline_basis
from nsfnet_tpu.training.solver import PINNSolver as JaxSolver
from nsfnet_tpu.utils import visualization as jax_vis
from nsfnet_tpu_torch.models.convert import kan_params_from_numpy, params_from_numpy
from nsfnet_tpu_torch.training.solver import PINNSolver
from nsfnet_tpu_torch.utils import visualization as vis

torch.set_num_threads(2)

ARCH = dict(Re=100, layers=2, layers_1=2, hidden_size=12, hidden_size_1=8, N_f=64, seed=2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(tmp_path, **kw):
    js = JaxSolver(**ARCH, **kw, mesh_devices=1, checkpoint_path=str(tmp_path))
    ps = PINNSolver(**ARCH, **kw, device="cpu")
    ps.set_params(params_from_numpy(jax.device_get(js.state.params)),
                  params_from_numpy(jax.device_get(js.state.params_evm)))
    return js, ps


def _jax_grid(js, xs, ys):
    return [np.asarray(a).ravel() for a in js.neural_net_u(xs, ys)]


def test_velocity_figures(tmp_path):
    js, ps = _pair(tmp_path)
    n = 24
    X, Y, U, V = vis.velocity_grid(ps, n)
    want = _jax_grid(js, X.ravel(), Y.ravel())
    np.testing.assert_allclose(U.ravel(), want[0], **TOL)
    np.testing.assert_allclose(V.ravel(), want[1], **TOL)
    for q, w in zip(vis.field_grids(ps, n), want):
        np.testing.assert_allclose(q.ravel(), w, **TOL)
    # the centerlines in the frame of the DNS grid ([-1, 1] here)
    g = np.linspace(-1.0, 1.0, 5)
    fields = tuple(a.reshape(-1, 1) for a in (*np.meshgrid(g, g), *np.ones((3, 5, 5))))
    mid, line, u_c, v_c = vis.centerline_grids(ps, fields, n=33)
    assert mid == 0.0 and line[0] == -1.0
    np.testing.assert_allclose(u_c, _jax_grid(js, np.full(33, mid), line)[0], **TOL)
    np.testing.assert_allclose(v_c, _jax_grid(js, line, np.full(33, mid))[1], **TOL)
    for fn, kw in ((vis.streamplot_cavity, dict(n=n)), (vis.field_heatmaps, dict(n=n)),
                   (vis.centerline_profiles, dict(eval_fields=fields))):
        out = fn(ps, out_path=str(tmp_path / f"{fn.__name__}.png"), **kw)
        assert open(out, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
    with pytest.raises(ValueError, match="streamfunction"):
        vis.psi_contours(ps, out_path=str(tmp_path / "psi.png"))


def test_psi_contours(tmp_path):
    js, ps = _pair(tmp_path, formulation="streamfunction")
    X, Y, P = vis.psi_grid(ps, n=31)
    pts = jnp.asarray(np.stack([X.ravel(), Y.ravel()], 1), jnp.float32)
    psi = np.asarray(js.net.apply(js.state.params, pts)[:, 0]).reshape(31, 31)
    np.testing.assert_allclose(P, psi - psi.mean(), **TOL)
    out = vis.psi_contours(ps, n=31, out_path=str(tmp_path / "psi.png"))
    assert open(out, "rb").read(4) == b"\x89PNG"
    assert jax_vis.psi_contours(js, n=31, out_path=str(tmp_path / "psi_jax.png"))


def test_kan_plot(tmp_path):
    js = JaxSolver(Re=100, backbone="kan", layers_1=None, kan_width=(2, 3, 2), N_f=64,
                   mesh_devices=1, checkpoint_path=str(tmp_path))
    ps = PINNSolver(Re=100, backbone="kan", layers_1=None, kan_width=(2, 3, 2), N_f=64,
                    device="cpu")
    params = kan_params_from_numpy(jax.device_get(js.state.params))
    x, layers = vis.kan_edge_functions(ps.net, params, n_pts=41)
    net = js.net
    basis = np.asarray(jax_bspline_basis(jnp.linspace(*net.grid_range, 41), net.grid, net.k,
                                         net.grid_range))
    silu = x / (1 + np.exp(-x))
    for (phi, mag), (coef, w_base, w_sp) in zip(layers, jax.device_get(js.state.params)):
        want = (np.asarray(w_base)[None] * silu[:, None, None]
                + np.asarray(w_sp)[None] * np.einsum("nb,iob->nio", basis, np.asarray(coef)))
        np.testing.assert_allclose(phi, want, **TOL)
        np.testing.assert_allclose(mag, np.abs(want).mean(axis=0), **TOL)
    out = vis.kan_plot(ps.net, params, out_path=str(tmp_path / "kan.png"), n_pts=41)
    assert open(out, "rb").read(4) == b"\x89PNG"
