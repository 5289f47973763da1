"""Flow-field figures (port of nsfnet_tpu/utils/visualization.py; parity
with the KAN notebook's streamplot cell, physics_informed_kan.ipynb cell 1,
and the cavity.png artifact).

matplotlib is imported inside each function (Agg backend): the package
imports without it. Each function computes its grids in `*_grid` helpers,
which the tests compare with the JAX package's, and writes one PNG.
"""

from __future__ import annotations

import numpy as np
import torch


def _agg_pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def velocity_grid(solver, n: int = 100):
    """(X, Y, U, V): the predicted velocity on an n x n grid of the unit square."""
    g = np.linspace(0.0, 1.0, n)
    X, Y = np.meshgrid(g, g)
    u, v, _, _ = solver.neural_net_u(X.ravel(), Y.ravel())
    return X, Y, _np(u).reshape(n, n), _np(v).reshape(n, n)


def streamplot_cavity(solver, n: int = 100, out_path: str = "cavity.png",
                      title: str = "Velocity field"):
    """Predict (u, v) on an n x n grid and save a streamline plot."""
    plt = _agg_pyplot()
    X, Y, U, V = velocity_grid(solver, n)
    fig, ax = plt.subplots(figsize=(8, 8))
    speed = np.sqrt(U**2 + V**2)
    strm = ax.streamplot(X, Y, U, V, density=[0.5, 1], color=speed, cmap="viridis")
    fig.colorbar(strm.lines, ax=ax, label="|u|")
    ax.set_title(title)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_aspect("equal")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def psi_grid(solver, n: int = 201):
    """(X, Y, P): the net's own psi on an n x n grid, gauge-centred (mean 0)."""
    if getattr(solver, "formulation", "velocity") != "streamfunction":
        raise ValueError("psi_contours requires a streamfunction solver "
                         "(the velocity formulation has no psi output)")
    g = np.linspace(0.0, 1.0, n)
    X, Y = np.meshgrid(g, g)
    pts = torch.as_tensor(np.stack([X.ravel(), Y.ravel()], axis=1),
                          dtype=torch.float32).to(solver.device)
    with torch.no_grad():
        psi = _np(solver.net(pts)[:, 0])
    P = psi.reshape(n, n) - psi.reshape(n, n).mean()
    return X, Y, P


def psi_contours(solver, n: int = 201, out_path: str = "psi.png",
                 title: str = "Streamfunction"):
    """Iso-contours of the net's own psi output: for a streamfunction solver
    these are the exact streamlines of the predicted flow (no integration of
    (u, v) as in streamplot_cavity), the weak corner eddies included."""
    X, Y, P = psi_grid(solver, n)
    plt = _agg_pyplot()
    fig, ax = plt.subplots(figsize=(8, 8))
    # log-spaced levels resolve the weak corner eddies (psi spans ~4 orders
    # of magnitude between the primary vortex and the corners)
    amax = np.abs(P).max() or 1.0
    levels = np.concatenate([-amax * np.logspace(-4, 0, 12)[::-1],
                             amax * np.logspace(-4, 0, 12)])
    cs = ax.contour(X, Y, P, levels=np.sort(levels), linewidths=0.8, cmap="RdBu_r")
    fig.colorbar(cs, ax=ax, label="psi (gauge-centered)")
    ax.set_title(title)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_aspect("equal")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def kan_edge_functions(kan, params, n_pts: int = 101):
    """(x [n], [(phi [n, in, out], mean |phi| [in, out]) per layer]): each
    learned KAN edge function phi_ij = w_base silu(x) + w_sp spline(x) on
    the grid range."""
    from nsfnet_tpu_torch.models.kan import GRID_RANGE, bspline_basis

    lo, hi = GRID_RANGE
    x = torch.linspace(lo, hi, n_pts, dtype=torch.float32)
    basis = _np(bspline_basis(x, kan.grid, kan.k))  # [n, B]
    xs = _np(x)
    silu = xs / (1 + np.exp(-xs))
    layers = []
    for coef, w_base, w_sp in params:
        spline = np.einsum("nb,iob->nio", basis, _np(coef))
        phi = _np(w_base)[None] * silu[:, None, None] + _np(w_sp)[None] * spline
        layers.append((phi, np.abs(phi).mean(axis=0)))
    return xs, layers


def kan_plot(kan, params, out_path: str = "kan_splines.png", n_pts: int = 101):
    """Each learned KAN edge function phi_ij (parity with pykan's
    model.plot, physics_informed_kan.ipynb cell 3): one row per layer; each
    panel overlays the edge functions feeding one output unit, shaded by
    their relative magnitude."""
    plt = _agg_pyplot()
    x, layers = kan_edge_functions(kan, params, n_pts)
    max_out = max(phi.shape[2] for phi, _ in layers)
    fig, axes = plt.subplots(len(layers), max_out,
                             figsize=(2.2 * max_out, 2.2 * len(layers)), squeeze=False)
    for li, (phi, mag) in enumerate(layers):
        fan_in, fan_out = mag.shape
        for j in range(max_out):
            ax = axes[li][j]
            if j >= fan_out:
                ax.axis("off")
                continue
            scale = mag[:, j].max() or 1.0
            for i in range(fan_in):
                ax.plot(x, phi[:, i, j], alpha=float(np.clip(mag[i, j] / scale, 0.15, 1.0)))
            ax.set_title(f"L{li} -> out {j}", fontsize=7)
            ax.tick_params(labelsize=6)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def field_grids(solver, n: int = 257):
    """(u, v, p, e) on an n x n grid of the unit square, each [n, n]."""
    g = np.linspace(0.0, 1.0, n)
    X, Y = np.meshgrid(g, g)
    return tuple(_np(q).reshape(n, n) for q in solver.neural_net_u(X.ravel(), Y.ravel()))


def field_heatmaps(solver, n: int = 257, out_path: str = "fields.png"):
    """u / v / p / e heatmaps on an n x n grid (the .mat fields, visualized)."""
    plt = _agg_pyplot()
    fields = field_grids(solver, n)
    fig, axes = plt.subplots(2, 2, figsize=(11, 10))
    for ax, name, q in zip(axes.flat, ("u", "v", "p", "e (EVM)"), fields):
        im = ax.imshow(q, origin="lower", extent=(0, 1, 0, 1), cmap="RdBu_r")
        fig.colorbar(im, ax=ax)
        ax.set_title(name)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def centerline_grids(solver, eval_fields=None, n: int = 257):
    """(mid, g, u(mid, g), v(g, mid)): the predicted u along the vertical
    centerline and v along the horizontal one, in the data's own frame
    (inferred from the DNS grid where given: [-1, 1] under
    training.coordinate_transform, where the centerlines sit at 0)."""
    if eval_fields is not None:
        x_all = np.asarray(eval_fields[0]).ravel()
        lo, hi = float(x_all.min()), float(x_all.max())
    else:
        lo, hi = 0.0, 1.0
    mid = 0.5 * (lo + hi)
    g = np.linspace(lo, hi, n)
    half = np.full(n, mid)
    u_c = _np(solver.neural_net_u(half, g)[0]).ravel()  # u(mid, y)
    v_c = _np(solver.neural_net_u(g, half)[1]).ravel()  # v(x, mid)
    return mid, g, u_c, v_c


def centerline_profiles(solver, eval_fields=None, out_path: str = "profiles.png",
                        title: str = "Centerline profiles"):
    """The classic lid-driven-cavity validation figure: u along the vertical
    centerline and v along the horizontal one, over the DNS reference when
    `eval_fields` (x, y, u, v, p columns from CavityData.evaluate_data) is
    given. The reference validates against the full-field L2 error only
    (ev-NSFnet/pinn_solver.py:669-693)."""
    plt = _agg_pyplot()
    mid, g, u_c, v_c = centerline_grids(solver, eval_fields)
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4.5))
    ax1.plot(u_c, g, "-", lw=2, label="prediction")
    ax2.plot(g, v_c, "-", lw=2, label="prediction")
    if eval_fields is not None:
        x, y, u, v, _ = (np.asarray(a).ravel() for a in eval_fields)
        # the grid lines nearest the centerlines (an even-sized grid has none on them)
        ux, uy = np.unique(x), np.unique(y)
        on_v = x == ux[np.argmin(np.abs(ux - mid))]
        on_h = y == uy[np.argmin(np.abs(uy - mid))]
        if on_v.any():
            o = np.argsort(y[on_v])
            ax1.plot(u[on_v][o], y[on_v][o], "k.", ms=3, label="DNS")
        if on_h.any():
            o = np.argsort(x[on_h])
            ax2.plot(x[on_h][o], v[on_h][o], "k.", ms=3, label="DNS")
    ax1.set_xlabel(f"u({mid:g}, y)")
    ax1.set_ylabel("y")
    ax2.set_xlabel("x")
    ax2.set_ylabel(f"v(x, {mid:g})")
    for ax in (ax1, ax2):
        ax.grid(alpha=0.3)
        ax.legend()
    fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
