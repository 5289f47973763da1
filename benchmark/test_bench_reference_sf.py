"""The streamfunction reference's own arithmetic: its autograd derivatives of
(psi, p) against a closed form up to psi's third derivatives, and its loss
terms, which leave out continuity."""

import pytest
import torch

from benchmark import run
from benchmark.reference import ev_nsfnet_sf as ref


def _closed_form(x, y, a, b):
    """psi = sin(a x) cos(b y), p = x^2 y + 3 y^2 - x."""
    sx, cx, sy, cy = torch.sin(a * x), torch.cos(a * x), torch.sin(b * y), torch.cos(b * y)
    return ref.PsiDerivs(
        psi_x=a * cx * cy, psi_y=-b * sx * sy,
        psi_xx=-a**2 * sx * cy, psi_xy=-a * b * cx * sy, psi_yy=-b**2 * sx * cy,
        psi_xxx=-a**3 * cx * cy, psi_xxy=a**2 * b * sx * sy,
        psi_xyy=-a * b**2 * cx * cy, psi_yyy=b**3 * sx * sy,
        p_x=2 * x * y - 1, p_y=x * x + 6 * y)


@pytest.mark.parametrize("a,b", [(1.3, 2.1), (3.0, 0.5)])
def test_derivatives_against_a_closed_form(a, b):
    g = torch.Generator().manual_seed(2**31 + 29)
    xy = torch.rand((512, 2), generator=g, dtype=torch.float32).requires_grad_(True)
    x, y = xy[:, 0:1], xy[:, 1:2]
    out = torch.cat([torch.sin(a * x) * torch.cos(b * y), x * x * y + 3 * y * y - x], dim=1)
    got = ref.psi_derivatives(out, xy)
    want = _closed_form(x.detach().double(), y.detach().double(), a, b)
    for name, mine, exact in zip(ref.PsiDerivs._fields, got, want):
        assert mine.dtype == torch.float32 and mine.shape == (512, 1), name
        # float32 tolerance: a few float32 roundings of the largest value of
        # each derivative (up to 27 at the third order); the closed form is float64
        scale = max(1.0, float(exact.abs().max()))
        err = float((mine.detach().double() - exact).abs().max())
        assert err <= 1e-5 * scale, (name, err, scale)
    # built with create_graph: the loss's gradient reaches the weights through them
    assert got.psi_xxy.requires_grad and got.psi_yyy.requires_grad and got.p_x.requires_grad


def test_the_terms_leave_out_continuity():
    assert ref.TERMS == ("total", "boundary", "eq1", "eq2", "eq4")
    config = run.load_config("ev-nsfnet-sf-re2000-6x80")
    assert config["app_config"]["network"]["formulation"] == "streamfunction"
    assert run.reference_of(config) is ref
