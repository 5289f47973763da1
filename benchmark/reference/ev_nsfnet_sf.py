"""Plain reference of the streamfunction-pressure ev-NSFnet training steps, in
float32 with TF32 off, every derivative by nested torch.autograd.grad.

The form (Raissi, Perdikaris & Karniadakis, J. Comput. Phys. 378 (2019)
686-707, section 4.1.1): the main net maps (x, y) to (psi, p), and
u = psi_y, v = -psi_x, so continuity holds exactly and the momentum
residuals need psi's derivatives up to the third:
  * eq1 = u u_x + v u_y + p_x - nu (u_xx + u_yy)
        = psi_y psi_xy - psi_x psi_yy + p_x - nu (psi_xxy + psi_yyy),
    eq2 = u v_x + v v_y + p_y - nu (v_xx + v_yy)
        = -psi_y psi_xx + psi_x psi_xy + p_y + nu (psi_xxx + psi_xyy).
Its departures from that form, each taken from ev-NSFnet
(ev-NSFnet/pinn_solver.py:301-480), as `ev_nsfnet.py` has them:
  * the steady forward problem of the lid-driven cavity: no time derivative,
    and the coefficients are known (1 on the convection, nu on the
    diffusion), where Raissi's section identifies two unknown ones;
  * nu = 1/Re + vis_t, the lagged vis_t = min(20/Re, alpha_evm |e|) of the
    EVM net (x, y) -> e, a second tanh MLP with a linear head;
  * the entropy residual eq4 = (u - 1/2) eq1 + (v - 1/2) eq2 - e;
  * the loss: bc_weight (mean (u - u_b)^2 + mean (v - v_b)^2) on the
    boundary, u and v from psi's first derivatives, + eq_weight (l1 + l2 +
    0.1 l4), l_i = sum(w eq_i^2) / N_f with the SDF weights w; Raissi sums
    squared errors on interior data of u and v instead of boundary values,
    and has no eq4 and no weights;
  * no continuity term: it is 0 by construction (the port's eq3 reads 0);
  * the main net's widths are ev-NSFnet's (6 x 80), not Raissi's (8 x 20);
  * no coordinate transform: the configuration runs on the unit square.

`adam_steps`: full-batch Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected)
on the main net, `ev_nsfnet.adam_steps`' signature and returns; the EVM net
trains only at stage steps k * evm_update_freq, k >= 1, so it is frozen
over the steps compared, and e enters the main net's gradient as a
constant. The collocation rows run in blocks whose sums and gradients add
up to the full batch's. `mm` replaces the float32 product, and `tf32` lets
cuBLAS use TF32: the controls pass a lower precision.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import torch

from benchmark.reference import ev_nsfnet as velocity

ENTROPY_WEIGHT = velocity.ENTROPY_WEIGHT
# the loss terms `adam_steps` returns a step, in order: the names of the
# solver's step metrics that the driver reads beside them (eq3 is 0 here)
TERMS = ("total", "boundary", "eq1", "eq2", "eq4")


class PsiDerivs(NamedTuple):
    """psi's derivatives up to the third and p's first, each [N, 1]."""

    psi_x: torch.Tensor
    psi_y: torch.Tensor
    psi_xx: torch.Tensor
    psi_xy: torch.Tensor
    psi_yy: torch.Tensor
    psi_xxx: torch.Tensor
    psi_xxy: torch.Tensor
    psi_xyy: torch.Tensor
    psi_yyy: torch.Tensor
    p_x: torch.Tensor
    p_y: torch.Tensor


def psi_derivatives(out: torch.Tensor, xy: torch.Tensor) -> PsiDerivs:
    """The derivatives of out = (psi, p), [N, 2], computed from xy [N, 2]
    (which requires grad), each by torch.autograd.grad with create_graph, so
    that a gradient of what is built from them reaches the weights."""

    def grad(f):
        return torch.autograd.grad(f.sum(), xy, create_graph=True)[0]

    d_psi, d_p = grad(out[:, 0:1]), grad(out[:, 1:2])
    psi_x, psi_y = d_psi[:, 0:1], d_psi[:, 1:2]
    d_psi_x, d_psi_y = grad(psi_x), grad(psi_y)
    psi_xx, psi_xy, psi_yy = d_psi_x[:, 0:1], d_psi_x[:, 1:2], d_psi_y[:, 1:2]
    d_psi_xx, d_psi_yy = grad(psi_xx), grad(psi_yy)
    return PsiDerivs(psi_x, psi_y, psi_xx, psi_xy, psi_yy,
                     d_psi_xx[:, 0:1], d_psi_xx[:, 1:2], d_psi_yy[:, 0:1], d_psi_yy[:, 1:2],
                     d_p[:, 0:1], d_p[:, 1:2])


def _eq_sums(params, xy, w, vis_t, e, re, mm):
    """[3] sums of w * eq_i^2 over these rows, i = 1, 2, 4; xy requires grad."""
    d = psi_derivatives(velocity.mlp(params, xy, mm), xy)
    u, v = d.psi_y, -d.psi_x
    nu = 1.0 / re + vis_t
    eq1 = u * d.psi_xy + v * d.psi_yy + d.p_x - nu * (d.psi_xxy + d.psi_yyy)
    eq2 = -u * d.psi_xx - v * d.psi_xy + d.p_y + nu * (d.psi_xxx + d.psi_xyy)
    eq4 = eq1 * (u - 0.5) + eq2 * (v - 0.5) - e
    return torch.stack([torch.sum(w * q * q) for q in (eq1, eq2, eq4)])


def boundary_uv(params, xy: torch.Tensor, mm: Callable) -> tuple:
    """(u, v) = (psi_y, -psi_x) on the rows xy, differentiable wrt the weights."""
    xy = xy.detach().requires_grad_(True)
    psi = velocity.mlp(params, xy, mm)[:, 0:1]
    d_psi = torch.autograd.grad(psi.sum(), xy, create_graph=True)[0]
    return d_psi[:, 1:2], -d_psi[:, 0:1]


def _accumulate(grads: list, loss: torch.Tensor, leaves: list) -> None:
    """grads += d loss / d leaves. The head's bias reaches no derivative,
    so its gradient is 0 (autograd gives None for it)."""
    for acc, g in zip(grads, torch.autograd.grad(loss, leaves, allow_unused=True)):
        if g is not None:
            acc += g


def loss_and_grad(main: list, evm: list, inputs, app: dict, vis_t, block: int, mm: Callable):
    """(the loss terms [total, boundary, l1, l2, l4] as floats, the gradient
    of the total wrt the main net's leaves `main`); e is a constant."""
    phys = app["physics"]
    re, bc_w, eq_w = float(phys["Re"]), float(phys["bc_weight"]), float(phys["eq_weight"])
    x_f, y_f, w_f = inputs.x_f, inputs.y_f, inputs.w_f
    n_f = x_f.shape[0]
    pairs, evm_pairs = velocity._pairs(main), velocity._pairs(evm)
    grads = [torch.zeros_like(t) for t in main]
    sums = torch.zeros(3, dtype=torch.float32, device=x_f.device)
    for s in range(0, n_f, block):
        sl = slice(s, min(s + block, n_f))
        xy = torch.cat([x_f[sl], y_f[sl]], dim=1).requires_grad_(True)
        e = velocity.mlp(evm_pairs, xy.detach(), mm)[:, 0:1]
        part = _eq_sums(pairs, xy, w_f[sl], vis_t[sl], e, re, mm)
        loss = eq_w * (part[0] + part[1] + ENTROPY_WEIGHT * part[2]) / n_f
        _accumulate(grads, loss, main)
        sums += part.detach()
    u, v = boundary_uv(pairs, torch.cat([inputs.x_b, inputs.y_b], dim=1), mm)
    loss_b = torch.mean((u - inputs.u_b) ** 2) + torch.mean((v - inputs.v_b) ** 2)
    _accumulate(grads, bc_w * loss_b, main)
    l = sums / n_f
    total = bc_w * loss_b.detach() + eq_w * (l[0] + l[1] + ENTROPY_WEIGHT * l[2])
    return [float(total), float(loss_b.detach())] + l.tolist(), grads


def adam_steps(inputs, app: dict, lr: float, n_steps: int, block: int = 20000,
               mm: Optional[Callable] = None, tf32: bool = False) -> dict:
    """`n_steps` Adam steps from the inputs' weights. Returns each step's loss
    terms (TERMS: total, boundary, l1, l2, l4; at the weights the step starts
    from; the boundary term before its weight), the first step's gradient,
    the main net's weights after the last step (`params`) and the EVM net's
    (`params_evm`), as lists of leaves in the order W0, b0, W1, b1, ..."""
    mm = mm or torch.matmul
    leaves = [t.detach().clone().requires_grad_(True) for pair in inputs.params for t in pair]
    evm = [t.detach() for pair in inputs.params_evm for t in pair]
    mu = [torch.zeros_like(t) for t in leaves]
    nu2 = [torch.zeros_like(t) for t in leaves]
    losses: List[List[float]] = []
    first_grad = None
    with velocity.exact_fp32(tf32):
        # the EVM net is frozen, so the carry it gives is the same each step
        vis_t = velocity._vis_t(evm, inputs, app, mm)
        for step in range(1, n_steps + 1):
            terms, grads = loss_and_grad(leaves, evm, inputs, app, vis_t, block, mm)
            losses.append(terms)
            if first_grad is None:
                first_grad = [g.clone() for g in grads]
            with torch.no_grad():
                for p, g, m, v in zip(leaves, grads, mu, nu2):
                    m.mul_(velocity.ADAM_B1).add_(g, alpha=1.0 - velocity.ADAM_B1)
                    v.mul_(velocity.ADAM_B2).addcmul_(g, g, value=1.0 - velocity.ADAM_B2)
                    m_hat = m / (1.0 - velocity.ADAM_B1 ** step)
                    v_hat = v / (1.0 - velocity.ADAM_B2 ** step)
                    p.sub_(lr * (m_hat / (v_hat.sqrt() + velocity.ADAM_EPS)))
    return {"losses": losses, "first_grad": first_grad,
            "params": [t.detach() for t in leaves], "params_evm": evm}
