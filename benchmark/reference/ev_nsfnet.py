"""Plain reference of the ev-NSFnet training steps, in float32 with TF32 off,
derivatives by torch.autograd.

The loss (ev-NSFnet/pinn_solver.py:301-480, the ev-NSFnet paper's):
  * main net (x, y) -> (u, v, p), tanh MLP with a linear head; EVM net
    (x, y) -> e, the same kind of net;
  * nu = 1/Re + vis_t, with the lagged vis_t = min(20/Re, alpha_evm |e|) of
    the previous step (at the first step, of the starting EVM net);
    eq1 = u u_x + v u_y + p_x - nu (u_xx + u_yy), eq2 likewise for v,
    eq3 = u_x + v_y, eq4 = (u - 1/2) eq1 + (v - 1/2) eq2 - e;
  * loss = bc_weight (mean (u - u_b)^2 + mean (v - v_b)^2)
    + eq_weight (l1 + l2 + l3 + 0.1 l4), l_i = sum(w eq_i^2) / N_f.

`adam_steps`: full-batch Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected)
on the main net; the EVM net trains only at stage steps k * evm_update_freq,
k >= 1, so it is frozen over the steps compared here, and e enters the main
net's gradient as a constant. `lbfgs_steps`: a polish stage of L-BFGS
(reference/lbfgs.py) on both nets, the vis_t carry frozen at the stage's
start.

The collocation rows run in blocks, whose sums and gradients add up to the
full batch's, so that the reference fits beside what the run leaves in
memory. `mm` replaces the float32 product, and `tf32` lets cuBLAS use TF32:
the controls pass a lower precision.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional

import torch

from benchmark.reference import lbfgs as lbfgs_ref

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
ENTROPY_WEIGHT = 0.1
# the loss terms `adam_steps` returns a step, in order: the names of the
# solver's step metrics that the driver reads beside them
TERMS = ("total", "boundary", "eq1", "eq2", "eq3", "eq4")


@contextlib.contextmanager
def exact_fp32(tf32: bool = False):
    """Float32 products on the CUDA cores (TF32 off) while the reference runs;
    `tf32` turns TF32 on instead."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def mlp(params, x: torch.Tensor, mm: Callable = torch.matmul) -> torch.Tensor:
    h = x
    for w, b in params[:-1]:
        h = torch.tanh(mm(h, w) + b)
    w, b = params[-1]
    return mm(h, w) + b


def _pairs(leaves):
    return [(leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2)]


def _eq_sums(params, xy, w, vis_t, e, re, mm):
    """[4] sums of w * eq_i^2 over these rows; xy requires grad."""
    out = mlp(params, xy, mm)
    u, v = out[:, 0:1], out[:, 1:2]
    grad = lambda f: torch.autograd.grad(f.sum(), xy, create_graph=True)[0]
    du, dv, dp = grad(u), grad(v), grad(out[:, 2:3])
    u_x, u_y, v_x, v_y = du[:, 0:1], du[:, 1:2], dv[:, 0:1], dv[:, 1:2]
    u_xx, u_yy = grad(u_x)[:, 0:1], grad(u_y)[:, 1:2]
    v_xx, v_yy = grad(v_x)[:, 0:1], grad(v_y)[:, 1:2]
    nu = 1.0 / re + vis_t
    eq1 = u * u_x + v * u_y + dp[:, 0:1] - nu * (u_xx + u_yy)
    eq2 = u * v_x + v * v_y + dp[:, 1:2] - nu * (v_xx + v_yy)
    eq3 = u_x + v_y
    eq4 = eq1 * (u - 0.5) + eq2 * (v - 0.5) - e
    return torch.stack([torch.sum(w * q * q) for q in (eq1, eq2, eq3, eq4)])


def loss_and_grad(main: list, evm: list, wrt: list, inputs, app: dict, vis_t, block: int,
                  mm: Callable):
    """(the loss terms [total, boundary, l1, l2, l3, l4] as floats, the
    gradient of the total wrt the leaves `wrt`); where `wrt` holds the EVM
    net's leaves they get its gradient, else e is a constant."""
    phys = app["physics"]
    re, bc_w, eq_w = float(phys["Re"]), float(phys["bc_weight"]), float(phys["eq_weight"])
    x_f, y_f, w_f = inputs.x_f, inputs.y_f, inputs.w_f
    n_f = x_f.shape[0]
    grads = [torch.zeros_like(t) for t in wrt]
    sums = torch.zeros(4, dtype=torch.float32, device=x_f.device)
    for s in range(0, n_f, block):
        sl = slice(s, min(s + block, n_f))
        xy = torch.cat([x_f[sl], y_f[sl]], dim=1).requires_grad_(True)
        e = mlp(_pairs(evm), xy.detach(), mm)[:, 0:1]
        part = _eq_sums(_pairs(main), xy, w_f[sl], vis_t[sl], e, re, mm)
        loss = eq_w * (part[0] + part[1] + part[2] + ENTROPY_WEIGHT * part[3]) / n_f
        for acc, g in zip(grads, torch.autograd.grad(loss, wrt, allow_unused=True)):
            if g is not None:
                acc += g
        sums += part.detach()
    uvp = mlp(_pairs(main), torch.cat([inputs.x_b, inputs.y_b], dim=1), mm)
    loss_b = (torch.mean((uvp[:, 0:1] - inputs.u_b) ** 2)
              + torch.mean((uvp[:, 1:2] - inputs.v_b) ** 2))
    for acc, g in zip(grads, torch.autograd.grad(bc_w * loss_b, wrt, allow_unused=True)):
        if g is not None:
            acc += g
    l = sums / n_f
    total = bc_w * loss_b.detach() + eq_w * (l[0] + l[1] + l[2] + ENTROPY_WEIGHT * l[3])
    return [float(total), float(loss_b.detach())] + l.tolist(), grads


def _vis_t(evm: list, inputs, app: dict, mm: Callable) -> torch.Tensor:
    """min(20/Re, alpha_evm |e|) of the EVM net on the collocation points."""
    with torch.no_grad():
        e = mlp(_pairs(evm), torch.cat([inputs.x_f, inputs.y_f], dim=1), mm)[:, 0:1]
    phys = app["physics"]
    return torch.clamp(float(phys["alpha_evm"]) * e.abs(), max=20.0 / float(phys["Re"]))


def adam_steps(inputs, app: dict, lr: float, n_steps: int, block: int = 20000,
               mm: Optional[Callable] = None, tf32: bool = False) -> dict:
    """`n_steps` Adam steps from the inputs' weights. Returns each step's loss
    terms (TERMS: total, boundary, l1, l2, l3, l4; at the weights the step starts
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
    with exact_fp32(tf32):
        # the EVM net is frozen, so the carry it gives is the same each step
        vis_t = _vis_t(evm, inputs, app, mm)
        for step in range(1, n_steps + 1):
            terms, grads = loss_and_grad(leaves, evm, leaves, inputs, app, vis_t, block, mm)
            losses.append(terms)
            if first_grad is None:
                first_grad = [g.clone() for g in grads]
            with torch.no_grad():
                for p, g, m, v in zip(leaves, grads, mu, nu2):
                    m.mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
                    v.mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
                    m_hat = m / (1.0 - ADAM_B1 ** step)
                    v_hat = v / (1.0 - ADAM_B2 ** step)
                    p.sub_(lr * (m_hat / (v_hat.sqrt() + ADAM_EPS)))
    return {"losses": losses, "first_grad": first_grad,
            "params": [t.detach() for t in leaves], "params_evm": evm}


def lbfgs_steps(main: list, evm: list, inputs, app: dict, n_steps: int, block: int = 20000,
                tf32: bool = False) -> dict:
    """A polish stage of `n_steps` L-BFGS steps on both nets from the leaves
    `main` and `evm`, the vis_t carry frozen at the stage's start (the EVM
    net that gives it has not trained since the first step). Returns the
    loss at the start of each step (`history`), the value-and-grad
    evaluations of each step, the gradient at the start (`first_grad`) and
    the leaves after the stage (`params`: main, then EVM)."""
    sizes = [t.numel() for t in main + evm]
    shapes = [t.shape for t in main + evm]
    n_main = len(main)

    def split(w):
        return [c.view(s) for c, s in zip(torch.split(w, sizes), shapes)]

    with exact_fp32(tf32):
        vis_t = _vis_t(evm, inputs, app, torch.matmul)

        def value_and_grad(w):
            leaves = [t.detach().requires_grad_(True) for t in split(w)]
            terms, grads = loss_and_grad(leaves[:n_main], leaves[n_main:], leaves, inputs,
                                         app, vis_t, block, torch.matmul)
            return terms[0], torch.cat([g.reshape(-1) for g in grads])

        w0 = torch.cat([t.detach().reshape(-1) for t in main + evm])
        g0 = value_and_grad(w0)[1]
        w, history, evaluations = lbfgs_ref.minimize(value_and_grad, w0, n_steps)
    return {"history": history, "evaluations": evaluations, "first_grad": split(g0),
            "params": split(w)}
