"""Matrix-free Levenberg-Marquardt (Gauss-Newton-CG) for the PINN loss
(port of nsfnet_tpu/training/lm.py).

The training loss is a sum of squares (training/step.make_residual_fn), so
near a minimum the Gauss-Newton curvature J^T J is a good Hessian model,
and the damped accept test stays robust where fp32 no longer resolves loss
differences across a 10^5-point sum (where a Wolfe line search stalls).

Nothing is materialised: CG on the damped normal equations
(J^T J + lam I) delta = -J^T r needs only the products J v and J^T u.
`torch.func.jvp` gives J v and `torch.func.vjp` gives J^T u, over a
function of the flat parameter vector. The full-batch variant keeps one
vjp per LM step and reuses it across the CG iterations (the counterpart of
the JAX package's stored linearization); each J v is a fresh jvp. The
microbatched variant builds a new jvp and vjp for each collocation slice
inside every Gauss-Newton product, so its peak memory is about a slice's.

Kept exactly as in the JAX package: cg_iters CG iterations with no early
exit, the 1e-30 guards, the damping /3 on accept and x8 on reject clamped
to [1e-12, 1e8], the accept test loss_try < loss0, and the history entry
where(accept, loss_try, loss0). Inside a chunk nothing is read back to the
host.

The residual is the caller's: the solver hands in the closed form in exact
fp32 (the kernel wrappers have no forward-mode derivative), the EVM carry
frozen.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Sequence, Tuple

import torch
from torch.func import jvp, vjp

from nsfnet_tpu_torch.training.lbfgs import chunking

Progress = Optional[Callable[[int, float, float], None]]


def _cg(Av: Callable, g: torch.Tensor, cg_iters: int) -> torch.Tensor:
    """cg_iters CG iterations on A x = -g from x = 0, no early exit."""
    x, rr, p = torch.zeros_like(g), -g, -g
    rs = g @ g
    for _ in range(cg_iters):
        Ap = Av(p)
        a = rs / (p @ Ap + 1e-30)
        x = x + a * p
        rr = rr - a * Ap
        rs2 = rr @ rr
        p = rr + (rs2 / (rs + 1e-30)) * p
        rs = rs2
    return x


def _accept(w, lam, delta, loss0, loss_of):
    """The damped trial step: (w, lam, history entry)."""
    w_try = w + delta
    loss_try = loss_of(w_try)
    accept = loss_try < loss0
    w = torch.where(accept, w_try, w)
    lam = torch.where(accept, torch.clamp(lam / 3.0, min=1e-12),
                      torch.clamp(lam * 8.0, max=1e8))
    return w, lam, torch.where(accept, loss_try, loss0)


def _sum_sq(r: torch.Tensor) -> torch.Tensor:
    return r @ r


def _joint(reduce, g: torch.Tensor, s: torch.Tensor):
    """(g, s) summed over the ranks by `reduce` in one collective."""
    if reduce is None:
        return g, s
    out = reduce(torch.cat([g, s.reshape(1)]))
    return out[:-1], out[-1]


def _summed(reduce, t: torch.Tensor) -> torch.Tensor:
    return t if reduce is None else reduce(t)


def run_lm(residual_fn: Callable[[torch.Tensor], torch.Tensor], params: torch.Tensor,
           n_steps: int, cg_iters: int = 50, init_lam: float = 1e-3, max_chunk: int = 10,
           progress: Progress = None,
           guard: Callable = contextlib.nullcontext,
           reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
           ) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """Minimize sum(residual_fn(w)**2) over the flat vector w with damped
    Gauss-Newton; n_steps rounded up to whole chunks of max_chunk steps,
    `progress(steps_done, last_loss, lam)` after each and `guard()` entered
    around each. Returns (w, loss history, final lam).

    `reduce(t)` sums t over the ranks of a process group: each rank's
    residual_fn gives its block of the rows, and the Gauss-Newton products
    J^T (J v), J^T r and the losses are sums over rows, so each is reduced
    (J^T r with the loss in one collective). Every rank then takes the same
    CG iterates and the same accept decision."""

    def lm_step(w, lam):
        r, vjp_fn = vjp(residual_fn, w)
        g, loss0 = _joint(reduce, vjp_fn(r)[0], r @ r)  # J^T r = grad / 2

        def Av(v):
            return _summed(reduce, vjp_fn(jvp(residual_fn, (w,), (v,))[1])[0]) + lam * v

        delta = _cg(Av, g, cg_iters)
        with torch.no_grad():
            return _accept(w, lam, delta, loss0,
                           lambda wt: _summed(reduce, _sum_sq(residual_fn(wt))))

    return _run_chunks(lm_step, params, n_steps, init_lam, max_chunk, progress, guard)


def run_lm_micro(eq_residual_fn: Callable, aux_residual_fn: Callable[[torch.Tensor], torch.Tensor],
                 eq_slices: Sequence, params: torch.Tensor, n_steps: int, cg_iters: int = 50,
                 init_lam: float = 1e-3, max_chunk: int = 10, progress: Progress = None,
                 guard: Callable = contextlib.nullcontext,
                 reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """run_lm's math with every Gauss-Newton product (J^T J v, J^T r,
    sum r^2) summed over the collocation slices `eq_slices`, the
    linearization rebuilt for each slice, so the peak activation memory is
    about one slice's at the cost of one more residual forward per slice and
    CG iteration. `eq_residual_fn(w, slice)` gives a slice's rows (scaled by
    the GLOBAL counts, so the slices together are the full vector's
    equation rows); `aux_residual_fn(w)` the boundary and supervised rows.
    `reduce` as in run_lm: the slices and aux rows are this rank's."""

    def local_loss(w):
        acc = torch.zeros((), dtype=w.dtype, device=w.device)
        for sl in eq_slices:
            acc = acc + _sum_sq(eq_residual_fn(w, sl))
        return acc + _sum_sq(aux_residual_fn(w))

    def per_slice(w, fn):
        """The sum over slices of fn(f, r, vjp_fn) for each slice's residual f."""
        acc = torch.zeros_like(w)
        for sl in eq_slices:
            f = lambda w_, sl=sl: eq_residual_fn(w_, sl)
            r, vjp_fn = vjp(f, w)
            acc = acc + fn(f, r, vjp_fn)
        return acc

    def lm_step(w, lam):
        with torch.no_grad():
            loss0 = local_loss(w)
        ra, vjp_a = vjp(aux_residual_fn, w)
        g = per_slice(w, lambda f, r, vjp_fn: vjp_fn(r)[0]) + vjp_a(ra)[0]
        g, loss0 = _joint(reduce, g, loss0)

        def Av(v):
            av = per_slice(w, lambda f, r, vjp_fn: vjp_fn(jvp(f, (w,), (v,))[1])[0])
            return _summed(reduce, av + vjp_a(jvp(aux_residual_fn, (w,), (v,))[1])[0]) + lam * v

        delta = _cg(Av, g, cg_iters)
        with torch.no_grad():
            return _accept(w, lam, delta, loss0, lambda wt: _summed(reduce, local_loss(wt)))

    return _run_chunks(lm_step, params, n_steps, init_lam, max_chunk, progress, guard)


def _run_chunks(lm_step, params, n_steps, init_lam, max_chunk, progress, guard):
    chunk, n_chunks = chunking(n_steps, max_chunk)
    w = params.detach().clone()
    lam = torch.tensor(init_lam, dtype=w.dtype, device=w.device)
    hists = []
    for i in range(n_chunks):
        with guard():
            hist = []
            for _ in range(chunk):
                w, lam, h = lm_step(w, lam)
                hist.append(h)
            hists.append(torch.stack(hist))
        if progress is not None:
            progress((i + 1) * chunk, hists[-1][-1].item(), lam.item())
    return w, torch.cat(hists), lam.item()


def stack_slices(columns: Sequence[torch.Tensor], k: int) -> List[Tuple[torch.Tensor, ...]]:
    """Cut [N, 1] columns into k slices of ceil(N / k) rows, the last ones
    zero-padded (nsfnet_tpu/training/solver.py:889-917): a zero eq_w row is
    a zero residual row."""
    n = columns[0].shape[0]
    m = -(-n // k)
    pad = k * m - n
    cols = [torch.cat([c, c.new_zeros((pad, c.shape[1]))]) if pad else c for c in columns]
    return [tuple(c[i * m:(i + 1) * m] for c in cols) for i in range(k)]
