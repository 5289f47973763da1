"""The training step (full batch or microbatched, on one process or a
rank of a process group), the multi-step chunk runner and the
least-squares residual (port of nsfnet_tpu/training/step.py:53-268,
271-503).

One step = the reference's full-batch epoch (solve_Adam body,
ev-NSFnet/pinn_solver.py:456-480), on the device:

  * NS residuals on the collocation batch — the fused residual-loss kernel
    pair (ops/fused_residual.py), or a derivative engine (the five-stream
    kernel pair of ops/mlp_streams.py, or the plain closed-form engine)
    followed by residuals and masked sums,
  * boundary / equation losses with exact means over real points (MSE), or
    the reference v1's un-normalised norms (L2), and the supervised loss on
    sampled DNS values,
  * Adam on the main net every step,
  * Adam on the EVM net only on stage-epochs k*evm_update_freq, k >= 1
    (pinn_solver.py:452-462); frozen steps leave its params AND moments
    untouched, and its gradient is not computed,
  * the vis_t carry update;
  * under a process group, each rank's local sums (over GLOBAL counts) are
    differentiated and the gradients and loss components all-reduced in
    one collective per step (`make_grad_fn`); with `n_micro` > 1 the
    collocation rows run in slices, one graph at a time.

Nothing in a step reads a value back from the device: lr, Re and alpha_evm
are Python floats and the EVM gate counts on the host, so a chunk of steps
queues up without a host sync. The caller syncs at log boundaries.

`make_residual_fn` is the loss as a vector r with sum(r**2) equal to the
MSE total: the least-squares structure the Levenberg-Marquardt polish
(training/lm.py) works on.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from nsfnet_tpu_torch.ops import losses as L
from nsfnet_tpu_torch.ops import residuals as R
from nsfnet_tpu_torch.parallel import mesh as pmesh
from nsfnet_tpu_torch.training.state import AdamState, Batch, StepMetrics, TrainState
from nsfnet_tpu_torch.utils import profiling

Engine = Callable[..., tuple]  # (flat params, X[N,2]) -> Derivs

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.scale_by_adam defaults


class StageScalars(NamedTuple):
    """Per-stage scalars; host floats, so changing them costs nothing."""

    lr: float
    alpha_evm: float
    re: float
    alpha_b: float


def make_loss_fn(
    engine: Optional[Engine],
    apply_main: Callable,
    apply_evm: Optional[Callable],
    coord_scale: float,
    alpha_e: float,
    alpha_s: float = 0.0,
    entropy_weight: float = 0.1,
    evm: bool = True,
    fused_eq_loss: Optional[Callable] = None,
    loss_mode: str = "MSE",
):
    """Build the loss function. `fused_eq_loss(params, x, e, vis_t, eq_w,
    re)` (EVM) / `(params, x, eq_w, re)` (vanilla) returns the per-equation
    weighted sums of squares (MSE mode only); without it the equation loss
    runs `engine` -> residuals -> masked means. loss_mode 'L2' is the
    reference v1's un-normalised L2-norm loss (NSFnet/pinn_solver.py:201-218):
    norms of the residuals and of the boundary mismatch, no 1/n. The
    supervised loss (weight `alpha_s`) is an MSE in either mode, as in the
    JAX package. The parts are exposed as attributes, as the JAX package's
    are: `eq_loss_fn` and `aux_loss_fn` (the adaptive bc weight's probe
    differentiates them apart)."""
    if loss_mode not in ("MSE", "L2"):
        raise ValueError(f"unknown loss_mode {loss_mode!r}; MSE or L2")
    if loss_mode == "L2" and fused_eq_loss is not None:
        raise ValueError("fused_eq_loss is MSE-mode only")

    def eq_loss_fn(params_all, x_f, y_f, eq_w, n_f, vis_t_minus, sc: StageScalars):
        params, params_evm = params_all
        x_eq = torch.cat([x_f, y_f], dim=1)
        e = None
        if evm:
            with profiling.fine("loss.evm_net"):
                e = apply_evm(params_evm, x_eq)[:, 0:1]
        with profiling.fine("loss.equation"):
            return eq_terms(params, x_eq, e, eq_w, n_f, vis_t_minus, sc)

    def eq_terms(params, x_eq, e, eq_w, n_f, vis_t_minus, sc: StageScalars):
        """The weighted equation loss and its parts, given the EVM net's
        output `e` (None without it)."""
        re = sc.re
        vis_t0 = 20.0 / re  # ev-NSFnet/pinn_solver.py:67
        zero = x_eq.new_zeros(())

        if fused_eq_loss is not None:
            if evm:
                vis_t = R.next_vis_t(vis_t_minus, vis_t0)
                sums = fused_eq_loss(params, x_eq, e, vis_t, eq_w, re)
                l1, l2, l3, l4 = sums[0] / n_f, sums[1] / n_f, sums[2] / n_f, sums[3] / n_f
                new_vis_t_minus = R.update_vis_t_minus(e, sc.alpha_evm)
                vis_t_mean = torch.sum(vis_t * eq_w) / n_f
                loss_e = l1 + l2 + l3 + entropy_weight * l4
            else:
                sums = fused_eq_loss(params, x_eq, eq_w, re)
                l1, l2, l3 = sums[0] / n_f, sums[1] / n_f, sums[2] / n_f
                l4 = zero
                new_vis_t_minus = vis_t_minus
                vis_t_mean = zero
                loss_e = l1 + l2 + l3
            return alpha_e * loss_e, (l1, l2, l3, l4, vis_t_mean, new_vis_t_minus)

        derivs = engine(params, x_eq)
        if evm:
            vis_t = R.next_vis_t(vis_t_minus, vis_t0)
            res = R.ev_ns_residuals(derivs, e, vis_t, re, coord_scale)
            new_vis_t_minus = R.update_vis_t_minus(e, sc.alpha_evm)
            vis_t_mean = torch.sum(vis_t * eq_w) / n_f
        else:
            res = R.ns_residuals(derivs, re, coord_scale)
            new_vis_t_minus = vis_t_minus
            vis_t_mean = zero
        if loss_mode == "L2":
            l1 = L.masked_l2_norm(res.eq1, eq_w)
            l2 = L.masked_l2_norm(res.eq2, eq_w)
            l3 = L.masked_l2_norm(res.eq3, eq_w)
            l4 = L.masked_l2_norm(res.eq4, eq_w) if res.eq4 is not None else zero
            loss_e = l1 + l2 + l3 + (entropy_weight * l4 if evm else 0.0)
        else:
            loss_e, (l1, l2, l3, l4) = L.equation_loss(res, eq_w, n_f, entropy_weight)
        return alpha_e * loss_e, (l1, l2, l3, l4, vis_t_mean, new_vis_t_minus)

    def aux_loss_fn(params_all, batch: Batch, sc: StageScalars):
        """Boundary + supervised part, weighted, plus the raw components."""
        with profiling.fine("loss.boundary"):
            return aux_terms(params_all[0], batch, sc)

    def aux_terms(params, batch: Batch, sc: StageScalars):
        x_bc = torch.cat([batch.x_b, batch.y_b], dim=1)
        uvp_b = apply_main(params, x_bc)
        if loss_mode == "L2":
            # norm(u_b - u_pred) + norm(v_b - v_pred), NSFnet/pinn_solver.py:201-203
            loss_b = (L.masked_l2_norm(uvp_b[:, 0:1] - batch.u_b, batch.b_mask)
                      + L.masked_l2_norm(uvp_b[:, 1:2] - batch.v_b, batch.b_mask))
        else:
            loss_b = L.boundary_loss(uvp_b[:, 0:1], uvp_b[:, 1:2],
                                     batch.u_b, batch.v_b, batch.b_mask, batch.n_b)
        if batch.x_s is not None:
            uvp_s = apply_main(params, torch.cat([batch.x_s, batch.y_s], dim=1))
            loss_s = L.supervised_loss(uvp_s[:, 0:1], uvp_s[:, 1:2], uvp_s[:, 2:3],
                                       batch.u_s, batch.v_s, batch.p_s, batch.s_mask,
                                       batch.n_s, batch.p_mask, batch.n_p)
        else:
            loss_s = torch.zeros_like(loss_b)
        return sc.alpha_b * loss_b + alpha_s * loss_s, (loss_b, loss_s)

    def assemble(loss_b, l1, l2, l3, l4, loss_s, vis_t_mean, sc: StageScalars):
        loss_e = l1 + l2 + l3 + (entropy_weight * l4 if evm else 0.0)
        total = sc.alpha_b * loss_b + alpha_e * loss_e + alpha_s * loss_s
        return StepMetrics(total, loss_b, loss_e, loss_s, l1, l2, l3, l4, vis_t_mean)

    def loss_fn(params_all, batch: Batch, vis_t_minus, sc: StageScalars):
        _, (l1, l2, l3, l4, vis_t_mean, new_vis_t_minus) = eq_loss_fn(
            params_all, batch.x_f, batch.y_f, batch.eq_w, batch.n_f, vis_t_minus, sc)
        _, (loss_b, loss_s) = aux_loss_fn(params_all, batch, sc)
        metrics = assemble(loss_b, l1, l2, l3, l4, loss_s, vis_t_mean, sc)
        return metrics.total, (metrics, new_vis_t_minus)

    loss_fn.eq_loss_fn = eq_loss_fn
    loss_fn.aux_loss_fn = aux_loss_fn
    loss_fn.assemble = assemble
    return loss_fn


def make_residual_fn(
    engine: Engine,
    apply_main: Callable,
    apply_evm: Optional[Callable],
    coord_scale: float,
    alpha_e: float,
    alpha_s: float = 0.0,
    entropy_weight: float = 0.1,
    evm: bool = True,
):
    """The flat weighted residual vector r(params) with sum(r**2) equal to
    the MSE loss total (nsfnet_tpu/training/step.py:193-268): the same
    masks, counts and weights as make_loss_fn, each row scaled by
    sqrt(alpha / count), so pad rows are zero rows of the Jacobian. Plain
    PyTorch only (the Gauss-Newton products take forward-mode derivatives
    through it, which the kernel wrappers do not have); MSE mode only.

    `residual_fn.eq_residual_fn` gives the equation rows of any SLICE of
    the collocation set, scaled by the GLOBAL real-point count `n_f`, so
    the slices' rows together are the full vector's equation rows; the
    microbatched Gauss-Newton products sum over them.
    `residual_fn.aux_residual_fn` gives the boundary and supervised rows."""

    def eq_residual_fn(params_all, x_f, y_f, eq_w, vis_t_minus, n_f, sc: StageScalars):
        params, params_evm = params_all
        re = sc.re
        x_eq = torch.cat([x_f, y_f], dim=1)
        derivs = engine(params, x_eq)
        if evm:
            e = apply_evm(params_evm, x_eq)[:, 0:1]
            vis_t = R.next_vis_t(vis_t_minus, 20.0 / re)
            res = R.ev_ns_residuals(derivs, e, vis_t, re, coord_scale)
        else:
            res = R.ns_residuals(derivs, re, coord_scale)
        sw = torch.sqrt(eq_w * (alpha_e / n_f))
        parts = [sw * res.eq1, sw * res.eq2, sw * res.eq3]
        if evm and res.eq4 is not None:
            parts.append(entropy_weight ** 0.5 * sw * res.eq4)
        return torch.cat([p.reshape(-1) for p in parts])

    def aux_residual_fn(params_all, batch: Batch, sc: StageScalars):
        params, _ = params_all
        uvp_b = apply_main(params, torch.cat([batch.x_b, batch.y_b], dim=1))
        bw = torch.sqrt(batch.b_mask * (sc.alpha_b / batch.n_b))
        parts = [bw * (uvp_b[:, 0:1] - batch.u_b), bw * (uvp_b[:, 1:2] - batch.v_b)]
        if batch.x_s is not None:
            uvp_s = apply_main(params, torch.cat([batch.x_s, batch.y_s], dim=1))
            suw = torch.sqrt(batch.s_mask * (alpha_s / batch.n_s))
            parts += [suw * (uvp_s[:, 0:1] - batch.u_s), suw * (uvp_s[:, 1:2] - batch.v_s)]
            if batch.p_s is not None and batch.p_mask is not None:
                keep = batch.p_mask > 0
                pw = torch.sqrt(batch.p_mask * (alpha_s / max(float(batch.n_p), 1.0)))
                p_t = torch.where(keep, batch.p_s, torch.zeros_like(batch.p_s))
                p_p = torch.where(keep, uvp_s[:, 2:3], torch.zeros_like(p_t))
                parts.append(pw * (p_p - p_t))
        return torch.cat([p.reshape(-1) for p in parts])

    def residual_fn(params_all, batch: Batch, vis_t_minus, sc: StageScalars):
        r_eq = eq_residual_fn(params_all, batch.x_f, batch.y_f, batch.eq_w, vis_t_minus,
                              batch.n_f, sc)
        return torch.cat([r_eq, aux_residual_fn(params_all, batch, sc)])

    residual_fn.eq_residual_fn = eq_residual_fn
    residual_fn.aux_residual_fn = aux_residual_fn
    return residual_fn


@torch.no_grad()
def adam_update_(p: torch.Tensor, g: torch.Tensor, opt: AdamState, lr: float) -> None:
    """optax.scale_by_adam() (b1 .9, b2 .999, eps 1e-8, eps_root 0) applied
    as p -= lr * u, in place on p and the moments."""
    with profiling.fine("step.adam"):
        opt.count += 1
        opt.mu.mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
        opt.nu.mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
        mu_hat = opt.mu / (1.0 - ADAM_B1 ** opt.count)
        nu_hat = opt.nu / (1.0 - ADAM_B2 ** opt.count)
        p.sub_(lr * (mu_hat / (nu_hat.sqrt() + ADAM_EPS)))


def components(m: StepMetrics) -> torch.Tensor:
    """The 7 raw components [loss_b, l1, l2, l3, l4, loss_s, vis_t_mean] of
    a step's metrics, detached: each a local sum over global counts, so
    summing them over ranks or slices gives the full batch's, and
    `assemble(*components, sc)` rebuilds every metric from them."""
    return torch.stack([m.boundary, m.eq1, m.eq2, m.eq3, m.eq4, m.supervised,
                        m.vis_t_mean]).detach()


def reduce_flat(tensors, group):
    """Sum a list of tensors over the ranks of `group` in ONE collective:
    one flat buffer, all-reduced, split back (the JAX package's stacked
    psum of the components and psum of the gradients, step.py:168-177,
    :392-393, in one). `group` None: no collective, the tensors as given."""
    if group is None:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    pmesh.all_reduce_sum_(flat, group)
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].view_as(t))
        off += t.numel()
    return out


def make_grad_fn(loss_fn, n_micro: int = 1, group=None):
    """(params_all, targets, batch, vis_t_minus, sc) -> (gradients of the
    total wrt `targets`, the step's StepMetrics, the new vis_t carry).

    torch.distributed.all_reduce has no gradient, so the local total
    (every component a local sum over GLOBAL counts) is differentiated on
    each rank, and the gradients and the 7 detached components are then
    summed over `group` in one collective (`reduce_flat`): the sum of the
    ranks' gradients is the gradient of the global loss.

    n_micro > 1 is gradient accumulation (nsfnet_tpu/training/step.py:
    333-430): the collocation rows (x_f, y_f, eq_w, the carry) in n_micro
    contiguous slices, one autograd.grad of the equation loss per slice,
    each slice's graph freed before the next (the peak activation memory
    is one slice's: the point of the feature), then the boundary and
    supervised part once; the new carry rows are concatenated in slice
    order. The same sums as the full batch, in another order."""
    eq_fn, aux_fn, assemble = loss_fn.eq_loss_fn, loss_fn.aux_loss_fn, loss_fn.assemble

    def full(params_all, targets, batch, vtm, sc):
        total, (metrics, new_vtm) = loss_fn(params_all, batch, vtm, sc)
        with profiling.fine("step.backward"):
            return list(torch.autograd.grad(total, targets)), metrics, new_vtm

    def micro(params_all, targets, batch, vtm, sc):
        m = batch.x_f.shape[0] // n_micro
        grads = [torch.zeros_like(t) for t in targets]
        comps = batch.x_f.new_zeros(7)
        rows = []
        for i in range(n_micro):
            sl = slice(i * m, (i + 1) * m)
            val, (l1, l2, l3, l4, vmean, nvtm) = eq_fn(
                params_all, batch.x_f[sl], batch.y_f[sl], batch.eq_w[sl], batch.n_f,
                None if vtm is None else vtm[sl], sc)
            with profiling.fine("step.backward"):
                for acc, g in zip(grads, torch.autograd.grad(val, targets)):
                    acc.add_(g)
            comps[1:5] += torch.stack([l1, l2, l3, l4]).detach()
            comps[6] += vmean.detach()
            rows.append(nvtm)
        val, (loss_b, loss_s) = aux_fn(params_all, batch, sc)
        # the EVM net takes no part in the boundary / supervised loss
        with profiling.fine("step.backward"):
            for acc, g in zip(grads, torch.autograd.grad(val, targets, allow_unused=True)):
                if g is not None:
                    acc.add_(g)
        comps[0] += loss_b.detach()
        comps[5] += loss_s.detach()
        return grads, assemble(*comps, sc), (None if vtm is None else torch.cat(rows))

    run = micro if n_micro > 1 else full

    def grad_fn(params_all, targets, batch, vtm, sc):
        grads, metrics, new_vtm = run(params_all, targets, batch, vtm, sc)
        if group is None:
            return grads, metrics, new_vtm
        *grads, comps = reduce_flat(grads + [components(metrics)], group)
        return grads, assemble(*comps, sc), new_vtm

    return grad_fn


def _step_with(grad_fn, evm_update_freq: int, evm: bool):
    def train_step(state: TrainState, batch: Batch, sc: StageScalars) -> StepMetrics:
        with profiling.step():
            do_evm = (evm and state.epoch_in_stage % evm_update_freq == 0
                      and state.epoch_in_stage > 0)
            targets = [state.params] + ([state.params_evm] if do_evm else [])
            grads, metrics, new_vtm = grad_fn((state.params, state.params_evm), targets, batch,
                                              state.vis_t_minus, sc)
            adam_update_(state.params, grads[0], state.opt_main, sc.lr)
            if do_evm:
                adam_update_(state.params_evm, grads[1], state.opt_evm, sc.lr)
            state.vis_t_minus = new_vtm
            state.step += 1
            state.epoch_in_stage += 1
            return StepMetrics(*(m.detach() for m in metrics))

    return train_step


def make_train_step(loss_fn, evm_update_freq: int = 10000, evm: bool = True, group=None):
    """Adam with a runtime learning rate; the EVM update is gated on the
    stage-epoch counter (ev-NSFnet/pinn_solver.py:456-462), a host decision
    that is the same on every rank, so the gradient buffer of the
    collective has one layout on all of them. `group`: the process group
    whose ranks each hold a block of the batch (None: one process)."""
    return _step_with(make_grad_fn(loss_fn, 1, group), evm_update_freq, evm)


def make_microbatched_train_step(loss_fn, n_micro: int, evm_update_freq: int = 10000,
                                 evm: bool = True, group=None):
    """make_train_step over `n_micro` collocation slices (make_grad_fn;
    nsfnet_tpu/training/step.py:333-430): N_f beyond one activation
    footprint. Each slice must stay whole kernel tiles (the solver pads the
    batch to world x ROW_ALIGN x n_micro rows)."""
    return _step_with(make_grad_fn(loss_fn, n_micro, group), evm_update_freq, evm)


def make_chunk_runner(train_step):
    """Run n_steps training steps back to back with no host sync; returns
    the LAST step's metrics, still on the device (what the reference logs,
    pinn_solver.py:478-480)."""

    def run_chunk(state: TrainState, batch: Batch, sc: StageScalars, n_steps: int):
        metrics = None
        for _ in range(n_steps):
            metrics = train_step(state, batch, sc)
        return metrics

    return run_chunk
