"""The PINN solver: the user-facing orchestrator (port of
nsfnet_tpu/training/solver.py, main path).

API parity with the reference `PysicsInformedNeuralNetwork`
(ev-NSFnet/pinn_solver.py:27-765): set_boundary_data, set_eq_training_data,
set_supervised_data, set_supervised_loss_weight, set_coordinate_transform,
set_alpha_evm, train, evaluate, test, predict, save, load; and the JAX
package's campaign surface: attach_dataset, eq_points, refresh_vis_t,
residuals_at, mid-stage resume, bounded chunks, a SIGTERM-safe step counter,
the rollback after a device error, the adaptive boundary weight and the
second-order polish stages (train(optimizer="lbfgs" | "lm")). What differs
from the reference, as in the JAX package:
  * point batches are padded with zero-weight rows; losses are exact means
    over the real points;
  * the EVM lag field vis_t is a device carry (no per-step host sync);
  * the EVM freeze schedule is a gated update (no optimizer rebuild, Adam
    moments kept);
  * checkpoints hold the FULL train state for an exact resume; `load` also
    reads the JAX package's checkpoints (training/checkpoint.py).

The solver runs on `cuda` unless the caller asks for the CPU; with no card
and no such request it raises. `engine` names the residual-engine backend
with the JAX package's words: `pallas` is the hand-written CUDA engine,
`xla` the plain PyTorch one, `auto` picks `pallas` on a card and `xla` on
the CPU. On `pallas` an MSE run takes the fused residual-loss kernel pair
(ops/fused_residual.py) unless NSFNET_FUSED_LOSS=0; an L2 run, or an MSE
run with the fused loss off, takes the five-stream kernel pair
(ops/mlp_streams.py) -> residuals -> masked sums. A kernel wrapper given
CPU tensors runs its plain version.

`formulation="streamfunction"`: the main net outputs (psi, p) and
u = psi_y, v = -psi_x, so continuity holds exactly (eq3 == 0) and the
momentum residuals need third derivatives of psi. Its engine is the order-3
kernel pair (ops/psi_streams.py) on `pallas` and the closed form
(ops/derivatives.mlp_psi_derivatives_2d) on `xla`. On `pallas` an MSE run
takes `fused_residual_loss(..., formulation="streamfunction")`: kernel 5,
the residual-glue kernel pair and kernel 6 (ops/psi_residual.py), never
kernels 1+2, whose heads are (u, v, p); an L2 run, or NSFNET_FUSED_LOSS=0,
takes kernel 5 -> the bundle, residuals and masked sums in PyTorch ->
kernel 6. Under `auto`, NSFNET_PALLAS_PSI=0 keeps the closed form on a
card; an explicit engine="pallas" wins.

The polish stages (training/lbfgs.py, training/lm.py) and the adaptive bc
weight's probe run the loss of the JAX package's `self._loss_fn`: the
closed-form engine with no fused loss, here in exact fp32 whatever
`matmul_precision` says (the JAX package runs them at that name). They
optimise both nets with the EVM carry frozen; the device-error rollback is
Adam-only, as in the JAX package.

The other backbones (nsfnet_tpu/training/solver.py:186-221, 451-503): the
KAN (`backbone="kan"`, models/kan.py) runs its closed-form B-spline/silu
engine (ops/derivatives.make_kan_derivatives_2d), and a Fourier-embedded
MLP (`fourier_features` > 0) the generic nested-jvp engines
(ops/derivatives.derivatives_2d, psi_p_derivatives_2d). No kernel serves
either, in either package: `auto` resolves to `xla` for them, an explicit
`pallas` falls back to `xla`, and the fused loss is never built. The KAN
has no streamfunction formulation. `_engine("generic")` puts any net on the
generic engine (a cross-check of the closed forms).

Microbatching and data parallelism (nsfnet_tpu/training/solver.py:149-153,
384-451, 565-600, 1113-1130): `microbatches` > 1 accumulates the step's
gradient over that many collocation slices (training/step.py). Under a
torch.distributed process group (train.py brings it up under torchrun;
one process per card) each rank holds a contiguous block of every padded
point set (parallel/mesh.py) with the global real-point counts, and every
step, L-BFGS evaluation, LM product and bc-weight probe sums its local
gradient and loss parts over the ranks in one collective; the host
decisions that follow are then the same on every rank. `save` gathers the
vis_t carry and rank 0 writes; resampling and RAR draw the same points on
every rank (the same seed, the same scores). `mesh_devices` names the
world size the run must have.

The reference's `.pth` format (utils/torch_import.py): `save_torch` writes
the plain velocity MLP's nets as FCNet state_dicts, `load_torch` imports
them with fresh optimizer moments (nsfnet_tpu/training/solver.py:1233-1310).
"""

from __future__ import annotations

import contextlib
import os
import signal
import statistics
import time
from typing import Optional

import numpy as np
import torch

from nsfnet_tpu_torch.logger import get_logger
from nsfnet_tpu_torch.models import convert
from nsfnet_tpu_torch.models.kan import KAN, flatten_kan
from nsfnet_tpu_torch.models.mlp import MLP, Params, flatten_params, mlp_apply, unflatten_params
from nsfnet_tpu_torch.ops import residuals as R
from nsfnet_tpu_torch.ops.derivatives import (derivatives_2d, make_kan_derivatives_2d,
                                              mlp_derivatives_2d, mlp_psi_derivatives_2d,
                                              psi_p_derivatives_2d, psi_p_uv, psi_p_uv_generic,
                                              psi_p_uv_stacked)
from nsfnet_tpu_torch.ops.fused_residual import ROW_ALIGN, KernelLaunchError, fused_residual_loss
from nsfnet_tpu_torch.ops.mlp_streams import mlp_streams
from nsfnet_tpu_torch.ops.psi_streams import psi_streams
from nsfnet_tpu_torch.parallel import mesh as pmesh
from nsfnet_tpu_torch.training import checkpoint as ckpt
from nsfnet_tpu_torch.training.lbfgs import run_lbfgs
from nsfnet_tpu_torch.training.lm import run_lm, run_lm_micro, stack_slices
from nsfnet_tpu_torch.training.state import AdamState, Batch, StepMetrics, TrainState
from nsfnet_tpu_torch.training.step import (
    StageScalars,
    make_chunk_runner,
    make_loss_fn,
    make_microbatched_train_step,
    make_residual_fn,
    make_train_step,
    reduce_flat,
)
from nsfnet_tpu_torch.utils import profiling
from nsfnet_tpu_torch.utils import torch_import as ti
from nsfnet_tpu_torch.utils.tensorboard import ScalarWriter


# Errors after which train() rolls back to its last checkpoint: a kernel's
# launch error, the allocator running out, and torch's CUDA error. A sticky
# error poisons the context, so the reload fails too and is raised: the
# process ends, and --resume from the newest checkpoint takes over.
DEVICE_ERRORS = (KernelLaunchError, torch.cuda.OutOfMemoryError) + (
    (torch.AcceleratorError,) if hasattr(torch, "AcceleratorError") else ())


@contextlib.contextmanager
def _defer_sigterm():
    """Defer SIGTERM across a chunk of steps and the step-counter increment
    (the counterpart of nsfnet_tpu/training/solver.py:50-69). The chunk
    runner advances the state in place one step at a time, so the driver's
    GracefulStop raised inside it would checkpoint params ahead of
    `global_step`. A thread mask cannot hold it off here (the kernel hands a
    process-wide signal to a thread that does not block it, such as one of
    torch's worker threads, and Python runs its handler in the main thread
    all the same), so the region installs a handler that only records the
    signal, and delivers it again to the driver's handler on the way out,
    at a chunk boundary. An exception leaving the region wins."""
    pending = []
    try:
        old = signal.signal(signal.SIGTERM, lambda signum, frame: pending.append(signum))
    except ValueError:  # not the main thread: nothing to defer to
        yield
        return
    try:
        yield
    except BaseException:
        signal.signal(signal.SIGTERM, old)
        raise
    signal.signal(signal.SIGTERM, old)
    if pending:
        signal.raise_signal(signal.SIGTERM)


def resolve_device(device=None) -> torch.device:
    """`cuda` unless asked otherwise; a CUDA request without a card raises
    (never a silent fall back to the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(or --cpu) to run on the CPU")
    return dev


def resolve_engine(engine: str, device_type: str, backbone: str = "mlp",
                   fourier_features: int = 0, formulation: str = "velocity") -> str:
    """The engine a solver runs (nsfnet_tpu/training/solver.py:186-221):
    `auto` is `pallas` on a card for the plain MLP and `xla` otherwise
    (NSFNET_PALLAS_PSI=0 keeps a streamfunction run on `xla`); a KAN or a
    Fourier net has no kernel, so `pallas` falls back to `xla` for it."""
    if engine == "auto":
        engine = "pallas" if device_type == "cuda" and backbone == "mlp" else "xla"
        if formulation == "streamfunction" and os.environ.get("NSFNET_PALLAS_PSI") == "0":
            engine = "xla"
    if engine == "pallas" and (backbone != "mlp" or fourier_features > 0):
        engine = "xla"
    return engine


@contextlib.contextmanager
def _exact_fp32():
    """Full-fp32 matmuls for evaluation, whatever the process has set
    (the reference evaluates in full fp32)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def stall_gain(eq_track, window: int) -> float:
    """Relative improvement of the best (minimum) equation loss achieved in
    the last `window` log intervals over the best before them. Minimum-based
    so oscillation around a converged value reads as ~0 gain while a
    noisy-but-descending track reads positive."""
    window = max(1, int(window))
    if len(eq_track) <= window:
        return float("inf")  # not enough history to call a stall
    best_before = min(eq_track[:-window])
    best_now = min(eq_track[-window:])
    return (best_before - best_now) / max(abs(best_before), 1e-30)


class PINNSolver:
    """2-D steady cavity PINN solver (vanilla NSFnet or ev-NSFnet), MLP (with
    or without Fourier features) or KAN backbone, velocity or streamfunction
    formulation. Constructor knobs follow ev-NSFnet/pinn_solver.py:32-54 and
    the JAX package's set."""

    @profiling.spanned("setup.solver")
    def __init__(
        self,
        Re: float = 1000,
        layers: int = 6,
        layers_1: Optional[int] = 4,
        hidden_size: int = 80,
        hidden_size_1: int = 40,
        N_f: int = 100000,
        alpha_evm: float = 0.03,
        learning_rate: float = 0.001,
        bc_weight: float = 10.0,
        eq_weight: float = 1.0,
        supervised_data_weight: float = 1.0,
        entropy_residual_weight: float = 0.1,
        num_ins: int = 2,
        num_outs: int = 3,
        num_outs_1: int = 1,
        checkpoint_freq: int = 10000,
        checkpoint_path: str = "./results",
        evm: bool = True,
        backbone: str = "mlp",  # mlp | kan
        kan_width=(2, 16, 16, 8),
        kan_grid: int = 5,
        kan_k: int = 3,
        fourier_features: int = 0,  # random Fourier embedding size of the main MLP (0 = off)
        fourier_sigma: float = 3.0,
        seed: int = 42,
        matmul_precision: str = "high",
        evm_update_freq: int = 10000,
        log_interval: int = 1000,
        engine: str = "auto",  # auto | pallas | xla — residual-engine backend
        loss_mode: str = "MSE",  # MSE | L2 (reference v1's un-normalized norms)
        formulation: str = "velocity",  # velocity | streamfunction (net outputs psi, p)
        max_chunk: int = 2000,  # most steps queued between two host syncs
        lm_microbatches: int = 1,  # collocation slices of the LM Gauss-Newton products
        adaptive_bc_weight: bool = False,  # grad-norm boundary-weight balancing
        adaptive_bc_ema: float = 0.9,
        adaptive_bc_max: float = 1000.0,
        microbatches: int = 1,  # gradient-accumulation slices of the collocation batch
        mesh_devices: Optional[int] = None,  # the world size the run must have (None: any)
        device=None,
    ):
        self.device = resolve_device(device)
        self.max_chunk = int(max_chunk)
        if engine not in ("auto", "pallas", "xla"):
            raise ValueError(f"unknown engine {engine!r}; auto, pallas or xla")
        if backbone not in ("mlp", "kan"):
            raise ValueError(f"unknown backbone {backbone!r}; mlp or kan")
        if loss_mode not in ("MSE", "L2"):
            raise ValueError(f"unknown loss_mode {loss_mode!r}; MSE or L2")
        if formulation not in ("velocity", "streamfunction"):
            raise ValueError(f"unknown formulation {formulation!r}")
        self.microbatches = max(1, int(microbatches))
        if loss_mode == "L2" and self.microbatches > 1:
            raise ValueError("L2 loss mode does not compose with microbatching")
        # the process group train.py brought up (None: one process)
        self.group = pmesh.process_group()
        self.rank, self.world_size = pmesh.rank_and_world(self.group)
        if mesh_devices is not None and int(mesh_devices) != self.world_size:
            raise ValueError(
                f"mesh_devices={mesh_devices} but this run has {self.world_size} process(es): "
                f"the port runs one process per card; launch {mesh_devices} with torchrun "
                f"--nproc_per_node={mesh_devices} -m nsfnet_tpu_torch.train ...")
        if loss_mode == "L2" and self.world_size > 1:
            # an L2 norm is not a sum of per-rank parts
            raise ValueError("L2 loss mode is single-program only (like the reference's)")
        self.formulation = formulation
        if formulation == "streamfunction":
            if backbone != "mlp":
                raise ValueError("formulation='streamfunction' supports the MLP backbone")
            num_outs = 2  # (psi, p); u and v are derivatives of psi
        self.backbone = backbone
        # no kernel (and no fused loss) for a KAN or a Fourier-embedded net
        self._generic_engine = backbone == "kan" or int(fourier_features) > 0
        self.engine = resolve_engine(engine, self.device.type, backbone,
                                     int(fourier_features), formulation)
        self.loss_mode = loss_mode
        self.Re = float(Re)
        self.vis_t0 = 20.0 / self.Re  # ev-NSFnet/pinn_solver.py:67
        self.N_f = N_f
        self.alpha_evm = float(alpha_evm)
        self.alpha_b = float(bc_weight)
        self.alpha_e = float(eq_weight)
        self.alpha_s = float(supervised_data_weight)
        self.lm_microbatches = max(1, int(lm_microbatches))
        self.adaptive_bc_weight = bool(adaptive_bc_weight)
        self.adaptive_bc_ema = float(adaptive_bc_ema)
        self.adaptive_bc_max = float(adaptive_bc_max)
        self.entropy_residual_weight = float(entropy_residual_weight)
        self.evm = bool(evm) and layers_1 is not None
        self.checkpoint_freq = checkpoint_freq
        self.checkpoint_path = checkpoint_path
        self.evm_update_freq = evm_update_freq
        self.log_interval = log_interval
        self.matmul_precision = matmul_precision
        self.current_stage = " "
        self.current_lr = learning_rate
        self.current_re = self.Re
        self.current_alpha_b = self.alpha_b
        self.coord_scale = 1.0
        self.layers = layers
        self.hidden_size = hidden_size
        self.layers_1 = layers_1
        self.hidden_size_1 = hidden_size_1
        self.logger = get_logger()

        gen = torch.Generator().manual_seed(seed)
        if backbone == "kan":
            self.net = KAN(kan_width, kan_grid, kan_k, gen, self.device)
        else:
            self.net = MLP(num_ins, num_outs, layers, hidden_size, gen, self.device,
                           fourier_features=fourier_features, fourier_sigma=fourier_sigma)
        self.net_1 = (MLP(num_ins, num_outs_1, layers_1, hidden_size_1, gen, self.device)
                      if self.evm else None)
        self.state = TrainState(
            params=self.net.flat,
            params_evm=self.net_1.flat if self.evm else None,
            opt_main=AdamState.zeros_like(self.net.flat),
            opt_evm=AdamState.zeros_like(self.net_1.flat) if self.evm else None,
            vis_t_minus=None,
        )
        self.global_step = 0
        self.loss_history = []  # (global_step, StepMetrics of floats) per log
        self.tb_writer: Optional[ScalarWriter] = None  # the driver attaches one
        self.dataset = None  # the sampler whose state rides in checkpoints

        self._bc = None
        self._eq = None
        self._eq_weights = None
        self._sup = None
        self._batch: Optional[Batch] = None
        self._runner = None
        self._loss_fn = None  # the closed-form exact-fp32 loss: polish stages, bc probe
        self.polish_stats: Optional[dict] = None  # the last polish stage's record
        self._dirty = True
        self._vis_stale = True
        self._eval_fields = None

        self.logger.info(
            f"PINNSolver: variant={'ev-nsfnet' if self.evm else 'nsfnet'} "
            f"net={self._net_name()} formulation={formulation} "
            f"engine={self.engine} loss={loss_mode} microbatches={self.microbatches} "
            f"ranks={self.world_size} device={self.device}"
            + (f" ({torch.cuda.get_device_name(self.device)})"
               if self.device.type == "cuda" else ""))

    # ------------------------------------------------------------ weights

    def _net_name(self) -> str:
        if self.backbone == "kan":
            return f"KAN{list(self.net.width)} grid={self.net.grid} k={self.net.k}"
        m = self.net.fourier_features
        return f"{self.layers}x{self.hidden_size}" + (f" fourier={m}" if m else "")

    def params(self):
        return self.net.params()

    def params_evm(self) -> Optional[Params]:
        return self.net_1.params() if self.evm else None

    def set_params(self, params: Params, params_evm: Optional[Params] = None):
        """Install network weights (per-layer tuples in the layout of
        models/mlp.py, or of models/kan.py for a KAN), with fresh optimizer
        moments and a vis_t carry recomputed from the installed EVM net — a
        restart like the reference's weight import."""
        flatten = flatten_kan if self.backbone == "kan" else flatten_params
        with torch.no_grad():
            self.net.flat.copy_(flatten(params))
            if self.evm and params_evm is not None:
                self.net_1.flat.copy_(flatten_params(params_evm))
        self.state.opt_main = AdamState.zeros_like(self.net.flat)
        if self.evm:
            self.state.opt_evm = AdamState.zeros_like(self.net_1.flat)
        self.refresh_vis_t()
        self._dirty = True

    # ---------------------------------------------------------------- data

    @profiling.spanned("setup.data")
    def set_boundary_data(self, X=None):
        """X = (x_b, y_b, u_b, v_b) host arrays [N,1]
        (parity: ev-NSFnet/pinn_solver.py:142-158)."""
        self._bc = tuple(np.asarray(a, np.float32).reshape(-1, 1) for a in X[:4])
        self._dirty = True

    @profiling.spanned("setup.data")
    def set_eq_training_data(self, X=None, weights=None):
        """X = (x_f, y_f); optional per-point SDF weights
        (parity: ev-NSFnet/pinn_solver.py:160-184)."""
        self._eq = tuple(np.asarray(a, np.float32).reshape(-1, 1) for a in X[:2])
        self._eq_weights = (np.asarray(weights, np.float32).reshape(-1, 1)
                            if weights is not None else None)
        self._dirty = True
        if self.evm:
            self._init_vis_t()
            self._vis_stale = True  # the carried vis_t belongs to the old points

    def eq_points(self):
        """The installed (x_f, y_f) columns: a second solver (the --init-from
        donor) shares this draw without advancing the sampler."""
        return self._eq

    def attach_dataset(self, dataset) -> None:
        """Register the collocation sampler (data/cavity.CavityData): its
        state rides in every checkpoint's metadata, so a resume replays the
        writer's points."""
        self.dataset = dataset

    def refresh_vis_t(self):
        """Recompute the viscosity carry from the current EVM net (after new
        weights are installed); a no-op without an EVM net or points."""
        if not self.evm or self._eq is None:
            return
        self._init_vis_t()
        self._vis_stale = True
        self._dirty = True

    def _init_vis_t(self):
        """vis_t_minus := alpha_evm*|e(x_f)| with the current EVM net
        (parity: init_vis_t, ev-NSFnet/pinn_solver.py:138-140)."""
        x = torch.from_numpy(np.concatenate(self._eq, axis=1)).to(self.device)
        with torch.no_grad(), _exact_fp32():
            e = self.net_1(x)[:, 0:1]
        self._vis_t_init = self.alpha_evm * np.abs(e.cpu().numpy()).astype(np.float32)

    def set_supervised_data(self, data):
        """data = (x, y, u, v, p) host arrays, or None; p may hold NaN, which
        is masked (parity: ev-NSFnet/pinn_solver.py:202-254)."""
        if data is None:
            self._sup = None
        else:
            x, y, u, v, p = data
            col = lambda a: np.asarray(a, np.float32).reshape(-1, 1)
            self._sup = (col(x), col(y), col(u), col(v), col(p) if p is not None else None)
        self._dirty = True

    def clear_supervised_data(self):
        self.set_supervised_data(None)

    def set_supervised_loss_weight(self, weight: float):
        self.alpha_s = float(weight)
        self._dirty = True

    def set_coordinate_transform(self, scale: Optional[float]):
        """Chain-rule scale for [0,1]->[-1,1] domains
        (parity: ev-NSFnet/pinn_solver.py:186-192)."""
        self.coord_scale = 1.0 if (scale is None or scale <= 0) else float(scale)
        self._dirty = True

    def set_alpha_evm(self, alpha: float):
        self.alpha_evm = float(alpha)

    # ------------------------------------------------------------ assembly

    def _eq_pad_size(self, n_f: int) -> int:
        """Padded collocation rows: every rank's block, and every
        microbatch slice of it, whole ROW_ALIGN tiles (the kernel wrappers
        refuse any other size; nsfnet_tpu/training/solver.py:441-451)."""
        return pmesh.padded_size(n_f, self.world_size, lane=ROW_ALIGN * self.microbatches)

    def _shard(self, a: np.ndarray) -> np.ndarray:
        """This rank's block of a padded host array."""
        return pmesh.shard_rows(a, self.rank, self.world_size)

    def _build_batch(self) -> Batch:
        """This rank's block of every point set, padded with zero-weight
        rows, with the GLOBAL real-point counts (nsfnet_tpu/training/
        solver.py:381-439). Under one process no kernel reads the boundary
        and supervised sets: they stay unpadded."""
        if self._bc is None or self._eq is None:
            raise RuntimeError("set_boundary_data and set_eq_training_data first")
        dev = lambda a: torch.from_numpy(np.ascontiguousarray(self._shard(a))).to(self.device)
        world = self.world_size
        pad_to = lambda n: n if world == 1 else pmesh.padded_size(n, world)

        x_f, y_f = self._eq
        n_f = x_f.shape[0]
        nf_pad = self._eq_pad_size(n_f)
        w = self._eq_weights if self._eq_weights is not None else np.ones((n_f, 1), np.float32)

        x_b, y_b, u_b, v_b = self._bc
        n_b = x_b.shape[0]
        nb_pad = pad_to(n_b)
        bc = lambda a, fill=0.0: dev(pmesh.pad_rows(a, nb_pad, fill))

        sup = {}
        if self._sup is not None and self.alpha_s != 0.0:
            x_s, y_s, u_s, v_s, p_s = self._sup
            ns_pad = pad_to(x_s.shape[0])
            sp = lambda a: dev(pmesh.pad_rows(a, ns_pad))
            sup = dict(x_s=sp(x_s), y_s=sp(y_s), u_s=sp(u_s), v_s=sp(v_s),
                       s_mask=sp(np.ones_like(x_s)), n_s=float(x_s.shape[0]))
            if p_s is not None:
                finite = np.isfinite(p_s).astype(np.float32)
                sup.update(p_s=sp(np.nan_to_num(p_s)), p_mask=sp(finite),
                           n_p=float(finite.sum()))

        batch = Batch(
            x_f=dev(pmesh.pad_rows(x_f, nf_pad)),
            y_f=dev(pmesh.pad_rows(y_f, nf_pad)),
            eq_w=dev(pmesh.pad_rows(w, nf_pad, 0.0)), n_f=float(n_f),
            x_b=bc(x_b), y_b=bc(y_b), u_b=bc(u_b), v_b=bc(v_b),
            b_mask=bc(np.ones((n_b, 1), np.float32)), n_b=float(n_b),
            **sup,
        )
        if self.evm:
            vtm = pmesh.pad_rows(self._vis_t_init, nf_pad, self.vis_t0)
            cur = self.state.vis_t_minus
            if self._vis_stale or cur is None or cur.shape[0] * world != nf_pad:
                self.state.vis_t_minus = dev(vtm)
                self._vis_stale = False
        return batch

    def _uvp_apply(self, kind: Optional[str] = None):
        """(flat params, X[N,2]) -> [N,3] (u, v, p) VALUES: the forward pass
        every consumer of velocities uses (boundary loss, prediction). The
        net's output itself in the velocity formulation; u = s psi_y,
        v = -s psi_x by one value + first-tangent pass in the streamfunction
        formulation (generic tangent sweeps for a Fourier net), on `kind`
        "pallas" (the Adam step's loss) the stacked pass with its backward
        written out, on a card (ops/derivatives.psi_p_uv_stacked). For a KAN
        or a Fourier net, columns past the third (a KAN's extra outputs) are
        returned too and unread, as in the JAX package."""
        net, scale = self.net, self.coord_scale
        apply = lambda flat, x: net.apply_params(net.unflatten(flat), x)
        if self.formulation == "streamfunction":
            if self._generic_engine:
                return lambda flat, x: psi_p_uv_generic(lambda z: apply(flat, z), x, scale)
            if kind == "pallas":
                return lambda flat, x: psi_p_uv_stacked(flat, net.sizes, x, scale)
            return lambda flat, x: psi_p_uv(net.unflatten(flat), x, scale)
        return apply

    def _engine(self, kind: Optional[str] = None):
        """(flat params, X[N,2]) -> the (u, v, p) derivative bundle
        (nsfnet_tpu/training/solver.py:468-503): the kernel pair on "pallas",
        the closed form on "xla" (a KAN's own closed form), the generic
        nested-jvp engine on "generic" and for a Fourier net."""
        kind = kind or self.engine
        net, prec, scale = self.net, self.matmul_precision, self.coord_scale
        apply = lambda flat: (lambda z: net.apply_params(net.unflatten(flat), z))
        if self.backbone == "kan" and kind != "generic":
            kan_engine = make_kan_derivatives_2d(net)
            return lambda flat, x: kan_engine(net.unflatten(flat), x)
        generic = self._generic_engine or kind == "generic"
        if self.formulation == "streamfunction":
            if generic:
                return lambda flat, x: psi_p_derivatives_2d(apply(flat), x, scale)
            if kind == "pallas":
                return lambda flat, x: psi_streams(flat, net.sizes, x, scale, precision=prec)
            return lambda flat, x: mlp_psi_derivatives_2d(net.unflatten(flat), x, scale)
        if generic:
            return lambda flat, x: derivatives_2d(apply(flat), x)
        if kind == "pallas":
            return lambda flat, x: mlp_streams(flat, net.sizes, x, precision=prec)
        return lambda flat, x: mlp_derivatives_2d(net.unflatten(flat), x)

    def _fused_loss_enabled(self) -> bool:
        """NSFNET_FUSED_LOSS=0/1 forces the fused residual loss off/on;
        it is on by default."""
        return os.environ.get("NSFNET_FUSED_LOSS", "1") != "0"

    def _apply_evm(self):
        sizes_1 = self.net_1.sizes
        return lambda flat, x: mlp_apply(unflatten_params(flat, sizes_1), x)

    def _make_loss(self, kind: Optional[str] = None):
        """The step's loss on the engine `kind` (the solver's by default);
        "xla" is the closed form with no fused loss. The fused loss needs the
        plain MLP (nsfnet_tpu/training/solver.py:545-547)."""
        kind = kind or self.engine
        scale, evm, prec = self.coord_scale, self.evm, self.matmul_precision
        fused = None
        if kind == "pallas" and not self._generic_engine and self.loss_mode == "MSE" \
                and self._fused_loss_enabled():
            sizes, form = self.net.sizes, self.formulation
            if evm:
                def fused(flat, x, e, vis_t, eq_w, re):
                    return fused_residual_loss(flat, sizes, x, e, vis_t, eq_w, re,
                                               coord_scale=scale, evm=True, precision=prec,
                                               formulation=form)
            else:
                def fused(flat, x, eq_w, re):
                    return fused_residual_loss(flat, sizes, x, None, None, eq_w, re,
                                               coord_scale=scale, evm=False, precision=prec,
                                               formulation=form)
        return make_loss_fn(
            engine=self._engine(kind),
            apply_main=self._uvp_apply(kind),
            apply_evm=self._apply_evm() if evm else None,
            coord_scale=scale,
            alpha_e=self.alpha_e,
            alpha_s=self.alpha_s,
            entropy_weight=self.entropy_residual_weight,
            evm=evm,
            fused_eq_loss=fused,
            loss_mode=self.loss_mode,
        )

    def _ensure_ready(self):
        if not self._dirty and self._runner is not None:
            return
        with profiling.span("setup.ready"):
            self._batch = self._build_batch()
            if self.microbatches > 1:
                train_step = make_microbatched_train_step(
                    self._make_loss(), self.microbatches, self.evm_update_freq, self.evm,
                    self.group)
            else:
                train_step = make_train_step(self._make_loss(), self.evm_update_freq, self.evm,
                                             self.group)
            self._runner = make_chunk_runner(train_step)
            self._loss_fn = self._make_loss("xla")
            self._dirty = False

    # ------------------------------------------------------------- training

    def _stage_scalars(self, lr: float) -> StageScalars:
        return StageScalars(lr=float(lr), alpha_evm=self.alpha_evm,
                            re=self.current_re, alpha_b=self.current_alpha_b)

    def run_steps(self, n_steps: int, lr: Optional[float] = None) -> StepMetrics:
        """n_steps Adam steps at the current stage settings with no host
        sync; returns the last step's metrics on the device."""
        self._ensure_ready()
        sc = self._stage_scalars(self.current_lr if lr is None else lr)
        b = self._batch
        with profiling.chunk(n_steps, b.n_f + b.n_b, self.device):
            metrics = self._runner(self.state, b, sc, n_steps)
        self.global_step += n_steps
        return metrics

    def _grad_norm_ratio(self) -> float:
        """||grad L_eq|| / ||grad L_bc|| over the MAIN net's params on the
        current batch (nsfnet_tpu/training/solver.py:614-646): the balance
        signal of the adaptive boundary weight. The closed-form exact-fp32
        loss; the raw (unweighted) boundary part is differentiated, so the
        current weight does not feed back into its own update. Under a
        process group the norms are of the all-reduced gradients."""
        lf, st, b = self._loss_fn, self.state, self._batch
        sc = self._stage_scalars(self.current_lr)
        evm = st.params_evm.detach() if self.evm else None
        with _exact_fp32():
            p = st.params.detach().requires_grad_(True)
            eq, _ = lf.eq_loss_fn((p, evm), b.x_f, b.y_f, b.eq_w, b.n_f, st.vis_t_minus, sc)
            (g_eq,) = torch.autograd.grad(eq, [p])
            _, (loss_b, _) = lf.aux_loss_fn((p, evm), b, sc)
            (g_bc,) = torch.autograd.grad(loss_b, [p])
            g_eq, g_bc = reduce_flat([g_eq, g_bc], self.group)
            return (g_eq.norm() / (g_bc.norm() + 1e-12)).item()

    def _update_adaptive_bc(self):
        """EMA the boundary weight toward the grad-norm ratio clipped to
        [1, adaptive_bc_max] (nsfnet_tpu/training/solver.py:648-662); the
        next chunk's stage scalars read it."""
        ratio = self._grad_norm_ratio()
        if not np.isfinite(ratio):
            return
        target = float(np.clip(ratio, 1.0, self.adaptive_bc_max))
        m = self.adaptive_bc_ema
        self.current_alpha_b = m * self.current_alpha_b + (1.0 - m) * target
        self.logger.info(f"  adaptive bc_weight -> {self.current_alpha_b:.3f} "
                         f"(grad-norm ratio {ratio:.3f})")

    def train(self, num_epoch: int = 1, lr: float = 1e-4, optimizer: str = "adam",
              Re: Optional[float] = None, bc_weight: Optional[float] = None,
              resume_in_stage: bool = False, advance_on_stall: bool = False,
              stall_threshold: float = 0.02, stall_window: int = 3,
              stall_min_epochs: int = 0, stall_metric: str = "eq_loss"):
        """One stage: num_epoch full-batch Adam steps at fixed lr
        (parity: ev-NSFnet/pinn_solver.py:430-487), or with optimizer "lbfgs"
        / "lm" that many polish steps (train_lbfgs / train_lm); Re /
        bc_weight override the physics for this stage. Without bc_weight, a
        static-weight run resets the boundary weight to the config's at each
        stage, and an adaptive one keeps its EMA'd weight (load() restores it
        across resumes). Syncs with the device only at log and
        checkpoint boundaries, and at least every `max_chunk` steps.

        resume_in_stage continues a restored checkpoint mid-stage:
        num_epoch is then the FULL stage length and training starts at the
        restored epoch_in_stage, so the EVM gate's phase (epoch %
        evm_update_freq) matches the uninterrupted run.

        advance_on_stall ends the stage early once the stall metric, read at
        the log boundaries, has failed to set a better minimum by
        `stall_threshold` (relative) over the last `stall_window` intervals
        (`stall_gain`), never before `stall_min_epochs`. stall_metric
        'eq_loss' tracks the equation loss; 'eval_error' the mean u/v error
        against the fields given to `attach_eval_data` (the equation loss if
        none are attached). An early end fast-forwards `global_step` to the
        stage's end and writes the stage-end checkpoint, so that train.py's
        stage <-> step mapping lands on the next stage.

        A device error (DEVICE_ERRORS) rolls back to the stage's last
        checkpoint and goes on, at most three times; before the stage's
        first checkpoint it is raised."""
        self.current_re = float(Re) if Re is not None else self.Re
        if bc_weight is not None:
            self.current_alpha_b = float(bc_weight)
        elif not self.adaptive_bc_weight:
            self.current_alpha_b = self.alpha_b
        if optimizer == "lbfgs":
            return self.train_lbfgs(num_epoch)
        if optimizer == "lm":
            return self.train_lm(num_epoch)
        if optimizer != "adam":
            raise ValueError(f"unknown optimizer {optimizer!r}; adam, lbfgs or lm")
        self.current_lr = lr
        self._ensure_ready()
        if not resume_in_stage:
            self.state.epoch_in_stage = 0

        if not hasattr(self, "cumulative_start_time"):
            self.cumulative_start_time = time.time()
        stage_start = time.time()
        done = first = self.state.epoch_in_stage
        last_log_t, last_log_e = stage_start, done
        pts_per_step = int(self._batch.x_f.shape[0] + self._batch.x_b.shape[0]) * self.world_size
        use_eval_track = (advance_on_stall and stall_metric == "eval_error"
                          and self._eval_fields is not None)
        if advance_on_stall and stall_metric == "eval_error" and self._eval_fields is None:
            self.logger.warning("stall_metric='eval_error' but no eval data attached "
                                "(attach_eval_data): tracking the equation loss instead")
        eq_track = []  # stall-metric values at log boundaries
        seen = profiling.chunks()[-1:]  # the chunks up to here are not this stage's
        last_chunk = seen[0].id if seen else -1
        last_ckpt: Optional[str] = None
        crashes = 0
        while done < num_epoch:
            # first step alone (log parity with the reference's epoch 0),
            # then to the next log / checkpoint boundary
            if done == 0:
                n = 1
            else:
                n = min(min(((done // self.log_interval) + 1) * self.log_interval,
                            ((done // self.checkpoint_freq) + 1) * self.checkpoint_freq,
                            num_epoch) - done, self.max_chunk)
            with _defer_sigterm():
                try:
                    metrics = self.run_steps(n, lr)
                except DEVICE_ERRORS as err:
                    crashes += 1
                    # one rank cannot roll back alone: its peers wait in a
                    # collective, so a multi-process run ends here (and
                    # --resume takes over, as after a sticky error)
                    if last_ckpt is None or crashes > 3 or self.world_size > 1:
                        raise
                    self.logger.error(f"device error at stage-epoch {done} ({err}); rolling "
                                      f"back to {last_ckpt} (crash {crashes}/3)")
                    self._runner = None
                    self._dirty = True
                    self.load(last_ckpt)
                    done = self.state.epoch_in_stage
                    continue
                done += n
            if done == 1 or done % self.log_interval == 0 or done == num_epoch:
                m = metrics.to_host()
                now = time.time()
                interval_it_s = (done - last_log_e) / max(now - last_log_t, 1e-9)
                avg_it_s = (done - first) / max(now - stage_start, 1e-9)
                interval = profiling.chunks(since=last_chunk)
                if interval:
                    last_chunk = interval[-1].id
                self._print_log(m, done, num_epoch, avg_it_s, interval_it_s,
                                pts_per_step, now - stage_start,
                                now - self.cumulative_start_time, lr, interval)
                last_log_t, last_log_e = now, done
                if done > 1:  # the epoch-1 loss is pre-descent; skip it
                    if use_eval_track:
                        errs = self.evaluate(*self._eval_fields, log=False)
                        eq_track.append(0.5 * (errs["u"] + errs["v"]))
                    else:
                        eq_track.append(float(m.equation))
                if self.adaptive_bc_weight and done < num_epoch:
                    self._update_adaptive_bc()
            if (done == 1 and num_epoch >= self.checkpoint_freq) \
                    or done % self.checkpoint_freq == 0:
                last_ckpt = self.save(f"model_cavity_loop{done}.ckpt")
            if (advance_on_stall and done >= max(stall_min_epochs, 1)
                    and done < num_epoch and len(eq_track) > stall_window):
                gain = stall_gain(eq_track, stall_window)
                if gain < stall_threshold:
                    metric_name = "u/v eval-error" if use_eval_track else "eq-loss"
                    self.logger.info(
                        f"[{self.current_stage}] stalled at epoch {done}/{num_epoch}: best "
                        f"{metric_name} gain {gain * 100:.2f}% over {stall_window} log "
                        f"intervals < {stall_threshold * 100:.2f}% — advancing stage")
                    self.global_step += num_epoch - done
                    self.save(f"model_cavity_loop{num_epoch}.ckpt")
                    break
        return self.state

    def _flat_state(self):
        """(both nets' params as one detached flat vector, its split into
        the (params, params_evm) pair the losses take)."""
        n0 = self.state.params.numel()
        parts = [self.state.params] + ([self.state.params_evm] if self.evm else [])
        w0 = torch.cat([t.detach() for t in parts])
        return w0, lambda w: (w[:n0], w[n0:] if self.evm else None)

    def _install_flat(self, w: torch.Tensor):
        n0 = self.state.params.numel()
        with torch.no_grad():
            self.state.params.copy_(w[:n0])
            if self.evm:
                self.state.params_evm.copy_(w[n0:])

    def train_lbfgs(self, num_steps: int):
        """L-BFGS polish of both nets (training/lbfgs.py; the JAX package's
        train_lbfgs), vis_t carry frozen, on the closed-form loss in exact
        fp32. Chunks of max(1, max_chunk // 40) steps (a step runs up to 26
        value-and-grad evaluations); n_steps rounds up to whole chunks and
        global_step counts every step run. The state is replaced when the
        stage ends, so a SIGTERM (delivered between chunks) leaves the
        stage-start state for the checkpoint."""
        self._ensure_ready()
        batch, vtm, sc = self._batch, self.state.vis_t_minus, self._stage_scalars(1.0)
        loss = self._loss_fn
        w0, split = self._flat_state()

        def value_and_grad(w):
            # under a process group: the rank's local sums, then the value
            # and the gradient summed over the ranks in one collective, so
            # the line search decides alike on every rank
            w = w.detach().requires_grad_(True)
            total, _ = loss(split(w), batch, vtm, sc)
            (g,) = torch.autograd.grad(total, [w])
            g, total = reduce_flat([g, total.detach()], self.group)
            return total, g

        t0 = time.time()

        def progress(done, last_loss):
            if done % 200 == 0:
                self.logger.info(f"[L-BFGS] step {done}/{num_steps}  loss={last_loss:.3e}  "
                                 f"({done / max(time.time() - t0, 1e-9):.2f} it/s)")

        with _exact_fp32():
            res = run_lbfgs(value_and_grad, w0, num_steps,
                            max_chunk=max(1, self.max_chunk // 40), progress=progress,
                            guard=_defer_sigterm)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        seconds = time.time() - t0
        self._install_flat(res.params)
        self.global_step += len(res.history)
        self.polish_stats = {"optimizer": "lbfgs", "steps": len(res.history),
                             "history": res.history, "evaluations": res.evaluations,
                             "seconds": seconds}
        self.logger.info(f"[L-BFGS] {num_steps} steps in {seconds:.1f}s  loss "
                         f"{res.history[0]:.3e} -> {res.history[-1]:.3e}")
        return self.state

    def train_lm(self, num_steps: int, cg_iters: int = 50, microbatches: Optional[int] = None):
        """Levenberg-Marquardt (matrix-free Gauss-Newton-CG) polish of both
        nets (training/lm.py; the JAX package's train_lm), vis_t carry
        frozen, on the closed-form residual in exact fp32. microbatches > 1
        (default `lm_microbatches`) sums every Gauss-Newton product over that
        many collocation slices, zero-padded to equal length: ~K-fold lower
        peak memory, the same math. Chunks of max(1, max_chunk //
        (2 cg_iters + 4)) steps, or // (3 cg_iters + 8) sliced; the state is
        replaced when the stage ends, as in train_lbfgs."""
        if self.loss_mode != "MSE":
            raise ValueError("the LM polish minimises the MSE loss; loss_mode is "
                             f"{self.loss_mode!r}")
        self._ensure_ready()
        residual = make_residual_fn(
            engine=self._engine("xla"), apply_main=self._uvp_apply(),
            apply_evm=self._apply_evm() if self.evm else None,
            coord_scale=self.coord_scale, alpha_e=self.alpha_e, alpha_s=self.alpha_s,
            entropy_weight=self.entropy_residual_weight, evm=self.evm)
        batch, vtm, sc = self._batch, self.state.vis_t_minus, self._stage_scalars(1.0)
        w0, split = self._flat_state()
        t0 = time.time()

        def progress(done, last_loss, lam):
            self.logger.info(f"[LM] step {done}/{num_steps}  loss={last_loss:.3e}  lam={lam:.1e}  "
                             f"({done / max(time.time() - t0, 1e-9):.2f} it/s)")

        micro = int(microbatches if microbatches is not None else self.lm_microbatches)
        reduce = None if self.group is None else (
            lambda t: pmesh.all_reduce_sum_(t.contiguous(), self.group))
        with _exact_fp32():
            if micro > 1:
                # pad rows carry eq_w = 0: zero residual rows; the global n_f
                # keeps the rows scaled as in the unsliced vector (a vanilla
                # solver has no carry: its slices hold zeros, unread)
                carry = vtm if vtm is not None else torch.zeros_like(batch.x_f)
                slices = stack_slices([batch.x_f, batch.y_f, batch.eq_w, carry], micro)
                eq_fn, aux_fn = residual.eq_residual_fn, residual.aux_residual_fn
                w, history, lam = run_lm_micro(
                    lambda w_, sl: eq_fn(split(w_), *sl, batch.n_f, sc),
                    lambda w_: aux_fn(split(w_), batch, sc), slices, w0, num_steps,
                    cg_iters=cg_iters, max_chunk=max(1, self.max_chunk // (3 * cg_iters + 8)),
                    progress=progress, guard=_defer_sigterm, reduce=reduce)
            else:
                w, history, lam = run_lm(
                    lambda w_: residual(split(w_), batch, vtm, sc), w0, num_steps,
                    cg_iters=cg_iters, max_chunk=max(1, self.max_chunk // (2 * cg_iters + 4)),
                    progress=progress, guard=_defer_sigterm, reduce=reduce)
        history = history.tolist()
        seconds = time.time() - t0
        self._install_flat(w)
        self.global_step += len(history)
        self.polish_stats = {"optimizer": "lm", "steps": len(history), "history": history,
                             "lam": lam, "microbatches": micro, "cg_iters": cg_iters,
                             "seconds": seconds}
        self.logger.info(f"[LM] {num_steps} steps in {seconds:.1f}s  loss "
                         f"{history[0]:.3e} -> {history[-1]:.3e}")
        return self.state

    def residuals_at(self, x, y, chunk: int = 32768) -> np.ndarray:
        """Per-point PDE residual magnitude sqrt(eq1^2 + eq2^2 + eq3^2) at
        host points under the current nets, the EVM viscosity included
        (nsfnet_tpu/training/solver.py:978-1019): the score of residual-aware
        resampling. Plain PyTorch in exact fp32 by the closed-form engine, in
        fixed-size zero-padded chunks (one shape for every call)."""
        xh = np.asarray(x, np.float32).reshape(-1)
        yh = np.asarray(y, np.float32).reshape(-1)
        n = xh.shape[0]
        out = np.empty((n,), np.float32)
        engine, re = self._engine("xla"), self.current_re
        seg = torch.zeros((chunk, 2), dtype=torch.float32, device=self.device)
        with torch.no_grad(), _exact_fp32():
            for lo in range(0, n, chunk):
                hi = min(lo + chunk, n)
                seg.zero_()
                seg[: hi - lo, 0] = torch.from_numpy(xh[lo:hi])
                seg[: hi - lo, 1] = torch.from_numpy(yh[lo:hi])
                derivs = engine(self.state.params, seg)
                if self.evm:
                    e = self.net_1(seg)[:, 0:1]
                    vis_t = torch.clamp(self.alpha_evm * e.abs(), max=20.0 / re)
                    r = R.ev_ns_residuals(derivs, e, vis_t, re, self.coord_scale)
                else:
                    r = R.ns_residuals(derivs, re, self.coord_scale)
                score = torch.sqrt(r.eq1 ** 2 + r.eq2 ** 2 + r.eq3 ** 2)[:, 0]
                out[lo:hi] = score[: hi - lo].cpu().numpy()
        return out

    # ------------------------------------------------------------ inference

    def _host_points(self, x, y) -> torch.Tensor:
        """Host coordinate arrays -> [N,2] float32 points on the device."""
        return torch.cat([torch.as_tensor(np.asarray(x, np.float32).reshape(-1, 1)),
                          torch.as_tensor(np.asarray(y, np.float32).reshape(-1, 1))],
                         dim=1).to(self.device)

    def neural_net_u(self, x, y):
        """(u, v, p, e) tensors at host points, in full fp32
        (parity: ev-NSFnet/pinn_solver.py:280-288)."""
        pts = self._host_points(x, y)
        with torch.no_grad(), _exact_fp32():
            uvp = self._uvp_apply()(self.state.params, pts)
            e = self.net_1(pts)[:, 0:1] if self.evm else torch.zeros_like(pts[:, 0:1])
        return uvp[:, 0:1], uvp[:, 1:2], uvp[:, 2:3], e

    def predict(self, X):
        x, y = X
        return self.neural_net_u(x, y)

    def divergence(self, x, y):
        """Continuity residual u_x + v_y at host points, by the closed-form
        engine (the reference's divergence() is dead code,
        NSFnet/pinn_solver.py:382-389; this is the working equivalent)."""
        pts = self._host_points(x, y)
        with torch.no_grad(), _exact_fp32():
            derivs = self._engine("xla")(self.state.params, pts)
            return R.ns_residuals(derivs, self.current_re, self.coord_scale).eq3

    def attach_eval_data(self, fields) -> None:
        """Register the DNS evaluation fields (x, y, u, v, p arrays) so that
        the stall detector can track the field error instead of the equation
        loss (stall_metric='eval_error')."""
        self._eval_fields = fields

    def evaluate(self, x, y, u, v, p, log: bool = True):
        """Relative L2 % errors vs DNS (parity: ev-NSFnet/pinn_solver.py:669-693)."""
        u_pred, v_pred, p_pred, _ = (a.cpu().numpy().astype(np.float64)
                                     for a in self.neural_net_u(x, y))
        u_t, v_t, p_t = (np.asarray(a, np.float64).reshape(-1, 1) for a in (u, v, p))
        mask = ~np.isnan(p_t)
        err = lambda t, q: 100.0 * np.linalg.norm(t - q) / np.linalg.norm(t)
        # p is defined up to a constant: report the raw error and the one
        # with the best-fit constant removed
        shift = float(np.mean(p_t[mask] - p_pred[mask]))
        errors = {
            "u": err(u_t, u_pred),
            "v": err(v_t, v_pred),
            "p": err(p_t[mask], p_pred[mask]),
            "p_gauge": err(p_t[mask], p_pred[mask] + shift),
            "p_shift": shift,
        }
        if log:
            self.logger.info(
                "Error u: %.3f %%  v: %.3f %%  p: %.3f %% (gauge-corrected %.3f %%, "
                "shift %.4f)" % (errors["u"], errors["v"], errors["p"],
                                 errors["p_gauge"], shift))
        return errors

    def test(self, x, y, u, v, p, loop=None, save_dir=None):
        """Predict the full grid, report the errors and write
        `cavity_result_loop_{loop}.mat` (parity: ev-NSFnet/pinn_solver.py:695-740;
        nsfnet_tpu/training/solver.py:1049-1083): U/V/P/E_pred on the square
        grid, the errors, lam_bcs and lam_equ; PSI_pred, the raw net's psi,
        under the streamfunction formulation."""
        import scipy.io

        errors = self.evaluate(x, y, u, v, p)
        side = int(round(np.sqrt(np.asarray(x).size)))
        grid = lambda t: t.cpu().numpy().reshape(side, side)
        u_pred, v_pred, p_pred, e_pred = self.neural_net_u(x, y)
        extra = {}
        if self.formulation == "streamfunction":
            with torch.no_grad(), _exact_fp32():
                extra["PSI_pred"] = grid(self.net(self._host_points(x, y))[:, 0])
        if self.rank != 0:  # one writer per run
            return errors
        out_dir = save_dir or os.path.join(self.checkpoint_path, f"Re{self.Re:g}", "test_result")
        os.makedirs(out_dir, exist_ok=True)
        scipy.io.savemat(os.path.join(out_dir, f"cavity_result_loop_{loop}.mat"), {
            **extra,
            "U_pred": grid(u_pred), "V_pred": grid(v_pred), "P_pred": grid(p_pred),
            "E_pred": grid(e_pred),
            "error_u": errors["u"], "error_v": errors["v"], "error_p": errors["p"],
            "error_p_gauge": errors["p_gauge"],
            "lam_bcs": self.alpha_b, "lam_equ": self.alpha_e,
        })
        return errors

    # ---------------------------------------------------------- persistence

    def _ckpt_dir(self) -> str:
        """Directory-name parity with ev-NSFnet/pinn_solver.py:742-747."""
        nn = f"{self.layers}x{self.hidden_size}_Nf{int(self.N_f / 1000)}k"
        lam = f"lamB{self.alpha_b:g}_alpha{self.alpha_evm:g}{self.current_stage}"
        return os.path.join(self.checkpoint_path, f"Re{self.Re:g}", f"{nn}_{lam}")

    def _arch(self) -> dict:
        """The architecture stamp of the sidecar: the JAX package's keys, and
        what its keys leave out (a KAN's width, grid and k; a Fourier net's
        embedding size and the sigma its B is rebuilt from)."""
        arch = {"backbone": self.backbone, "layers": self.layers,
                "hidden_size": self.hidden_size,
                "layers_1": self.layers_1 if self.evm else None,
                "hidden_size_1": self.hidden_size_1 if self.evm else None}
        if self.backbone == "kan":
            arch.update(kan_width=list(self.net.width), kan_grid=self.net.grid,
                        kan_k=self.net.k)
        elif self.net.fourier_features:
            arch.update(fourier_features=self.net.fourier_features,
                        fourier_sigma=self.net.fourier_sigma)
        return arch

    def _metadata(self) -> dict:
        """The JAX package's sidecar keys (nsfnet_tpu/training/solver.py:1129-1147)."""
        meta = {"global_step": self.global_step, "Re": self.Re,
                "alpha_evm": self.alpha_evm, "alpha_b": self.current_alpha_b,
                "stage": self.current_stage, "formulation": self.formulation,
                **{k: v for k, v in self._arch().items() if v is not None}}
        if self.dataset is not None:
            meta["sampler"] = self.dataset.get_state()
        return meta

    def save(self, filename: str, directory: Optional[str] = None) -> str:
        """Write the full train state (torch.save) and its JSON sidecar,
        atomically (training/checkpoint.save_state). Under a process group
        every rank must call it: the vis_t carry is gathered from all ranks,
        rank 0 alone writes, and a barrier holds every rank until the file
        is there; every rank gets the path back, so a rollback or resume
        reads the same file everywhere (nsfnet_tpu/training/solver.py:
        1113-1130)."""
        path = os.path.join(directory or self._ckpt_dir(), filename)
        s = self.state
        vtm = s.vis_t_minus
        if self.group is not None and vtm is not None:
            vtm = pmesh.gather_rows(vtm, self.group)
        if self.rank == 0:
            self._write(path, vtm)
        if self.group is not None:
            import torch.distributed as dist

            dist.barrier(group=self.group)
        return path

    def _write(self, path: str, vis_t_minus) -> None:
        s = self.state
        adam = lambda o: None if o is None else {"mu": o.mu, "nu": o.nu, "count": o.count}
        blob = {
            "params": s.params.detach(),
            "params_evm": None if s.params_evm is None else s.params_evm.detach(),
            "opt_main": adam(s.opt_main),
            "opt_evm": adam(s.opt_evm),
            "vis_t_minus": vis_t_minus,
            "step": s.step,
            "epoch_in_stage": s.epoch_in_stage,
        }
        ckpt.save_state(path, blob, self._metadata())
        if self.loss_history:  # the logged losses so far, beside the checkpoint
            import scipy.io

            hist = np.asarray([(step, m.total, m.equation, m.boundary, m.eq1, m.eq2, m.eq3,
                                m.eq4) for step, m in self.loss_history], dtype=np.float64)
            scipy.io.savemat(
                os.path.join(os.path.dirname(path), "eq_losses.mat"),
                {"step": hist[:, 0], "total": hist[:, 1], "eq": hist[:, 2],
                 "bc": hist[:, 3], "eq1": hist[:, 4], "eq2": hist[:, 5],
                 "eq3": hist[:, 6], "eq4": hist[:, 7]})

    def _read_state(self, path: str):
        """(TrainState, metadata, main leaf shapes or None, EVM leaf shapes
        or None) of a checkpoint in either format. The port's flat vectors
        carry no shapes and its sidecar is its only metadata, so a port file
        needs it; a JAX file's shapes and backbone come from its state (the
        backbone overrides the sidecar's)."""
        meta = ckpt.load_metadata(path)
        if ckpt.is_flax_msgpack(path):
            state, shapes, shapes_evm, backbone = convert.train_state_from_jax(
                ckpt.read_flax_msgpack(path), self.device)
            return state, {**(meta or {}), "backbone": backbone}, shapes, shapes_evm
        if meta is None:
            raise ValueError(f"checkpoint {path} has no sidecar {path}.json (the port "
                             f"writes its step, stage and architecture there)")
        blob = torch.load(path, map_location=self.device, weights_only=True)
        adam = lambda o: None if o is None else AdamState(o["mu"], o["nu"], int(o["count"]))
        state = TrainState(params=blob["params"], params_evm=blob["params_evm"],
                           opt_main=adam(blob["opt_main"]), opt_evm=adam(blob["opt_evm"]),
                           vis_t_minus=blob["vis_t_minus"], step=int(blob["step"]),
                           epoch_in_stage=int(blob["epoch_in_stage"]))
        return state, meta, None, None

    def load(self, path: str):
        """Restore a full-state checkpoint (exact resume): the port's own, or
        the JAX package's (nsfnet_tpu/training/solver.py:1160-1231).
        Guards: the formulation, the architecture stamped in the metadata
        (the keys it has: the backbone, a KAN's width, grid and k, a Fourier
        net's embedding size and sigma; the JAX package stamps neither), and the shapes of the state itself (every
        leaf of a JAX state: a KAN's coef and w_base, a Fourier net's first
        fan_in). The carry
        keeps the first N_f rows of the writer's (its padding differs), and
        is recomputed from the restored EVM net where the writer had fewer
        points. Every rank reads the file and keeps its own block of the
        carry."""
        state, meta, sizes, sizes_evm = self._read_state(path)
        theirs = meta.get("formulation", "velocity")  # no stamp: written before the option
        if theirs != self.formulation:
            # the shapes of the two heads can coincide; the quantities do not
            raise ValueError(f"checkpoint {path} was written by a {theirs!r}-formulation "
                             f"solver; this solver is {self.formulation!r} (the heads "
                             f"predict different quantities)")
        mine = {"fourier_features": 0, **self._arch()}
        bad = {k: (meta[k], v) for k, v in mine.items() if k in meta and meta[k] != v}
        evm_shapes = self.net_1.leaf_shapes() if self.evm else None
        if (sizes is not None and tuple(sizes) != self.net.leaf_shapes()) \
                or (sizes_evm is not None and tuple(sizes_evm) != evm_shapes):
            bad["shapes"] = ((sizes, sizes_evm), (self.net.leaf_shapes(), evm_shapes))
        if state.params.numel() != self.net.flat.numel() \
                or (state.params_evm is None) == self.evm \
                or (self.evm and state.params_evm.numel() != self.net_1.flat.numel()):
            bad["parameter count"] = (
                (state.params.numel(), None if state.params_evm is None
                 else state.params_evm.numel()),
                (self.net.flat.numel(), self.net_1.flat.numel() if self.evm else None))
        if bad:
            raise ValueError(f"checkpoint {path} architecture does not match this "
                             f"solver: {bad} (checkpoint, solver); train.py --init-from "
                             f"warm-starts across widths")
        with torch.no_grad():
            self.state.params.copy_(state.params)
            if self.evm:
                self.state.params_evm.copy_(state.params_evm)
        self.state.opt_main = state.opt_main
        if self.evm:
            self.state.opt_evm = state.opt_evm
        self.state.step = state.step
        self.state.epoch_in_stage = state.epoch_in_stage
        self.global_step = int(meta.get("global_step", self.global_step))
        self.current_stage = meta.get("stage", self.current_stage)
        if "alpha_b" in meta:
            self.current_alpha_b = float(meta["alpha_b"])
        vtm = state.vis_t_minus
        if vtm is not None and self._eq is not None:
            n_f = self._eq[0].shape[0]
            if vtm.shape[0] < n_f:
                self.logger.warning(
                    f"restored vis_t carry has {vtm.shape[0]} rows < {n_f} collocation "
                    f"points: recomputing it from the restored EVM net")
                self._init_vis_t()
                rows = torch.from_numpy(self._vis_t_init).to(self.device)
            else:
                rows = vtm[:n_f]
            pad = self._eq_pad_size(n_f) - n_f
            vtm = self._shard(torch.cat([rows, rows.new_full((pad, 1), self.vis_t0)]))
            self._vis_stale = False
            self._dirty = True
        self.state.vis_t_minus = vtm

    def _require_fcnet(self, what: str, velocity: bool = True):
        if self.backbone != "mlp" or self.net.fourier_features or (
                velocity and self.formulation != "velocity"):
            raise ValueError(f".pth {what} requires the plain velocity-formulation MLP "
                             f"(the reference's FCNet predicts (u, v, p) directly)")

    def save_torch(self, path: str) -> str:
        """Write the live nets as reference-format `.pth` state_dicts: the
        main net at `path`, the EVM net at `<path>_evm`
        (nsfnet_tpu/training/solver.py:1233-1249), so they replay in the
        reference's tooling (ev-NSFnet/test.py:27-99)."""
        self._require_fcnet("export")
        return ti.save_torch_params(self.params(), path, self.params_evm())

    def load_torch(self, net_params: str, net_params_1: Optional[str] = None):
        """Import reference-format `.pth` state_dicts (the published
        checkpoints, ev-NSFnet/pinn_solver.py:108-120) into the live nets:
        params only, fresh optimizer moments and a carry from the imported
        EVM net, as a reference restart (nsfnet_tpu/training/solver.py:
        1251-1310). Without `net_params_1` the `<net_params>_evm` sibling is
        read where it exists."""
        self._require_fcnet("import", velocity=False)
        params = ti.load_torch_params(net_params)
        expect = tuple(w for w, _ in self.net.leaf_shapes())
        if ti.params_shapes(params) != expect:
            raise ValueError(f"imported net shapes {ti.params_shapes(params)} != configured "
                             f"{expect} — check layers/hidden_size against the checkpoint's "
                             f"architecture")
        params_evm = None
        if self.evm:
            if net_params_1 is None and os.path.exists(net_params + "_evm"):
                net_params_1 = net_params + "_evm"
            if not net_params_1 and self.rank == 0:
                self.logger.warning(
                    f"no EVM state_dict given and {net_params}_evm does not exist — the "
                    f"EVM net keeps its random initialization (vis_t / Re_eff are "
                    f"meaningless until it trains)")
            if net_params_1:
                params_evm = ti.load_torch_params(net_params_1)
                expect_e = tuple(w for w, _ in self.net_1.leaf_shapes())
                if ti.params_shapes(params_evm) != expect_e:
                    raise ValueError(f"imported EVM shapes {ti.params_shapes(params_evm)} "
                                     f"!= configured {expect_e}")
        dev = lambda p: tuple((w.to(self.device), b.to(self.device)) for w, b in p)
        self.set_params(dev(params), dev(params_evm) if params_evm is not None else None)
        if self.rank == 0:
            self.logger.info(f"imported torch params from {net_params}"
                             + (f" + {net_params_1}" if net_params_1 else ""))

    # --------------------------------------------------------------- logging

    def _print_log(self, m: StepMetrics, done, num_epoch, avg_it_s, interval_it_s,
                   pts_per_step, stage_elapsed, total_elapsed, lr, chunks):
        """`chunks`: the interval's chunk records (utils/profiling.py). The
        host's ms a step is the median `step` span at steps 2-4 of each
        chunk, before a full launch queue makes the host wait on the card;
        the card's is the chunks' CUDA-event time over their steps."""
        self.loss_history.append((self.global_step, m))
        steps = sum(c.n_steps for c in chunks)
        head = profiling.head_steps(since=chunks[0].id - 1) if chunks else []
        host_ms = statistics.median(head) / 1e6 if head else None
        device_ms = (sum(c.device_ns for c in chunks) / steps / 1e6
                     if steps and all(c.device_ns is not None for c in chunks) else None)
        ms = lambda v: "n/a" if v is None else f"{v:.3f} ms/step"
        re_now = self.current_re
        re_eff = 1.0 / (1.0 / re_now + m.vis_t_mean) if self.evm else re_now
        throughput = interval_it_s * pts_per_step
        eta = (num_epoch - done) / max(interval_it_s, 1e-9)
        width = 30
        filled = int(done / num_epoch * width)
        bar = "#" * filled + " " * (width - filled)
        self.logger.info(
            f"[{self.current_stage}] {done:>7d}/{num_epoch:<7d} "
            f"{done / num_epoch * 100:6.2f}% |{bar}|")
        self.logger.info(
            f"  loss: total={m.total:.3e} eq={m.equation:.3e} "
            f"bc={m.boundary:.3e} sup={m.supervised:.3e}")
        self.logger.info(
            f"        eq1={m.eq1:.2e} eq2={m.eq2:.2e} eq3={m.eq3:.2e} eq4={m.eq4:.2e}")
        self.logger.info(
            f"  time: stage={stage_elapsed:.1f}s total={total_elapsed:.1f}s "
            f"it/s={avg_it_s:.2f} (interval {interval_it_s:.2f}) eta={eta:.0f}s")
        mem = ""
        if self.device.type == "cuda":
            mem = f" mem={torch.cuda.memory_allocated(self.device) / 1024**2:.0f}MB"
        self.logger.info(
            f"  perf: throughput={throughput:,.0f} pts/s host={ms(host_ms)} "
            f"device={ms(device_ms)} lr={lr:.2e} "
            f"Re_eff={re_eff:.1f} alpha_evm={self.alpha_evm}{mem}")
        if self.tb_writer is not None:
            w, s = self.tb_writer, self.global_step
            w.add_scalar("loss/total", m.total, s)
            w.add_scalar("loss/boundary", m.boundary, s)
            w.add_scalar("loss/eq_total", m.equation, s)
            w.add_scalar("loss/eq1", m.eq1, s)
            w.add_scalar("loss/eq2", m.eq2, s)
            w.add_scalar("loss/eq3", m.eq3, s)
            w.add_scalar("loss/eq4_entropy", m.eq4, s)
            w.add_scalar("loss/supervision", m.supervised, s)
            w.add_scalar("physics/Re_eff", re_eff, s)
            w.add_scalar("physics/alpha_evm", self.alpha_evm, s)
            w.add_scalar("perf/throughput_pts_per_s", throughput, s)
            w.add_scalar("perf/avg_iter_s", avg_it_s, s)
            w.add_scalar("perf/interval_iter_s", interval_it_s, s)
            if host_ms is not None:
                w.add_scalar("perf/host_ms_per_step", host_ms, s)
            if device_ms is not None:
                w.add_scalar("perf/device_ms_per_step", device_ms, s)
            w.add_scalar("lr", lr, s)

