"""Configuration system: YAML -> nested dataclasses.

The PyTorch port's own copy of the JAX package's schema (nsfnet_tpu/config.py),
field for field, so every config in configs/ parses the same way in both
packages; the port's driver runs every field of every config there.
`mesh_devices` is the world size the run must have (one process per card,
under torchrun), where the JAX package makes a mesh of that many devices.
`yaml` is imported only inside `from_file`: build a config with
`ConfigManager.from_dict` where PyYAML is missing.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class PhysicsConfig:
    Re: float = 5000.0
    alpha_evm: float = 0.05
    bc_weight: float = 10.0
    eq_weight: float = 1.0
    entropy_residual_weight: float = 0.1  # the 0.1*eq4 factor (pinn_solver.py:397)


@dataclass
class NetworkConfig:
    backbone: str = "mlp"  # mlp | kan
    # velocity (reference parity: the net predicts u,v,p) | streamfunction
    # (net predicts psi,p with u=psi_y, v=-psi_x — continuity EXACT by
    # construction; third-order Taylor engine, XLA path, MLP only)
    formulation: str = "velocity"
    layers: int = 6
    layers_1: int = 4
    hidden_size: int = 80
    hidden_size_1: int = 40
    fourier_features: int = 0   # random Fourier input embedding (0 = off)
    fourier_sigma: float = 3.0
    # KAN-specific (physics_informed_kan.ipynb cell 0)
    kan_width: List[int] = field(default_factory=lambda: [2, 16, 16, 8])
    kan_grid: int = 5
    kan_k: int = 3


@dataclass
class TrainingStage:
    alpha: float
    epochs: int
    lr: float
    name: str = "Stage"
    optimizer: str = "adam"  # adam | lbfgs | lm (polish stages)
    # Stall-aware advance (an improvement on the reference's fixed
    # 6-stage schedule, production.yaml:14-27): end the stage early once the
    # equation loss stops improving, so a fixed wall-clock budget reaches
    # the deep-anneal stages instead of over-training an exhausted one.
    # The Re=4000 post-mortem showed the opposite failure too (annealing
    # OUTPACING convergence) — min_epochs guards the floor.
    advance_on_stall: bool = False
    # Per-stage physics overrides (0 = inherit physics.Re / physics.bc_weight).
    # Re/bc_weight are runtime scalars in the jitted step, so a staged-Re
    # continuation curriculum (e.g. anneal Re 4000 -> 5000 from a converged
    # lower-Re solution) or boundary-weight annealing never retraces.
    Re: float = 0.0
    bc_weight: float = 0.0
    # Never advance before this many epochs. -1 (default) derives a floor of
    # epochs // 4 for advance_on_stall stages: the Re=5000 gentle campaign
    # lost its S1/S2 budget to a loose detector (advanced at 90k/130k of
    # 120k/200k and locked in the flow structure — VALIDATION.md postmortem),
    # so an unset floor must not mean "no floor". Explicit 0 opts out.
    stall_min_epochs: int = -1

    def resolved_stall_min(self) -> int:
        """The effective stall floor: explicit value, or epochs//4 when
        advance_on_stall is set and the config left the floor unset."""
        if self.stall_min_epochs >= 0:
            return self.stall_min_epochs
        return self.epochs // 4 if self.advance_on_stall else 0


@dataclass
class SupervisionConfig:
    enabled: bool = False
    num_samples: int = 0
    loss_weight: float = 1.0


@dataclass
class SDFWeightConfig:
    enabled: bool = False
    min_weight: float = 0.2
    decay: float = 5.0


@dataclass
class TrainingConfig:
    N_f: int = 120000
    log_interval: int = 1000
    enable_tensorboard: bool = True
    tb_log_dir: str = "runs"
    sort_training_points: bool = True
    sdf_weighting: SDFWeightConfig = field(default_factory=SDFWeightConfig)
    coordinate_transform: bool = False
    checkpoint_freq: int = 10000
    checkpoint_dir: str = "results"
    seed: int = 42
    # highest | high | default: the kernels' bf16 tensor-core passes per fp32
    # product (6 | 3 | 1); the CPU entry points and the closed-form polish
    # and evaluation paths compute exact fp32 whatever the name.
    matmul_precision: str = "high"
    evm_update_freq: int = 10000  # EVM net trains once per this many steps
    mesh_devices: Optional[int] = None  # None = any world size (JAX: all local devices)
    microbatches: int = 1  # gradient-accumulation microbatches (N_f > HBM)
    lm_microbatches: int = 1  # LM Gauss-Newton product slicing (memory)
    loss_mode: str = "MSE"  # MSE | L2 (NSFnet/pinn_solver.py:201-218)
    resample_each_stage: bool = False  # draw fresh collocation points per stage
    # Residual-aware resampling (RAR) for resample_each_stage: 0 = plain
    # uniform redraw; >0 = each per-stage redraw scores a rar_pool_mult x
    # N_f candidate pool with the current nets' PDE residual and keeps the
    # worst rar_top_frac x N_f points (fresh uniform fill for the rest).
    rar_pool_mult: int = 0
    rar_top_frac: float = 0.5
    # When RAR fires: "first" (default) = only the FIRST per-stage redraw of
    # the run (stage index 1), "every" = every redraw. Measured (VALIDATION.md
    # Re=5000 continuation postmortem + scripts/rar_polish.py at Re=2000):
    # RAR helps the first redraw after a warm start and costs ~+1.8 error
    # points per stage thereafter — repeated residual-chasing redraws random-
    # walk a converged solution. Later redraws fall back to plain uniform.
    rar_schedule: str = "first"
    # stall detector for stages with advance_on_stall: relative improvement
    # of the stall metric across `stall_window` consecutive log intervals
    # below `stall_threshold` -> advance to the next stage
    stall_threshold: float = 0.02
    stall_window: int = 3
    # What the detector tracks. "eq_loss" (default) = the equation loss at
    # log boundaries; "eval_error" = mean u/v relative-L2 %% vs the attached
    # DNS field (requires eval_data; falls back to eq_loss with a warning
    # otherwise). Use eval_error for late-campaign polish stages: at the
    # ~1e-6 loss plateau the eq-loss track is flat even while the field
    # error descends linearly, so eq_loss false-fires there — the ext2 X2
    # stage lost its 3e-6 bulk to a 0.24%% eq-loss gain while the error was
    # dropping -0.12 pts/25k epochs (VALIDATION.md, round 4).
    stall_metric: str = "eq_loss"
    # Gradient-pathology loss balancing (Wang/Teng/Perdikaris 2021; PAPERS.md
    # "Stabilized Adaptive Loss"): at every log boundary, re-weight the
    # boundary loss toward lambda_bc ~ ||grad L_eq|| / ||grad L_bc|| with an
    # EMA — replaces the reference's hand-tuned fixed bc_weight=10. The
    # probe runs OUTSIDE the jitted scan (one extra backward per
    # log_interval steps, amortized ~0%), and bc_weight is already a
    # runtime scalar, so updates never retrace.
    adaptive_bc_weight: bool = False
    adaptive_bc_ema: float = 0.9       # EMA retention per update
    adaptive_bc_max: float = 1000.0    # clip for the target ratio
    # Most steps queued between two host syncs (a chunk also ends at each
    # log boundary).
    max_chunk: int = 2000
    training_stages: List[TrainingStage] = field(default_factory=lambda: [
        TrainingStage(0.05, 500000, 1e-3, "Stage 1"),
        TrainingStage(0.03, 500000, 2e-4, "Stage 2"),
        TrainingStage(0.01, 500000, 4e-5, "Stage 3"),
        TrainingStage(0.005, 500000, 1e-5, "Stage 4"),
        TrainingStage(0.002, 500000, 2e-6, "Stage 5"),
        TrainingStage(0.002, 500000, 2e-6, "Stage 6"),
    ])


@dataclass
class AppConfig:
    physics: PhysicsConfig = field(default_factory=PhysicsConfig)
    network: NetworkConfig = field(default_factory=NetworkConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    supervision: SupervisionConfig = field(default_factory=SupervisionConfig)
    model_variant: str = "ev-nsfnet"  # nsfnet | ev-nsfnet | kan
    experiment_name: str = "NSFnet_TPU"
    description: str = "TPU-native PINN cavity solver"
    eval_data: str = ""  # path to DNS .mat; empty = skip evaluation


def _merge_section(obj, data: dict, path: str = "",
                   unknown: Optional[List[str]] = None):
    """Merge YAML keys onto a dataclass. Keys that match no field are
    collected into `unknown` — a typo'd key must warn, not silently train
    the default curriculum (the reference merges silently,
    ev-NSFnet/config.py:73-142; validate() there is never even called)."""
    for k, v in (data or {}).items():
        if not hasattr(obj, k):
            if unknown is not None:
                unknown.append(f"{path}{k}")
        elif not isinstance(getattr(obj, k), (SDFWeightConfig, list)):
            setattr(obj, k, v)
        # SDFWeightConfig / list fields are merged by dedicated handlers


class ConfigManager:
    """YAML loader with field-by-field merge over defaults
    (shape parity with ev-NSFnet/config.py:69-142)."""

    def __init__(self, config: Optional[AppConfig] = None,
                 unknown_keys: Optional[List[str]] = None):
        self.config = config or AppConfig()
        self.unknown_keys: List[str] = unknown_keys or []

    @classmethod
    def from_file(cls, path: str) -> "ConfigManager":
        import yaml

        with open(path, "r", encoding="utf-8") as f:
            data = yaml.safe_load(f) or {}
        return cls.from_dict(data)

    @classmethod
    def from_dict(cls, data: dict) -> "ConfigManager":
        cfg = AppConfig()
        unknown: List[str] = []
        _merge_section(cfg.physics, data.get("physics"), "physics.", unknown)
        _merge_section(cfg.network, data.get("network"), "network.", unknown)
        if "network" in data and "kan_width" in (data["network"] or {}):
            cfg.network.kan_width = [int(w) for w in data["network"]["kan_width"]]
        tr = data.get("training") or {}
        _merge_section(cfg.training, tr, "training.", unknown)
        if "sdf_weighting" in tr:
            _merge_section(cfg.training.sdf_weighting, tr["sdf_weighting"],
                           "training.sdf_weighting.", unknown)
        if "training_stages" in tr:
            stages = []
            stage_keys = {"alpha", "epochs", "lr", "name", "optimizer",
                          "advance_on_stall", "stall_min_epochs", "Re",
                          "bc_weight"}
            for i, st in enumerate(tr["training_stages"], 1):
                if isinstance(st, dict):
                    for k in st:
                        if k not in stage_keys:
                            unknown.append(f"training.training_stages[{i}].{k}")
                    stages.append(TrainingStage(
                        alpha=float(st["alpha"]),
                        epochs=int(st["epochs"]),
                        lr=float(st["lr"]),
                        name=str(st.get("name", "Stage")),
                        optimizer=str(st.get("optimizer", "adam")),
                        advance_on_stall=bool(st.get("advance_on_stall", False)),
                        stall_min_epochs=int(st.get("stall_min_epochs", -1)),
                        Re=float(st.get("Re", 0.0)),
                        bc_weight=float(st.get("bc_weight", 0.0)),
                    ))
                elif isinstance(st, (list, tuple)) and len(st) >= 4:
                    stages.append(TrainingStage(
                        float(st[0]), int(st[1]), float(st[2]), str(st[3])))
            if stages:
                cfg.training.training_stages = stages
        _merge_section(cfg.supervision, data.get("supervision"),
                       "supervision.", unknown)
        scalar_keys = ("model_variant", "experiment_name", "description",
                       "eval_data")
        for key in scalar_keys:
            if key in data:
                setattr(cfg, key, data[key])
        known_top = set(scalar_keys) | {"physics", "network", "training",
                                        "supervision"}
        unknown.extend(k for k in data if k not in known_top)
        return cls(cfg, unknown_keys=unknown)

    def validate(self) -> List[str]:
        warnings = []
        c = self.config
        for k in self.unknown_keys:
            warnings.append(f"unknown config key {k!r} (would be silently "
                            f"ignored — typo?)")
        if c.physics.Re <= 0:
            warnings.append("Re must be > 0")
        if c.training.N_f <= 0:
            warnings.append("N_f must be > 0")
        if c.model_variant not in ("nsfnet", "ev-nsfnet", "kan"):
            warnings.append(f"unknown model_variant {c.model_variant!r}")
        if c.network.formulation not in ("velocity", "streamfunction"):
            warnings.append(f"unknown network.formulation "
                            f"{c.network.formulation!r}")
        elif c.network.formulation == "streamfunction" \
                and (c.network.backbone != "mlp"
                     or c.model_variant == "kan"):
            # model_variant: kan forcibly maps to backbone='kan' in
            # build_solver — catch it here, not as a raw constructor error
            warnings.append("formulation: streamfunction requires the MLP "
                            "backbone")
        if c.training.rar_pool_mult < 0:
            warnings.append("rar_pool_mult must be >= 0 (0 = off)")
        if c.training.rar_pool_mult > 0:
            if not 0.0 < c.training.rar_top_frac <= 1.0:
                warnings.append("rar_top_frac must be in (0, 1]")
            if not c.training.resample_each_stage:
                warnings.append("rar_pool_mult > 0 has no effect without "
                                "resample_each_stage: true")
        if c.training.rar_schedule not in ("first", "every"):
            warnings.append(f"unknown rar_schedule "
                            f"{c.training.rar_schedule!r} (first | every)")
        if c.training.max_chunk < 1:
            warnings.append("max_chunk must be >= 1 (steps per device "
                            "dispatch; 0 would spin the train loop forever)")
        if not 0.0 <= c.training.adaptive_bc_ema < 1.0:
            warnings.append("adaptive_bc_ema must be in [0, 1) — values "
                            ">= 1 make the bc-weight EMA diverge")
        if c.training.stall_window < 1:
            warnings.append("stall_window must be >= 1 log intervals")
        if c.training.stall_metric not in ("eq_loss", "eval_error"):
            warnings.append(f"unknown stall_metric "
                            f"{c.training.stall_metric!r} (eq_loss | "
                            f"eval_error)")
        if (c.training.stall_metric == "eval_error" and not c.eval_data
                and any(st.advance_on_stall
                        for st in c.training.training_stages)):
            warnings.append("stall_metric='eval_error' needs eval_data — "
                            "the detector will fall back to eq_loss")
        for i, st in enumerate(c.training.training_stages, 1):
            if st.optimizer not in ("adam", "lbfgs", "lm"):
                warnings.append(f"unknown stage optimizer {st.optimizer!r}")
            if st.epochs <= 0:
                warnings.append(f"stage {i} ({st.name}): epochs must be > 0")
            if st.lr <= 0:
                warnings.append(f"stage {i} ({st.name}): lr must be > 0")
            if st.Re < 0 or st.bc_weight < 0:
                warnings.append(
                    f"stage {i} ({st.name}): Re/bc_weight overrides must be "
                    f">= 0 (0 = inherit the physics section)")
            if st.advance_on_stall and st.optimizer != "adam":
                warnings.append(
                    f"stage {i} ({st.name}): advance_on_stall only applies "
                    f"to adam stages — ignored for optimizer={st.optimizer!r}")
        return warnings

    def print_config(self, printer=print):
        c = self.config
        printer("=" * 60)
        printer(f"Experiment: {c.experiment_name}  [{c.model_variant}]")
        printer(f"Description: {c.description}")
        printer("Network:")
        if c.network.backbone == "kan":
            printer(f"  KAN width={c.network.kan_width} grid={c.network.kan_grid} k={c.network.kan_k}")
        else:
            form = ("" if c.network.formulation == "velocity"
                    else f" [{c.network.formulation}]")
            printer(f"  Main: {c.network.layers} layers x "
                    f"{c.network.hidden_size}{form}")
            if c.model_variant == "ev-nsfnet":
                printer(f"  EVM : {c.network.layers_1} layers x {c.network.hidden_size_1}")
        printer(f"Physics: Re={c.physics.Re} bc_w={c.physics.bc_weight} eq_w={c.physics.eq_weight}")
        printer(f"Training: N_f={c.training.N_f:,} stages={len(c.training.training_stages)} "
                f"precision={c.training.matmul_precision}")
        for i, st in enumerate(c.training.training_stages, 1):
            extra = f" Re={st.Re:g}" if st.Re else ""
            extra += f" bc_w={st.bc_weight:g}" if st.bc_weight else ""
            printer(f"  {i:02d} {st.name:<10} alpha={st.alpha:<7g} epochs={st.epochs:<9,} "
                    f"lr={st.lr:.2e} opt={st.optimizer}{extra}")
        sdf = c.training.sdf_weighting
        printer(f"SDF weighting: {'ON' if sdf.enabled else 'OFF'} "
                f"min={sdf.min_weight} decay={sdf.decay}")
        printer(f"Supervision: {'ON' if c.supervision.enabled else 'OFF'} "
                f"n={c.supervision.num_samples} w={c.supervision.loss_weight}")
        printer("=" * 60)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self.config)
