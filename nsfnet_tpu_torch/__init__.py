"""nsfnet_tpu_torch — the PyTorch/CUDA port of nsfnet_tpu.

The same steady 2-D lid-driven-cavity PINN solver (vanilla NSFnet and the
entropy-viscosity ev-NSFnet variant), written for PyTorch on an NVIDIA
Hopper card. The module layout mirrors `nsfnet_tpu/` so each module's
counterpart is easy to find; the port imports nothing of that package.

The equation loss of the training step is one hand-written CUDA kernel pair
(`ops/fused_residual.py`, `csrc/fused_residual.cu`), built with `nvcc` at
first use. On CPU tensors every kernel wrapper runs its plain PyTorch
version instead, which is what the CPU tests exercise.
"""

__version__ = "0.1.0"

from nsfnet_tpu_torch.config import (
    AppConfig,
    ConfigManager,
    NetworkConfig,
    PhysicsConfig,
    SDFWeightConfig,
    SupervisionConfig,
    TrainingConfig,
    TrainingStage,
)

__all__ = [
    "AppConfig",
    "ConfigManager",
    "NetworkConfig",
    "PhysicsConfig",
    "SDFWeightConfig",
    "SupervisionConfig",
    "TrainingConfig",
    "TrainingStage",
    "__version__",
]
