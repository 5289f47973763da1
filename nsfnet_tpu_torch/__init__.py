"""nsfnet_tpu_torch — the PyTorch/CUDA port of nsfnet_tpu.

The same steady 2-D lid-driven-cavity PINN solver (vanilla NSFnet and the
entropy-viscosity ev-NSFnet variant), written for PyTorch on an NVIDIA
Hopper card. The module layout mirrors `nsfnet_tpu/` so each module's
counterpart is easy to find; the port imports nothing of that package.

The equation loss of the training step runs on three hand-written CUDA
kernel pairs, built with `nvcc` at first use: the fused residual loss
(`ops/fused_residual.py`, `csrc/fused_residual.cu`), the five-stream
derivative engine (`ops/mlp_streams.py`, `csrc/mlp_streams.cu`) and the
order-3 streamfunction engine (`ops/psi_streams.py`, `csrc/psi_streams.cu`).
On CPU tensors every kernel wrapper runs its plain PyTorch version instead,
which is what the CPU tests exercise.
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
