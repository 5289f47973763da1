"""PyTorch port: it stands alone (no JAX, flax or msgpack, nothing of
nsfnet_tpu; it reads the JAX package's checkpoints with its own decoder), its entry
points refuse to run on the CPU unless asked, and the CLI runs on the CPU
when asked."""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from nsfnet_tpu_torch import train as port_train
from nsfnet_tpu_torch.training.checkpoint import load_metadata
from nsfnet_tpu_torch.training.solver import PINNSolver

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "nsfnet_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "nsfnet_tpu")


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_no_source_imports_jax_or_the_jax_package():
    bad = []
    for path in _port_sources():
        tree = ast.parse(open(path, encoding="utf-8").read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path}: {n}" for n in names if _forbidden(n)]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    mods = sorted(
        "nsfnet_tpu_torch." + os.path.relpath(p, PKG)[:-3].replace(os.sep, ".")
        for p in _port_sources() if p.startswith(PKG) and not p.endswith("__init__.py"))
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    loaded = json.loads(out.strip().splitlines()[-1])
    assert {"nsfnet_tpu_torch.training.solver", "nsfnet_tpu_torch.training.checkpoint",
            "nsfnet_tpu_torch.training.lbfgs", "nsfnet_tpu_torch.training.lm",
            "nsfnet_tpu_torch.models.kan"} <= set(loaded)
    assert NEW_MODULES <= set(loaded)
    assert [m for m in loaded if _forbidden(m)] == []
    # the figures import matplotlib inside each function (the card's machine has none)
    assert "matplotlib" not in loaded


NEW_MODULES = {"nsfnet_tpu_torch.data.native", "nsfnet_tpu_torch.utils.torch_import",
               "nsfnet_tpu_torch.test", "nsfnet_tpu_torch.utils.profiling",
               "nsfnet_tpu_torch.utils.export", "nsfnet_tpu_torch.utils.visualization",
               "nsfnet_tpu_torch.tools.watchdog", "nsfnet_tpu_torch.bench",
               "nsfnet_tpu_torch.tools.perf_matrix"}


def test_the_tool_modules_import_without_jax_or_a_build():
    """The tools' modules in a fresh interpreter: no JAX, nothing of
    nsfnet_tpu, and no build at import (the native sampler and the kernels
    build at first use)."""
    code = (f"import importlib, json, sys\n"
            f"for m in {sorted(NEW_MODULES)!r}: importlib.import_module(m)\n"
            "from nsfnet_tpu_torch.data import native\n"
            "from nsfnet_tpu_torch.ops import _build\n"
            "print(json.dumps([sorted(sys.modules), native._LIB is None, not _build._loaded]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    loaded, no_lib, no_kernels = json.loads(out.strip().splitlines()[-1])
    assert [m for m in loaded if _forbidden(m)] == []
    assert no_lib and no_kernels


def test_entry_points_refuse_the_cpu_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PINNSolver()
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(TINY.format(out=tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_train.main(["--config", str(cfg)])


TINY = """\
experiment_name: tiny
model_variant: ev-nsfnet
physics: {{Re: 100, alpha_evm: 0.05, bc_weight: 10, eq_weight: 1}}
network: {{layers: 2, layers_1: 2, hidden_size: 16, hidden_size_1: 8}}
training:
  N_f: 300
  log_interval: 2
  checkpoint_freq: 1000000
  checkpoint_dir: {out}
  evm_update_freq: 2
  sort_training_points: false
  enable_tensorboard: false
  sdf_weighting: {{enabled: true}}
  training_stages:
    - {{alpha: 0.05, epochs: 3, lr: 1.0e-3, name: S1}}
    - {{alpha: 0.03, epochs: 2, lr: 2.0e-4, name: S2, Re: 150}}
"""


def test_cli_runs_on_the_cpu_when_asked(tmp_path):
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(TINY.format(out=tmp_path))
    assert port_train.main(["--config", str(cfg), "--dry-run"]) == 0
    assert port_train.main(["--config", str(cfg), "--cpu"]) == 0
    final = list(tmp_path.glob("Re100/*/model_final.ckpt"))
    assert len(final) == 1
    meta = load_metadata(str(final[0]))
    assert meta["global_step"] == 5 and meta["stage"] == "S2"


def test_cli_refuses_what_the_port_does_not_run(tmp_path):
    """mesh_devices: 2 in a 1-process run (the port runs one process per
    card: torchrun --nproc_per_node=2), and the L2 loss with microbatches
    (the JAX solver refuses it too): exit 2 before any training."""
    for extra in ("  mesh_devices: 2\n", "  microbatches: 2\n  loss_mode: L2\n"):
        cfg = tmp_path / "refused.yaml"
        cfg.write_text(TINY.format(out=tmp_path).replace("  N_f: 300\n", "  N_f: 300\n" + extra))
        assert port_train.main(["--config", str(cfg), "--cpu"]) == 2
    assert not list(tmp_path.glob("Re100/*/*.ckpt"))


def test_cli_trains_microbatched_on_the_cpu(tmp_path):
    cfg = tmp_path / "micro.yaml"
    cfg.write_text(TINY.format(out=tmp_path).replace("  N_f: 300\n", "  N_f: 300\n  microbatches: 2\n"))
    assert port_train.main(["--config", str(cfg), "--cpu"]) == 0
    final = list(tmp_path.glob("Re100/*/model_final.ckpt"))
    assert len(final) == 1 and load_metadata(str(final[0]))["global_step"] == 5
