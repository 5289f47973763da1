"""Builds the port's CUDA sources (csrc/*.cu) with nvcc at first use.

Each source becomes a shared library with a plain C interface, loaded with
ctypes. Libraries go to build/nsfnet_tpu_torch/ at the root of the checkout
and are keyed by a hash of the sources and flags, so a fresh checkout builds
everything on its first kernel call and an edited source is rebuilt. All
missing libraries are compiled at once, one nvcc process per source.

Nothing here runs at import time: the CPU tests import every module of the
package on machines without nvcc or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

from nsfnet_tpu_torch.logger import get_logger
from nsfnet_tpu_torch.utils import profiling

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nsfnet_tpu_torch"
SOURCES = {"fused_residual": "fused_residual.cu", "mlp_streams": "mlp_streams.cu",
           "psi_streams": "psi_streams.cu", "psi_residual": "psi_residual.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}  # name -> nvcc/ptxas report of its build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card, with the CUDA toolkit installed")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / SOURCES[name]]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, ctypes.CDLL]:
    """Build (where missing) and load the named libraries; all by default.
    Raises with the compiler's output when a build fails."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if n not in _loaded]
    if todo:
        _build_and_load(todo)
    return {n: _loaded[n] for n in names}


@profiling.spanned("setup.library")
def _build_and_load(todo) -> None:
    """One nvcc process per library not built yet, then every load. The
    builds add to the counter `library_builds` and are logged, with the
    time they took."""
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        path = _lib_path(name)
        if path.exists():
            log = path.with_suffix(".log")
            build_logs[name] = log.read_text() if log.exists() else ""
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        build_logs[name] = out
        profiling.count("library_builds")
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        os.replace(tmp, path)  # atomic: concurrent builders never load a partial file
        path.with_suffix(".log").write_text(out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    if procs:
        get_logger().info(f"nvcc built {len(procs)} kernel libraries ({', '.join(procs)}) in "
                          f"{time.perf_counter() - t0:.1f} s; library_builds="
                          f"{profiling.counts()['library_builds']}")
    for name in todo:
        _loaded[name] = ctypes.CDLL(str(_lib_path(name)))


def load(name: str) -> ctypes.CDLL:
    return build_all([name])[name]
