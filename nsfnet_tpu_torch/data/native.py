"""ctypes binding of the repo's native point generator (native/pointgen.cpp),
the port's copy of nsfnet_tpu/data/native.py.

The five entry points (`lh_sample`, `min_distance`, `box_boundary_distance`,
`sdf_weights`, `sort_by_distance`) take the argument types of the JAX
package's binding, so the same library gives both packages the same points.
The port builds its own copy: g++ with native/Makefile's flags, at first use
(never at import), into build/nsfnet_tpu_torch/ keyed by a hash of the
source, the flags and the host's CPU (`-march=native` binds the library to
the CPU it was built on). Concurrent builds write to temporary names and
`os.replace` the result, so none loads a partial file. It never builds into
native/: a native/libpointgen.so would change which sampling path the JAX
package takes. A missing compiler raises; nothing falls back to numpy here
(data/cavity.py chooses the path, and a native-path state needs this one).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "pointgen.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nsfnet_tpu_torch"
# native/Makefile's CXXFLAGS, and -shared from its link line
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")

_LIB: Optional[ctypes.CDLL] = None

_D = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
_F = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
_I = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")


def _host_key() -> bytes:
    """The CPU's model and feature flags (what -march=native reads)."""
    try:
        with open("/proc/cpuinfo", encoding="utf-8", errors="replace") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags", "Features"))]
        return "".join(sorted(set(lines))).encode()
    except OSError:
        import platform

        return platform.processor().encode() + platform.machine().encode()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(_host_key())
    return BUILD_DIR / f"libpointgen-{h.hexdigest()[:16]}.so"


def _compiler() -> str:
    cxx = shutil.which(os.environ.get("CXX") or "g++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++) found: the native sampler is built from "
                           "native/pointgen.cpp at first use")
    return cxx


def build() -> Path:
    """Compile the library where it is missing; returns its path."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE} failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent build never loads a partial file
    return path


def _bind(path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.lh_sample.argtypes = [ctypes.c_int64, ctypes.c_int64, _D, ctypes.c_uint64, _D]
    lib.min_distance.argtypes = [ctypes.c_int64, _D, ctypes.c_int64, _D, _D]
    lib.box_boundary_distance.argtypes = [ctypes.c_int64, _D, ctypes.c_double,
                                          ctypes.c_double, _D]
    lib.sdf_weights.argtypes = [ctypes.c_int64, _D, ctypes.c_double, ctypes.c_double,
                                ctypes.c_double, ctypes.c_double, _F]
    lib.sort_by_distance.argtypes = [ctypes.c_int64, _D, ctypes.c_int64, _D, _I]
    for fn in ("lh_sample", "min_distance", "box_boundary_distance", "sdf_weights",
               "sort_by_distance"):
        getattr(lib, fn).restype = None
    return lib


def load() -> ctypes.CDLL:
    """The library, built and bound at the first call."""
    global _LIB
    if _LIB is None:
        _LIB = _bind(build())
    return _LIB


def lh_sample(n: int, bounds, seed: int) -> np.ndarray:
    """Latin-Hypercube sample of n points in the box `bounds` ([d, 2]),
    [n, d] float64, from a mt19937_64 stream seeded `seed`."""
    lib = load()
    b = np.ascontiguousarray(bounds, dtype=np.float64)
    out = np.empty((n, b.shape[0]), dtype=np.float64)
    lib.lh_sample(n, b.shape[0], b, seed & (2**64 - 1), out)
    return out


def min_distance(pts: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Euclidean distance from each point to the nearest of `ref`."""
    lib = load()
    p = np.ascontiguousarray(pts, dtype=np.float64)
    r = np.ascontiguousarray(ref, dtype=np.float64)
    out = np.empty(p.shape[0], dtype=np.float64)
    lib.min_distance(p.shape[0], p, r.shape[0], r, out)
    return out


def box_boundary_distance(pts: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """Distance of each point to the boundary of the square [lo, hi]^2."""
    lib = load()
    p = np.ascontiguousarray(pts, dtype=np.float64)
    out = np.empty(p.shape[0], dtype=np.float64)
    lib.box_boundary_distance(p.shape[0], p, lo, hi, out)
    return out


def sdf_weights(pts: np.ndarray, lo: float, hi: float, min_w: float,
                decay: float) -> np.ndarray:
    """min_w + (1 - min_w) exp(-decay d), mean-normalised, float32."""
    lib = load()
    p = np.ascontiguousarray(pts, dtype=np.float64)
    out = np.empty(p.shape[0], dtype=np.float32)
    lib.sdf_weights(p.shape[0], p, lo, hi, min_w, decay, out)
    return out


def sort_by_distance(pts: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """The points in ascending order of their distance to `ref` (stable)."""
    lib = load()
    p = np.ascontiguousarray(pts, dtype=np.float64)
    r = np.ascontiguousarray(ref, dtype=np.float64)
    order = np.empty(p.shape[0], dtype=np.int64)
    lib.sort_by_distance(p.shape[0], p, r.shape[0], r, order)
    return p[order]
