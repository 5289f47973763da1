"""Profiling utilities (port of nsfnet_tpu/utils/profiling.py).

`wallclock` prints a labelled wall time; `torch_trace` records a
`torch.profiler` trace (CPU ops and, on a card, its CUDA kernels) into a
directory as a Chrome trace, where the JAX package's `xla_trace` writes an
XLA trace for TensorBoard's profile plugin. train.py's `--profile DIR`
wraps its first stage in it.
"""

from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def torch_trace(log_dir: str, cuda: bool = True):
    """Record a torch.profiler trace of the block into
    `<log_dir>/trace_<pid>.json` (chrome://tracing, Perfetto); CUDA kernels
    are recorded where a card is present and `cuda` is set."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if cuda and torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda and torch.cuda.is_available():
            torch.cuda.synchronize()  # the block's kernels end inside the trace
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))


@contextlib.contextmanager
def wallclock(label: str, sink=print):
    t0 = time.perf_counter()
    yield
    sink(f"[{label}] {time.perf_counter() - t0:.3f}s")
