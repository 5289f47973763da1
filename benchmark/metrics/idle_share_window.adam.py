"""The card's idle share of the unprofiled window, in %: one less its busy
time a step over its time a step. Busy a step is the traced chunk's (the
union of its device operations over its steps: the profiler slows the host,
not the kernels); time a step is the median over the window's chunks of the
card's time between each chunk's two CUDA events (the program's
`solver.chunk` record) over its steps."""

import statistics

from benchmark.metrics._spans import recorder, window_chunks
from benchmark.trace import busy_us


def read(rec):
    if not rec["device"]:
        return None
    prof = recorder()
    if prof is None:
        return None
    per_step = [c.device_ns / c.n_steps for c in window_chunks(prof) if c.device_ns is not None]
    if not per_step:
        return None
    return 100.0 * (1.0 - busy_us(rec) * 1e3 / rec["steps"] / statistics.median(per_step))
