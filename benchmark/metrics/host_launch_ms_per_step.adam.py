"""The host's cost of the port's kernel launchers a step, in ms: the median
over the steps of host_ms_per_step.adam of their `kernel.*` span durations
(`kernel.loss_fwd` / `_bwd`, `kernel.streams_*`, `kernel.psi_*`: checks,
scratch, weight split, the ctypes call)."""

from benchmark.metrics._spans import median_ms, recorder, window_steps


def read(rec):
    prof = recorder()
    if prof is None:
        return None
    launch = lambda s: s.name.startswith("kernel.")
    per_step = [sum(s.end_ns - s.start_ns for s in spans if launch(s))
                for spans in window_steps(prof).values() if any(launch(s) for s in spans)]
    return median_ms(per_step)
