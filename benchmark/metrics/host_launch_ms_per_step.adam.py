"""The host's cost of kernels 1+2's launchers a step, in ms: the median over
the steps of host_ms_per_step.adam of their `kernel.loss_fwd` +
`kernel.loss_bwd` span durations (checks, scratch, weight split, the
ctypes call)."""

from benchmark.metrics._spans import KERNELS_1_2, median_ms, recorder, window_steps


def read(rec):
    prof = recorder()
    if prof is None:
        return None
    per_step = [sum(s.end_ns - s.start_ns for s in spans if s.name in KERNELS_1_2)
                for spans in window_steps(prof).values()
                if any(s.name in KERNELS_1_2 for s in spans)]
    return median_ms(per_step)
