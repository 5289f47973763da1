"""Set-up inside the program, in s: the summed durations of the run's
outermost `setup.*` spans (the solver, its data, the batch and step build,
the kernels' library build and load, the process's first step); a span
inside another `setup.*` span is counted in it."""

from benchmark.metrics._spans import recorder


def read(rec):
    prof = recorder()
    if prof is None:
        return None
    spans = prof.spans()
    by_seq = {s.seq: s for s in spans}
    total, found = 0, False
    for s in spans:
        if not s.name.startswith("setup."):
            continue
        up = by_seq.get(s.parent)
        while up is not None and not up.name.startswith("setup."):
            up = by_seq.get(up.parent)
        if up is None:
            total += s.end_ns - s.start_ns
            found = True
    return total / 1e9 if found else None
