"""Shared reading of the program's own spans and chunk records
(nsfnet_tpu_torch/utils/profiling.py) for the readers of the run they are
in. A program without them (one older than its recorder) gives None."""

from __future__ import annotations

import statistics

STEPS = (2, 3, 4)  # of each window chunk: past the chunk's head, before the launch queue fills


def recorder():
    """The program's recorder module, or None where it has no spans."""
    from nsfnet_tpu_torch.utils import profiling

    return profiling if hasattr(profiling, "chunks") and hasattr(profiling, "spans") else None


def window_chunks(prof):
    """The window's chunks: the unprofiled ones with the most steps, less
    the first of them (the warm-up)."""
    chunks = [c for c in prof.chunks() if not c.profiled]
    if not chunks:
        return []
    most = max(c.n_steps for c in chunks)
    return [c for c in chunks if c.n_steps == most][1:]


def window_steps(prof):
    """{(chunk id, step index): [spans of that step]} over STEPS of the
    window's chunks, or {} where there are none."""
    ids = {c.id for c in window_chunks(prof)}
    out = {}
    for s in prof.spans():
        if s.chunk in ids and s.step in STEPS:
            out.setdefault((s.chunk, s.step), []).append(s)
    return out


def median_ms(values):
    return statistics.median(values) / 1e6 if values else None
