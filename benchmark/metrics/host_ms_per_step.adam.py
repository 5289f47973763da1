"""The host's time a step, in ms: the median duration of the program's
`step` spans at steps 2-4 of each window chunk. The host enqueues a step
there without waiting on the card (step 1 carries the chunk's head; by
step 4 at most ~850 launches are queued, under the launch queue's depth)."""

from benchmark.metrics._spans import median_ms, recorder, window_steps


def read(rec):
    prof = recorder()
    if prof is None:
        return None
    return median_ms([s.end_ns - s.start_ns for spans in window_steps(prof).values()
                      for s in spans if s.name == "step"])
