"""The card's idle share of the traced chunk, in %: one less the union of its
operations' time over the chunk's wall time, both from the same trace."""

from benchmark.trace import busy_us


def read(rec):
    if not rec["device"]:
        return None
    return 100.0 * (1.0 - busy_us(rec) / rec["window_us"])
