"""Run logging, built on stdlib `logging`.

Capability parity with the reference's observability channel (rank-0-only
emission, a timestamped per-run log file, banner/stage conveniences —
behavior described by SURVEY §5.5), assembled the standard-library way: a
namespaced `logging.Logger` with a rank filter, a console StreamHandler,
and an optional FileHandler.

Console output goes to STDERR (the `logging` default), keeping driver
stdout machine-parseable — `chip_smoke.py` prints its JSON lines on stdout
even though the solver logs its banner during setup.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

_FORMAT = logging.Formatter("[%(asctime)s][%(levelname)s] %(message)s",
                            datefmt="%H:%M:%S")


class _RankFilter(logging.Filter):
    """Drop every record on non-zero ranks (one writer per multi-host run)."""

    def __init__(self, rank: int):
        super().__init__()
        self.rank = rank

    def filter(self, record: logging.LogRecord) -> bool:
        return self.rank == 0


class RunLog:
    """Facade over a stdlib logger adding the run-shaped helpers the
    drivers use (`header` banners, `stage` transition lines)."""

    def __init__(self, logger: logging.Logger, rank: int = 0):
        self._log = logger
        self.rank = rank

    def info(self, msg: str):
        self._log.info(msg)

    def warning(self, msg: str):
        self._log.warning(msg)

    def error(self, msg: str):
        self._log.error(msg)

    def header(self, title: str):
        self._log.info("=" * 60)
        self._log.info(f"  {title}")
        self._log.info("=" * 60)

    def stage(self, name: str, alpha: float, epochs: int, lr: float):
        self._log.info(
            f">>> {name}: alpha_evm={alpha} epochs={epochs:,} lr={lr:.2e}")

    def close(self):
        for h in list(self._log.handlers):
            h.close()
            self._log.removeHandler(h)


def _build(name: str, rank: int, log_dir: str = "logs",
           to_file: bool = True) -> RunLog:
    lg = logging.getLogger(f"nsfnet_tpu_torch.run.{name}")
    lg.setLevel(logging.INFO)
    lg.propagate = False
    # idempotent rebuilds (tests, repeated drivers in one process)
    for h in list(lg.handlers):
        h.close()
        lg.removeHandler(h)
    lg.filters.clear()
    lg.addFilter(_RankFilter(rank))

    console = logging.StreamHandler()  # stderr by default
    console.setFormatter(_FORMAT)
    lg.addHandler(console)

    if rank == 0 and to_file:
        try:
            os.makedirs(log_dir, exist_ok=True)
            ts = time.strftime("%Y%m%d_%H%M%S")
            fh = logging.FileHandler(os.path.join(log_dir, f"{name}_{ts}.log"))
            fh.setFormatter(_FORMAT)
            lg.addHandler(fh)
        except OSError:
            pass  # read-only working dir: console-only
    return RunLog(lg, rank=rank)


_LOGGER: Optional[RunLog] = None


def get_logger(name: str = "nsfnet_tpu_torch", rank: int = 0, **kw) -> RunLog:
    """Process-wide accessor: the first caller (the driver) fixes the run
    name and rank; later callers (solver internals) share the instance."""
    global _LOGGER
    if _LOGGER is None:
        _LOGGER = _build(name, rank, **kw)
    return _LOGGER
