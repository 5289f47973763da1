"""Scalar metric sink: TensorBoard when available, JSONL always.

The port's copy of nsfnet_tpu/utils/tensorboard.py. Scalar-tag parity with
the reference's TB hooks (ev-NSFnet/pinn_solver.py:627-646):
loss/{total,boundary,eq_total,eq1..eq4_entropy,supervision},
physics/{Re_eff,alpha_evm}, perf/{throughput_pts_per_s,avg_iter_s,
interval_iter_s}, lr — keyed by a monotonically increasing global step
spanning stages. The port adds perf/host_ms_per_step (the median host
time of steps 2-4 of the interval's chunks, before the launch queue fills)
and, on a card, perf/device_ms_per_step (the chunks' card time a step), from
utils/profiling.py's records.
"""

from __future__ import annotations

import json
import os
import time


class ScalarWriter:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        self._tb = None
        try:  # torch's writer needs the tensorboard package; the JSONL log does not
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self._tb = SummaryWriter(log_dir=log_dir)

    def add_scalar(self, tag: str, value: float, step: int):
        try:
            value = float(value)
        except (TypeError, ValueError):
            return
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": value, "step": int(step), "t": time.time()}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def flush(self):
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
