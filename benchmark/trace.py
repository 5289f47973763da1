"""The traced chunk: a few steps under torch.profiler, read back from its
Chrome trace into a plain record that the per-layer readers take.

The chunk runs inside one annotation, `WINDOW`, that starts and ends on a
synchronised card, so its wall time and the device operations inside it
come from the same trace. The trace file lives in a temporary directory
(under TMPDIR) only while it is read.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, List, Tuple

import torch

WINDOW = "benchmark.traced_chunk"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
NAME_CHARS = 160  # a kernel's template name is cut to this in the breakdown


def trace_chunk(run: Callable[[], None]) -> dict:
    """Run `run()` under the profiler between two synchronisations; return the
    record of its window: {"window_us", "device": [(name, cat, ts, dur)],
    "host": [(name, ts, dur)]}, times in microseconds."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            run()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return parse(events)


def parse(events: List[dict]) -> dict:
    """The window's device operations and the host operations of its thread."""
    win = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW} annotation")
    w = win[0]
    t0, t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    inside = lambda e: float(e["ts"]) < t1 and float(e["ts"]) + float(e.get("dur", 0)) > t0
    device = [(e["name"], e["cat"], float(e["ts"]), float(e["dur"])) for e in events
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS and inside(e)]
    host = [(e["name"], float(e["ts"]), float(e["dur"])) for e in events
            if e.get("ph") == "X" and e.get("cat") in HOST_CATS and inside(e)
            and e.get("pid") == w.get("pid") and e.get("tid") == w.get("tid")]
    device.sort(key=lambda e: e[2])
    return {"window_us": t1 - t0, "t0": t0, "device": device, "host": host}


def busy_intervals(rec: dict) -> List[Tuple[float, float]]:
    """The union of the device operations' intervals, clipped to the window."""
    t0, t1 = rec["t0"], rec["t0"] + rec["window_us"]
    out: List[List[float]] = []
    for _, _, ts, dur in rec["device"]:
        a, b = max(ts, t0), min(ts + dur, t1)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_us(rec: dict) -> float:
    return sum(b - a for a, b in busy_intervals(rec))


def _host_op_at(rec: dict, t: float) -> str:
    """The innermost host operation open at time t, or `python` where none is."""
    best = None
    for name, ts, dur in rec["host"]:
        if ts <= t <= ts + dur and (best is None or dur < best[1]):
            best = (name, dur)
    return best[0] if best else "python"


def breakdown(rec: dict, top: int = 10) -> dict:
    """The device operations that took most time, by name, and the longest
    idle gaps of the card, each named by what the host was doing then;
    seconds."""
    by_name = defaultdict(float)
    for name, _, _, dur in rec["device"]:
        by_name[name[:NAME_CHARS]] += dur
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    t0, t1 = rec["t0"], rec["t0"] + rec["window_us"]
    edges = [t0] + [x for iv in busy_intervals(rec) for x in iv] + [t1]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    gaps.sort(key=lambda g: g[0] - g[1])
    return {"device_ops": [[n, us / 1e6] for n, us in ops],
            "idle_gaps": [[_host_op_at(rec, (a + b) / 2), (b - a) / 1e6]
                          for a, b in gaps[:top]]}
