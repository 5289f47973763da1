"""Profiling: the port's one recorder of spans and counters, and the
torch.profiler trace (port of nsfnet_tpu/utils/profiling.py).

`torch_trace` records a `torch.profiler` trace (CPU ops and, on a card, its
CUDA kernels) into a directory as a Chrome trace, where the JAX package's
`xla_trace` writes an XLA trace for TensorBoard's profile plugin. train.py's
`--profile DIR` wraps its first stage in it.

The recorder (`RECORDER`, its methods also bound at module level):

  * `span(name)`: a context manager that records name, start, end, the
    enclosing span, the solver chunk it ran in and the step of that chunk
    (from 1; 0 outside a step). Always on: these are the coarse spans, a few
    a step (`step`, `kernel.<launcher>`) and a handful a process
    (`setup.*`).
  * `fine(name)`: the same span where tracing is on, else a shared no-op
    context: one flag check. Tracing is on while a torch.profiler is active
    (looked up when a chunk or another outermost span opens) and inside a
    `tracing()` block.
  * `chunk(n_steps, points, device)`: the `solver.chunk` span of
    `PINNSolver.run_steps`, and a record of the chunk (`chunks()`): host
    enqueue ns, and on a card device ns from a pair of CUDA events around
    it, read when a later chunk opens or `chunks()` is called, once the end
    event has completed (never by a synchronisation). A long chunk's host
    ns reads the card's pace once the launch queue is full; `head_steps()`
    gives the `step` spans at HEAD_STEPS, before it fills: the host's own.
  * `count(name, n)` / `counts()`: named counters; `register(prefix, d)`
    adds a dict of counters kept elsewhere (the kernels' launches, rows and
    floats reduced into their gradient partials), read as `<prefix>.<key>`.

Times are `time.time_ns()`, Unix ns. While a torch.profiler is active each
span also opens `torch.profiler.record_function("nsfnet.<name>")` inside its
stamps, so an exported trace (whose `ts` in us plus `baseTimeNanoseconds`
is Unix time) holds the program's spans on the device trace's clock.

Spans go into a ring of `CAPACITY` preallocated slots, each in slot
(seq mod CAPACITY) when it opens; newer spans overwrite the oldest, so a
campaign of any length holds a bounded window (about 21,000 steps at three
spans a step), and `spans()` gives the closed ones. One stack of open spans
serves the process: spans open on the thread that runs the step and on
autograd's device thread, which runs a backward while the step's thread
waits for it, so the two never record at once.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional

CAPACITY = 1 << 16  # spans kept
CHUNK_CAPACITY = 1 << 12  # chunk records kept
HEAD_STEPS = (2, 3, 4)  # of a chunk: past its head, before the launch queue fills
PREFIX = "nsfnet."  # of the profiler ranges

_now = time.time_ns


class Span(NamedTuple):
    seq: int  # order of opening, from 0 in the process
    name: str
    start_ns: int
    end_ns: int
    parent: int  # the enclosing span's seq, -1 for none
    chunk: int  # the chunk's id, -1 outside a chunk
    step: int  # the step's index in its chunk, from 1; 0 outside a step


class Chunk(NamedTuple):
    id: int
    n_steps: int
    points: int  # points a step
    start_ns: int
    end_ns: int
    host_ns: int  # the host's enqueue time: end_ns - start_ns
    device_ns: Optional[int]  # the card's time between the chunk's events; None on the CPU
    profiled: bool  # a torch.profiler was active


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL = _Null()


class _Span:
    """A named span; one object per name, reused. Opening it puts its
    record [seq, name, start, end, parent, chunk, step, profiler range] in
    the ring (slot seq mod capacity) and on the recorder's stack; closing
    it stamps the end."""

    __slots__ = ("rec", "name", "label", "step")

    def __init__(self, rec: "Recorder", name: str, step: bool = False):
        self.rec, self.name, self.label, self.step = rec, name, PREFIX + name, step

    def __enter__(self):
        rec = self.rec
        stack = rec._stack
        if stack:
            parent = stack[-1][0]
        else:
            rec._refresh()
            parent = -1
        if self.step:
            rec._step_i += 1
        seq = next(rec._seq)
        r = [seq, self.name, _now(), 0, parent, rec._chunk_id, rec._step_i, None]
        rec._ring[seq & rec._mask] = r
        stack.append(r)
        if rec.profiled:
            from torch.profiler import record_function

            r[7] = record_function(self.label)
            r[7].__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        r = self.rec._stack.pop()
        if r[7] is not None:
            r[7].__exit__(None, None, None)
            r[7] = None
        r[3] = _now()
        return False


class _FirstStep:
    """The process's first step, inside `setup.first_step`."""

    __slots__ = ("outer", "inner")

    def __init__(self, rec: "Recorder"):
        self.outer, self.inner = rec.span("setup.first_step"), rec._step_span

    def __enter__(self):
        self.outer.__enter__()
        return self.inner.__enter__()

    def __exit__(self, *exc):
        try:
            self.inner.__exit__(*exc)
        finally:
            self.outer.__exit__(*exc)
        return False


class _ChunkSpan:
    __slots__ = ("rec", "n_steps", "points", "device", "events", "record")

    def __init__(self, rec: "Recorder", n_steps: int, points: int, device):
        self.rec, self.n_steps, self.points = rec, int(n_steps), int(points)
        self.device = device if device is not None and device.type == "cuda" else None

    def __enter__(self):
        rec = self.rec
        rec._resolve()
        rec._refresh()
        rec._chunk_id = rec._chunk_count
        rec._chunk_count += 1
        rec._step_i = 0
        rec._chunk_span.__enter__()
        self.record = rec._stack[-1]
        self.events = None
        if self.device is not None:
            import torch

            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(torch.cuda.current_stream(self.device))
        return self

    def __exit__(self, exc_type, *exc):
        rec = self.rec
        try:
            if self.events is not None and exc_type is None:
                import torch

                self.events[1].record(torch.cuda.current_stream(self.device))
            else:  # a failed chunk's card times are not kept
                self.events = None
                rec._pending.clear()
        finally:
            profiled = rec.profiled
            rec._step_i = 0
            rec._chunk_span.__exit__(exc_type, *exc)
            t0, t1 = self.record[2], self.record[3]
            record = [rec._chunk_id, self.n_steps, self.points, t0, t1, t1 - t0, None, profiled,
                      self.record[0]]  # the last: the chunk span's seq
            rec._chunks.append(record)
            if self.events is not None:
                rec._pending.append((record, self.events))
            rec._chunk_id = -1
        return False


class Recorder:
    """Spans and counters of one process (module docstring)."""

    def __init__(self, capacity: int = CAPACITY, chunk_capacity: int = CHUNK_CAPACITY):
        if capacity & (capacity - 1):
            raise ValueError(f"capacity {capacity} is not a power of two")
        self._mask = capacity - 1
        self._ring: List[Optional[list]] = [None] * capacity
        self._chunks: deque = deque(maxlen=chunk_capacity)
        self._pending: deque = deque(maxlen=chunk_capacity)
        self._spans: Dict[str, _Span] = {}
        self._counts: Dict[str, int] = {}
        self._registered: List[tuple] = []  # (prefix, dict)
        self._tracing_depth = 0
        self._step_span = _Span(self, "step", step=True)
        self._chunk_span = _Span(self, "solver.chunk")
        self.clear()

    def clear(self) -> None:
        """Forget every span, chunk and own counter (registered dicts are
        their owners'); the next step counts as the process's first."""
        self._stack: list = []
        self._seq = itertools.count()
        self._ring[:] = [None] * len(self._ring)
        self._chunk_id = -1  # the open chunk's
        self._chunk_count = 0
        self._step_i = 0
        self._first = True
        self._chunks.clear()
        self._pending.clear()
        self._counts.clear()
        self.profiled = False
        self.fine_on = self._tracing_depth > 0

    # -------------------------------------------------------------- spans

    def _refresh(self) -> None:
        """Look up whether a torch.profiler is active (at a chunk or
        another outermost span)."""
        import torch

        self.profiled = torch.autograd._profiler_enabled()
        self.fine_on = self.profiled or self._tracing_depth > 0

    def span(self, name: str) -> _Span:
        sp = self._spans.get(name)
        if sp is None:
            sp = self._spans[name] = _Span(self, name)
        return sp

    def fine(self, name: str):
        """`span(name)` where tracing is on, else a no-op context."""
        return self.span(name) if self.fine_on else NULL

    def step(self):
        """The `step` span (its index in the chunk), inside
        `setup.first_step` for the process's first step."""
        if self._first:
            self._first = False
            return _FirstStep(self)
        return self._step_span

    def chunk(self, n_steps: int, points: int, device=None) -> _ChunkSpan:
        """The `solver.chunk` span and record of `n_steps` steps of `points`
        points each; on a CUDA `device`, timed on its current stream too."""
        return _ChunkSpan(self, n_steps, points, device)

    @contextlib.contextmanager
    def tracing(self):
        """Fine spans on inside the block, profiler or not."""
        self._tracing_depth += 1
        self.fine_on = True
        try:
            yield self
        finally:
            self._tracing_depth -= 1
            self.fine_on = self.profiled or self._tracing_depth > 0

    def spans(self) -> List[Span]:
        """The closed spans the ring holds, in order of opening."""
        out = [Span(*r[:7]) for r in self._ring if r is not None and r[3]]
        out.sort(key=lambda sp: sp.seq)
        return out

    def _resolve(self) -> None:
        """Device ns of the chunks whose end event has completed, oldest
        first (a chunk's events complete in order)."""
        pending = self._pending
        while pending:
            record, (start, end) = pending[0]
            if not end.query():
                return
            record[6] = int(round(start.elapsed_time(end) * 1e6))
            pending.popleft()

    def chunks(self, since: int = -1) -> List[Chunk]:
        """The chunk records kept whose id is above `since`, oldest first;
        a chunk whose card work is still running reads device_ns None."""
        self._resolve()
        return [Chunk(*r[:8]) for r in self._chunks if r[0] > since]

    def head_steps(self, since: int = -1) -> List[int]:
        """Host ns of the `step` spans at HEAD_STEPS of the chunks kept whose
        id is above `since`, as far as the ring still holds them: each
        chunk's spans follow its own in the ring, up to its last head step."""
        out, last, ring, mask = [], HEAD_STEPS[-1], self._ring, self._mask
        for c in self._chunks:
            if c[0] <= since:
                continue
            seq = c[8] + 1
            while True:
                r = ring[seq & mask]
                if r is None or r[0] != seq or r[5] != c[0] or r[6] > last:
                    break
                if r[1] == "step" and r[6] in HEAD_STEPS and r[3]:
                    out.append(r[3] - r[2])
                seq += 1
        return out

    # ----------------------------------------------------------- counters

    def count(self, name: str, n: int = 1) -> None:
        self._counts[name] = self._counts.get(name, 0) + n

    def register(self, prefix: str, counters: dict) -> None:
        """Read `counters` (kept and reset by their owner) as
        `<prefix>.<key>` in `counts()`."""
        if not any(p == prefix and d is counters for p, d in self._registered):
            self._registered.append((prefix, counters))

    def counts(self) -> Dict[str, int]:
        out = dict(self._counts)
        for prefix, d in self._registered:
            out.update((f"{prefix}.{k}", v) for k, v in d.items())
        return out


RECORDER = Recorder()
span = RECORDER.span
fine = RECORDER.fine
step = RECORDER.step
chunk = RECORDER.chunk
tracing = RECORDER.tracing
spans = RECORDER.spans
chunks = RECORDER.chunks
head_steps = RECORDER.head_steps
count = RECORDER.count
register = RECORDER.register
counts = RECORDER.counts


def spanned(name: str):
    """Decorator: the call inside `span(name)`."""
    import functools

    def wrap(fn):
        sp = RECORDER.span(name)

        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with sp:
                return fn(*args, **kwargs)

        return inner

    return wrap


@contextlib.contextmanager
def torch_trace(log_dir: str, cuda: bool = True):
    """Record a torch.profiler trace of the block into
    `<log_dir>/trace_<pid>.json` (chrome://tracing, Perfetto); CUDA kernels
    are recorded where a card is present and `cuda` is set."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if cuda and torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda and torch.cuda.is_available():
            torch.cuda.synchronize()  # the block's kernels end inside the trace
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))
