"""PyTorch port: profiling (utils/profiling.py, train.py's --profile;
nsfnet_tpu/utils/profiling.py and nsfnet_tpu/train.py:67-69, 430-438 in the
JAX package): the first stage's torch.profiler trace is written, holds the
step's operations, and leaves the run's results as they are without it; the
recorder's spans, chunk records and counters, its bounded buffer, and its
clock, shared with the profiler's trace."""

import glob
import json
import os
import time

import numpy as np
import pytest
import torch

from nsfnet_tpu_torch import train as port_train
from nsfnet_tpu_torch.ops import _build
from nsfnet_tpu_torch.ops import fused_residual as fr
from nsfnet_tpu_torch.training.checkpoint import load_metadata
from nsfnet_tpu_torch.training.solver import PINNSolver
from nsfnet_tpu_torch.utils import profiling
from nsfnet_tpu_torch.utils.profiling import Recorder, torch_trace

torch.set_num_threads(2)

CONFIG = """\
experiment_name: prof
model_variant: ev-nsfnet
physics: {{Re: 100, alpha_evm: 0.03}}
network: {{layers: 2, layers_1: 2, hidden_size: 8, hidden_size_1: 8}}
training:
  N_f: 64
  seed: 2
  log_interval: 3
  enable_tensorboard: false
  sort_training_points: false
  checkpoint_freq: 1000000
  checkpoint_dir: {out}
  training_stages:
    - {{alpha: 0.03, epochs: 3, lr: 1.0e-3, name: S1}}
    - {{alpha: 0.02, epochs: 2, lr: 1.0e-4, name: S2}}
"""


def test_profile_traces_the_first_stage(tmp_path):
    finals = {}
    for name, extra in (("plain", []), ("traced", ["--profile", str(tmp_path / "trace")])):
        cfg = tmp_path / f"{name}.yaml"
        cfg.write_text(CONFIG.format(out=tmp_path / name))
        assert port_train.main(["--config", str(cfg), "--cpu", *extra]) == 0
        finals[name] = glob.glob(str(tmp_path / name / "**" / "model_final.ckpt"),
                                 recursive=True)[0]
    traces = glob.glob(str(tmp_path / "trace" / "trace_*.json"))
    assert len(traces) == 1  # the first stage only
    events = {e.get("name") for e in json.load(open(traces[0]))["traceEvents"]}
    assert any(n.startswith("aten::") for n in events if n)
    a, b = (torch.load(f, weights_only=True) for f in (finals["plain"], finals["traced"]))
    assert torch.equal(a["params"], b["params"])
    assert load_metadata(finals["traced"])["global_step"] == 5


def _trace_events(log_dir):
    (path,) = glob.glob(os.path.join(str(log_dir), "trace_*.json"))
    with open(path) as f:
        return json.load(f)


def test_torch_trace_and_a_span(tmp_path):
    with torch_trace(str(tmp_path), cuda=False), profiling.span("demo"):
        torch.ones(4) @ torch.ones(4)
    names = {e.get("name") for e in _trace_events(tmp_path)["traceEvents"]}
    assert "nsfnet.demo" in names and "aten::dot" in names


def _solver(n_f=64, **kw):
    rng = np.random.default_rng(0)
    s = PINNSolver(layers=2, layers_1=2, hidden_size=8, hidden_size_1=8, N_f=n_f,
                   device="cpu", **kw)
    s.set_boundary_data(X=tuple(rng.uniform(size=(16, 1)) for _ in range(4)))
    s.set_eq_training_data(X=(rng.uniform(size=(n_f, 1)), rng.uniform(size=(n_f, 1))))
    return s


class _Lines:
    """A logger that keeps its lines."""

    def __init__(self, lines):
        self.lines = lines

    def info(self, msg):
        self.lines.append(msg)

    warning = error = info


def test_spans_nest_with_their_parents_chunks_and_steps():
    rec = Recorder()
    with rec.span("outside"):
        pass
    for n in (2, 3):
        with rec.chunk(n, 100):
            for _ in range(n):
                with rec.step():
                    with rec.span("kernel.a"), rec.span("inner"):
                        pass
    spans = rec.spans()
    by = {s.seq: s for s in spans}
    assert [s.seq for s in spans] == list(range(len(spans)))
    assert spans[0][1:] == ("outside",) + spans[0][2:4] + (-1, -1, 0)
    chunks = [s for s in spans if s.name == "solver.chunk"]
    assert [(c.chunk, c.step, c.parent) for c in chunks] == [(0, 0, -1), (1, 0, -1)]
    first = [s for s in spans if s.name == "setup.first_step"]
    assert len(first) == 1 and by[first[0].parent].name == "solver.chunk"
    steps = [s for s in spans if s.name == "step"]
    assert [(s.chunk, s.step) for s in steps] == [(0, 1), (0, 2), (1, 1), (1, 2), (1, 3)]
    assert by[steps[0].parent].name == "setup.first_step"
    assert all(by[s.parent].name == "solver.chunk" for s in steps[1:])
    for s in spans:
        if s.name in ("kernel.a", "inner"):
            parent = by[s.parent]
            assert parent.name == ("step" if s.name == "kernel.a" else "kernel.a")
            assert (s.chunk, s.step) == (parent.chunk, parent.step)
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    recs = rec.chunks()
    assert [(c.id, c.n_steps, c.points, c.device_ns, c.profiled) for c in recs] == [
        (0, 2, 100, None, False), (1, 3, 100, None, False)]
    assert all(c.host_ns == c.end_ns - c.start_ns > 0 for c in recs)
    assert rec.chunks(since=0) == recs[1:]


def test_head_steps_are_steps_2_to_4_of_each_chunk():
    rec = Recorder(capacity=64)
    for n in (5, 1, 3):
        with rec.chunk(n, 10):
            for _ in range(n):
                with rec.step(), rec.span("kernel.a"):
                    pass
    spans = rec.spans()
    want = lambda chunks: [s.end_ns - s.start_ns for s in spans if s.name == "step"
                           and s.chunk in chunks and s.step in (2, 3, 4)]
    assert len(want({0, 1, 2})) == 5  # three of chunk 0, none of 1, two of 2
    assert rec.head_steps() == want({0, 1, 2})
    assert rec.head_steps(since=0) == want({1, 2})
    assert rec.head_steps(since=2) == []
    for _ in range(64):  # the ring forgets the chunks' spans; their records stay
        with rec.span("x"):
            pass
    assert len(rec.chunks()) == 3 and rec.head_steps() == []


@pytest.mark.parametrize("grain", ["coarse", "fine"])
def test_the_log_line_reads_the_head_steps(grain):
    """The `perf:` line's host= is the median of the interval's steps 2-4,
    not its chunks' enqueue time; device= is n/a on the CPU."""
    s = _solver(log_interval=6, checkpoint_freq=10**6)
    lines = []
    s.logger = _Lines(lines)
    block = profiling.tracing if grain == "fine" else (lambda: profiling.NULL)
    with block():
        s.train(num_epoch=12, lr=1e-3)
    perf = [ln for ln in lines if "perf:" in ln]
    assert len(perf) == 3  # steps 1, 6 and 12
    assert "host=n/a device=n/a" in perf[0]  # a 1-step chunk has no steps 2-4
    last = profiling.chunks()[-1]
    assert last.n_steps == 6
    want = np.median(profiling.head_steps(since=last.id - 1)) / 1e6
    assert f"host={want:.3f} ms/step device=n/a" in perf[-1]


@pytest.mark.parametrize("mode", ["off", "tracing", "profiler"])
def test_fine_spans_only_while_tracing(mode, tmp_path):
    s = _solver()
    s.run_steps(1, 1e-3)
    block = {"off": lambda: profiling.NULL, "tracing": profiling.tracing,
             "profiler": lambda: torch_trace(str(tmp_path), cuda=False)}[mode]
    with block():
        s.run_steps(2, 1e-3)
    last = profiling.chunks()[-1]
    names = [x.name for x in profiling.spans() if x.chunk == last.id]
    fine = {"loss.evm_net", "loss.equation", "loss.boundary", "step.backward", "step.adam"}
    assert names.count("step") == 2 and names.count("solver.chunk") == 1
    if mode == "off":
        assert not fine & set(names)
    else:
        assert all(names.count(n) == 2 for n in fine), names
    assert last.profiled == (mode == "profiler")
    s.run_steps(1, 1e-3)  # after the block: off again
    after = profiling.chunks()[-1]
    assert not fine & {x.name for x in profiling.spans() if x.chunk == after.id}


def test_the_buffer_stays_bounded():
    rec = Recorder()
    ring = rec._ring
    for _ in range(10**5):
        with rec.span("x"):
            pass
    for _ in range(profiling.CHUNK_CAPACITY + 10):
        with rec.chunk(1, 1):
            pass
    n = 10**5 + profiling.CHUNK_CAPACITY + 10
    assert rec._ring is ring and len(ring) == profiling.CAPACITY
    spans = rec.spans()
    assert len(spans) == profiling.CAPACITY and spans[-1].seq == n - 1
    assert [s.seq for s in spans] == list(range(n - profiling.CAPACITY, n))
    chunks = rec.chunks()
    assert len(chunks) == profiling.CHUNK_CAPACITY and chunks[0].id == 10


def test_counters_and_the_registered_launch_counters():
    rec = Recorder()
    rec.count("a")
    rec.count("a", 4)
    rec.count("b", 2)
    d = {"k": 3}
    rec.register("launches", d)
    rec.register("launches", d)
    assert rec.counts() == {"a": 5, "b": 2, "launches.k": 3}
    d["k"] = 0
    assert rec.counts()["launches.k"] == 0
    # the kernels' own dicts, read where they are kept
    got = profiling.counts()
    for name in fr.launch_counts:
        assert got[f"launches.{name}"] == fr.launch_counts[name]
        assert got[f"launch_rows.{name}"] == fr.launch_rows[name]
    assert {"launches.mlp_streams_fwd", "launches.psi_streams_bwd"} <= set(got)
    fr.launch_counts["fused_residual_fwd"] += 7
    try:
        assert profiling.counts()["launches.fused_residual_fwd"] == \
            fr.launch_counts["fused_residual_fwd"]
    finally:
        fr.launch_counts["fused_residual_fwd"] -= 7


def test_a_library_build_and_load_count_apart(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do [ "$1" = "-o" ] && touch "$2"; '
                    'shift; done\necho built\n')
    nvcc.chmod(0o755)
    loaded = []
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_lib_path", lambda name: tmp_path / f"lib{name}.so")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: loaded.append(path) or path)
    logged = []
    monkeypatch.setattr(_build, "get_logger", lambda: _Lines(logged))
    (tmp_path / "libmlp_streams.so").write_bytes(b"")  # built before
    before = profiling.counts()
    n_spans = len([s for s in profiling.spans() if s.name == "setup.library"])
    _build.build_all(["fused_residual", "mlp_streams"])
    _build.build_all(["fused_residual"])  # loaded: no span, no count
    after = profiling.counts()
    assert after.get("library_builds", 0) - before.get("library_builds", 0) == 1
    assert "library_loads" not in after
    assert len(loaded) == 2
    # the build is logged with the process's count; a load alone is not
    assert len(logged) == 1 and logged[0].startswith("nvcc built 1 kernel libraries "
                                                     "(fused_residual) in ")
    assert logged[0].endswith(f"library_builds={after['library_builds']}")
    assert len([s for s in profiling.spans() if s.name == "setup.library"]) == n_spans + 1


def test_the_trace_shares_the_spans_clock(tmp_path):
    """The exported `nsfnet.step` range, at ts * 1000 + baseTimeNanoseconds,
    lies inside the recorded span, within 1 ms of either end."""
    s = _solver()
    s.run_steps(1, 1e-3)
    with torch_trace(str(tmp_path), cuda=False):
        s.run_steps(3, 1e-3)
    trace = _trace_events(tmp_path)
    base = int(trace["baseTimeNanoseconds"])
    ranges = sorted((float(e["ts"]), float(e["dur"])) for e in trace["traceEvents"]
                    if e.get("name") == "nsfnet.step" and e.get("ph") == "X")
    last = profiling.chunks()[-1]
    steps = [x for x in profiling.spans() if x.name == "step" and x.chunk == last.id]
    assert len(ranges) == len(steps) == 3
    for sp, (ts, dur) in zip(steps, ranges):
        a = ts * 1000 + base
        b = a + dur * 1000
        assert sp.start_ns <= a + 2000 and b <= sp.end_ns + 2000  # us rounding of ts, dur
        assert a - sp.start_ns < 1e6 and sp.end_ns - b < 1e6


def test_a_cpu_chunk_records_its_steps_and_no_device_time():
    s = _solver()
    profiling.RECORDER.clear()
    s.run_steps(4, 1e-3)
    (chunk,) = profiling.chunks()
    assert (chunk.n_steps, chunk.points, chunk.device_ns, chunk.profiled) == (4, 64 + 16, None,
                                                                              False)
    spans = profiling.spans()
    steps = [x for x in spans if x.name == "step"]
    assert [(x.chunk, x.step) for x in steps] == [(chunk.id, i) for i in (1, 2, 3, 4)]
    (first,) = [x for x in spans if x.name == "setup.first_step"]
    assert first.start_ns <= steps[0].start_ns and steps[0].end_ns <= first.end_ns
    assert sum(x.end_ns - x.start_ns for x in steps) <= chunk.host_ns


def test_set_up_spans_of_a_solver():
    profiling.RECORDER.clear()
    s = _solver()
    s.run_steps(1, 1e-3)
    s.run_steps(1, 1e-3)  # ready: no second set-up
    names = [x.name for x in profiling.spans() if x.name.startswith("setup.")]
    assert names == ["setup.solver", "setup.data", "setup.data", "setup.ready",
                     "setup.first_step"]
    s.set_alpha_evm(0.02)
    s.set_coordinate_transform(2.0)
    s.run_steps(1, 1e-3)  # dirty: the batch and step are built again
    assert [x.name for x in profiling.spans() if x.name.startswith("setup.")][-1] == \
        "setup.ready"


@pytest.mark.gpu
def test_a_chunk_times_the_card():
    """On the card: a chunk's device ns is positive and no longer than the
    host's time from the chunk's start to the synchronisation after it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    s = PINNSolver(layers=2, layers_1=2, hidden_size=16, hidden_size_1=8, N_f=1024,
                   device="cuda")
    rng = np.random.default_rng(0)
    s.set_boundary_data(X=tuple(rng.uniform(size=(64, 1)) for _ in range(4)))
    s.set_eq_training_data(X=(rng.uniform(size=(1024, 1)), rng.uniform(size=(1024, 1))))
    s.run_steps(2, 1e-3)
    torch.cuda.synchronize()
    s.run_steps(20, 1e-3)
    torch.cuda.synchronize()
    synced = time.time_ns()
    last = profiling.chunks()[-1]
    assert last.n_steps == 20 and last.device_ns is not None
    assert 0 < last.device_ns <= synced - last.start_ns
