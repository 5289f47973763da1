"""The readers of the program's own spans and chunk records
(host_ms_per_step.adam, host_launch_ms_per_step.adam,
idle_share_window.adam, setup_in_program_s) over synthetic records, with
nothing to read, on a program without the recorder, and after the CPU
rehearsal of a cell."""

import pytest

from benchmark import run
from nsfnet_tpu_torch.utils import profiling
from nsfnet_tpu_torch.utils.profiling import Chunk, Span

SPEC = run.load_json(run.ROOT, "BENCHMARK.json")
NEW = ["host_ms_per_step.adam", "host_launch_ms_per_step.adam", "idle_share_window.adam",
       "setup_in_program_s"]
MS = 1_000_000  # ns


def _records():
    """Set-up spans (setup.library inside setup.first_step), a warm-up
    chunk, two window chunks of 5 steps, a profiled chunk and a short one."""
    spans, chunks, seq = [], [], [0]

    def add(name, t0, t1, parent=-1, chunk=-1, step=0):
        spans.append(Span(seq[0], name, t0, t1, parent, chunk, step))
        seq[0] += 1
        return spans[-1].seq

    add("setup.solver", 0, 300 * MS)
    add("setup.data", 300 * MS, 400 * MS)
    add("setup.ready", 400 * MS, 500 * MS)
    c = add("solver.chunk", 500 * MS, 2000 * MS, chunk=0)
    first = add("setup.first_step", 500 * MS, 2000 * MS, parent=c, chunk=0, step=1)
    st = add("step", 500 * MS, 2000 * MS, parent=first, chunk=0, step=1)
    k = add("kernel.loss_fwd", 600 * MS, 1900 * MS, parent=st, chunk=0, step=1)
    add("setup.library", 610 * MS, 1800 * MS, parent=k, chunk=0, step=1)
    chunks.append(Chunk(0, 1, 10, 500 * MS, 2000 * MS, 1500 * MS, 2100 * MS, False))
    t = 3000 * MS
    for cid, profiled, n in ((1, False, 5), (2, False, 5), (3, False, 5), (4, True, 5),
                             (5, False, 2)):
        c = add("solver.chunk", t, t + n * 10 * MS, chunk=cid)
        for i in range(1, n + 1):
            host = (4 + i + cid) * MS  # steps 2-4: 8, 9, 10 ms (chunk 2); 9, 10, 11 (chunk 3)
            st = add("step", t, t + host, parent=c, chunk=cid, step=i)
            add("kernel.loss_fwd", t + MS, t + MS + 100_000, parent=st, chunk=cid, step=i)
            add("kernel.loss_bwd", t + 2 * MS, t + 2 * MS + 200_000 + i * 1000, parent=st,
                chunk=cid, step=i)
            t += host
        chunks.append(Chunk(cid, n, 10, t - 1, t, 1, (6 + cid) * n * MS, profiled))
        t += MS
    return spans, chunks


@pytest.fixture
def records(monkeypatch):
    spans, chunks = _records()
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    monkeypatch.setattr(profiling, "chunks", lambda since=-1: [c for c in chunks if c.id > since])
    return spans, chunks


def _trace_record(busy_per_step_us=7500.0, steps=10):
    config = run.load_json(run.HERE, "configs", "ev-nsfnet-re2000-6x80.json")
    device = [("k", "kernel", 1000.0 + i * 10_000.0, busy_per_step_us) for i in range(steps)]
    return {"device": device, "t0": 1000.0, "window_us": steps * 10_000.0, "steps": steps,
            "config": config}


def read(name, rec=None):
    return run.load_reader(name)(rec or _trace_record())


def test_the_entries_are_appended_for_both_cells():
    """In order after the metrics before them, each listing both cells (and
    whatever cells later changes add to it)."""
    names = [m["name"] for m in SPEC["per_layer"]]
    start = names.index(NEW[0])
    assert names[start:start + 4] == NEW
    for m in SPEC["per_layer"][start:start + 4]:
        assert {"ev6x80-adam", "ev6x160-adam"} <= set(m["workloads"])
    layers = {m["layer"] for m in SPEC["per_layer"][:start]}
    assert {m["layer"] for m in SPEC["per_layer"][start:start + 3]} <= layers  # named before


def test_readers_over_synthetic_records(records):
    # window: chunks 2 and 3 (chunk 1 is the warm-up; 4 is profiled; 5 is shorter)
    assert read("host_ms_per_step.adam") == pytest.approx(9.5)  # median of 8,9,10,9,10,11
    # launches: 0.1 + 0.2 + i * 1e-3 ms at steps 2-4 of both chunks
    assert read("host_launch_ms_per_step.adam") == pytest.approx(0.303)
    # card time a step: 8 ms (chunk 2), 9 ms (chunk 3): median 8.5; busy 7.5 ms
    assert read("idle_share_window.adam") == pytest.approx(100 * (1 - 7.5 / 8.5))
    # outermost set-up spans: solver 0.3 s, data 0.1, ready 0.1, first step 1.5
    assert read("setup_in_program_s") == pytest.approx(2.0)


@pytest.mark.parametrize("stem", ["streams", "psi"])
def test_the_launchers_of_every_kernel_pair_are_read(records, monkeypatch, stem):
    """kernel.streams_* (kernels 3+4) and kernel.psi_* (5+6) in place of
    kernel.loss_*: the same launch cost; other spans still not counted."""
    spans, _ = records
    moved = [s._replace(name=s.name.replace("kernel.loss_", f"kernel.{stem}_")) for s in spans]
    monkeypatch.setattr(profiling, "spans", lambda: moved)
    assert read("host_launch_ms_per_step.adam") == pytest.approx(0.303)


def test_the_device_trace_reader_finds_nothing_in_an_empty_trace(records):
    assert read("idle_share_window.adam", dict(_trace_record(), device=[])) is None


def test_readers_without_records_give_none(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: [])
    monkeypatch.setattr(profiling, "chunks", lambda since=-1: [])
    assert [read(n) for n in NEW] == [None] * 4
    # on the CPU: chunks with no device time
    _, chunks = _records()
    monkeypatch.setattr(profiling, "chunks", lambda since=-1: [c._replace(device_ns=None)
                                                               for c in chunks])
    assert read("idle_share_window.adam") is None


def test_a_program_without_the_recorder_gives_none(monkeypatch):
    monkeypatch.delattr(profiling, "chunks")
    monkeypatch.delattr(profiling, "spans")
    assert [read(n) for n in NEW] == [None] * 4


def test_the_cpu_rehearsal_records_what_the_readers_read():
    """A CPU run of a cell leaves the spans that the readers read. (run_cell
    calls the readers only beside a device trace, which a CPU run has not,
    so they are called here on the run's recorder.)"""
    profiling.RECORDER.clear()
    run.run_cell("ev6x80-adam", 2**31 + 3, 0.3, False, device="cpu", n_f=512, chunk_steps=4,
                 t0=0.0)
    host = read("host_ms_per_step.adam")
    setup = read("setup_in_program_s")
    assert host is not None and host > 0
    assert setup is not None and setup > 0
    assert read("idle_share_window.adam") is None  # no card time on the CPU
