"""PyTorch port: the native sampler (data/native.py, native/pointgen.cpp
built by the port) against the JAX package's binding pointed at the same
library (NSFNET_POINTGEN_LIB), and the native sampling path of
data/cavity.py: draws, sort, SDF weights, residual-aware pools, the sampler
state's path switch, and a resume of a JAX native-sampler checkpoint.

Bitwise equality holds on one host only (the library is built with
-march=native), so every comparison here uses one library on this host.
The JAX binding caches its library (nsfnet_tpu/data/native.py:16-17): the
fixture sets and restores both caches and the variable, so no later JAX test
in the worker draws natively."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from nsfnet_tpu.data import native as jax_native
from nsfnet_tpu.data.cavity import CavityData as JaxCavityData
from nsfnet_tpu.training.solver import PINNSolver as JaxSolver
from nsfnet_tpu_torch.data import native
from nsfnet_tpu_torch.data.cavity import CavityData
from nsfnet_tpu_torch.training import checkpoint as ckpt
from nsfnet_tpu_torch.training.solver import PINNSolver

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIVE = os.path.join(ROOT, "artifacts", "re4000_live", "latest.ckpt")


@pytest.fixture
def jax_on_port_lib(monkeypatch):
    """The JAX binding loading the port's library; both caches restored after."""
    path = str(native.build())
    monkeypatch.setenv("NSFNET_POINTGEN_LIB", path)
    monkeypatch.setattr(jax_native, "_LIB", None)
    monkeypatch.setattr(jax_native, "_TRIED", False)
    assert jax_native.available()
    return path


def test_entry_points_bitwise_equal_to_the_jax_binding(jax_on_port_lib):
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.1, 1.1, (700, 2))
    ref = rng.uniform(0, 1, (90, 2))
    bounds = [[0.0, 1.0], [-2.0, 3.0]]
    for seed in (0, 7, 2**63 + 5):
        np.testing.assert_array_equal(native.lh_sample(333, bounds, seed),
                                      jax_native.lh_sample(333, bounds, seed))
    np.testing.assert_array_equal(native.min_distance(pts, ref),
                                  jax_native.min_distance(pts, ref))
    np.testing.assert_array_equal(native.sdf_weights(pts, 0.0, 1.0, 0.2, 5.0),
                                  jax_native.sdf_weights(pts, 0.0, 1.0, 0.2, 5.0))
    np.testing.assert_array_equal(native.sort_by_distance(pts, ref),
                                  jax_native.sort_by_distance(pts, ref))
    # box_boundary_distance has no wrapper in the JAX binding: its raw call
    out = np.empty(pts.shape[0])
    jax_native._load().box_boundary_distance(pts.shape[0], np.ascontiguousarray(pts),
                                             0.0, 1.0, out)
    np.testing.assert_array_equal(native.box_boundary_distance(pts, 0.0, 1.0), out)
    # the library is keyed by source, flags and host: a second build is a hit
    assert native.build() == native.library_path()


@pytest.mark.parametrize("sort,sdf,transform", [(True, True, False), (False, True, True),
                                                (True, False, True)])
def test_native_draws_equal_jax(jax_on_port_lib, sort, sdf, transform):
    kw = dict(N_f=300, sort_training_points=sort, sdf_enabled=sdf, coord_transform=transform,
              seed=13)
    mine, ref = CavityData(**kw, use_native=True), JaxCavityData(**kw, use_native=True)
    for d in (mine, ref):
        d.boundary_data()
    for _ in range(3):  # fresh draws keyed on the draw count
        a, b = mine.training_data(), ref.training_data()
        for u, w in zip(a, b):
            np.testing.assert_array_equal(u, w)
        if sdf:
            np.testing.assert_array_equal(mine.sdf_weights, ref.sdf_weights)
        assert mine.get_state() == ref.get_state()
    assert mine.get_state()["native"] is True and mine.get_state()["draws_next"] == 2


def test_native_rar_pools_equal_jax(jax_on_port_lib):
    kw = dict(N_f=200, sort_training_points=True, sdf_enabled=True, seed=21)
    mine, ref = CavityData(**kw, use_native=True), JaxCavityData(**kw, use_native=True)
    for d in (mine, ref):
        d.boundary_data()
        d.training_data()
    score = lambda x, y: np.sin(7 * x[:, 0]) * np.cos(5 * y[:, 0])
    a = mine.rar_training_data(score, pool_mult=3, top_frac=0.4)
    b = ref.rar_training_data(score, pool_mult=3, top_frac=0.4)
    for u, w in zip(a, b):
        np.testing.assert_array_equal(u, w)
    np.testing.assert_array_equal(mine.sdf_weights, ref.sdf_weights)
    state = json.loads(json.dumps(ref.get_state()))
    assert state == json.loads(json.dumps(mine.get_state())) and state["rar"]
    # the RAR draw replays from the state without scores, in either package
    again = CavityData(**kw)
    again.boundary_data()
    again.set_state(state)
    for u, w in zip(again.training_data(), b):
        np.testing.assert_array_equal(u, w)


def test_set_state_switches_the_path_both_ways(jax_on_port_lib):
    kw = dict(N_f=150, sort_training_points=True, sdf_enabled=True, seed=4)
    # a numpy-path state (the JAX package's numpy path) on a native dataset
    ref = JaxCavityData(**kw, use_native=False)
    ref.boundary_data()
    ref.training_data()
    want = ref.training_data()
    numpy_state = json.loads(json.dumps(ref.get_state()))
    assert numpy_state["native"] is False
    d = CavityData(**kw, use_native=True)
    d.boundary_data()
    d.set_state(numpy_state)
    assert d.use_native is False
    for u, w in zip(d.training_data(), want):
        np.testing.assert_array_equal(u, w)
    # a native-path state on a numpy dataset (the port's default)
    ref = JaxCavityData(**kw, use_native=True)
    ref.boundary_data()
    ref.training_data()
    want = ref.training_data()
    native_state = json.loads(json.dumps(ref.get_state()))
    d = CavityData(**kw)
    d.boundary_data()
    d.set_state(native_state)
    assert d.use_native is True
    for u, w in zip(d.training_data(), want):
        np.testing.assert_array_equal(u, w)
    np.testing.assert_array_equal(d.sdf_weights, ref.sdf_weights)
    assert d.get_state()["native"] is True


def test_committed_native_state_replays_as_in_jax(jax_on_port_lib):
    """artifacts/re4000_live/latest.ckpt's sampler state (configs/
    re4000_r4b.yaml's data: N_f 120,000, unsorted, SDF-weighted) replays the
    same 120,000 points in both packages."""
    state = ckpt.load_metadata(LIVE)["sampler"]
    assert state["native"] is True
    kw = dict(N_f=120_000, sort_training_points=False, sdf_enabled=True, sdf_min_weight=0.2,
              sdf_decay=5.0, seed=42)
    mine, ref = CavityData(**kw), JaxCavityData(**kw, use_native=True)
    for d in (mine, ref):
        d.boundary_data()
        d.set_state(state)
    for u, w in zip(mine.training_data(), ref.training_data()):
        np.testing.assert_array_equal(u, w)
    np.testing.assert_array_equal(mine.sdf_weights, ref.sdf_weights)


ARCH = dict(Re=100, layers=2, layers_1=2, hidden_size=16, hidden_size_1=8, N_f=128,
            alpha_evm=0.03, bc_weight=10, eq_weight=1, seed=9, evm_update_freq=2,
            log_interval=1, checkpoint_freq=10**9)
DATA = dict(N_f=128, sort_training_points=True, sdf_enabled=True, seed=6)


def test_port_resumes_a_jax_native_checkpoint(tmp_path, jax_on_port_lib):
    """A JAX solver trains on the native sampler's second draw and saves a
    `native: true` state; the port resumes it: the replayed points bit for
    bit, then 3 Adam steps within rtol 2e-5 of the JAX package's own resume
    (fp32 on both sides, each summing in its own order), and its next
    checkpoint says `native: true`."""
    jd = JaxCavityData(**DATA, use_native=True)
    js = JaxSolver(**ARCH, mesh_devices=1, matmul_precision="highest",
                   checkpoint_path=str(tmp_path / "jax"))
    js.attach_dataset(jd)
    js.set_boundary_data(X=jd.boundary_data())
    jd.training_data()
    draw = jd.training_data()  # draw 1: seeded native_seed + 7919
    js.set_eq_training_data(X=draw, weights=jd.sdf_weights)
    js.train(num_epoch=3, lr=1e-4)
    path = js.save("native.ckpt", directory=str(tmp_path))
    meta = ckpt.load_metadata(path)
    assert meta["sampler"]["native"] is True and meta["sampler"]["draws_next"] == 1

    runs = {}
    for name in ("jax", "port"):
        if name == "jax":
            d = JaxCavityData(**DATA, use_native=True)
            s = JaxSolver(**ARCH, mesh_devices=1, matmul_precision="highest",
                          checkpoint_path=str(tmp_path / "jax2"))
        else:
            d = port_data = CavityData(**DATA)
            s = PINNSolver(**ARCH, checkpoint_path=str(tmp_path / "port"), device="cpu")
        s.set_boundary_data(X=d.boundary_data())
        d.set_state(meta["sampler"])
        xy = d.training_data()
        for u, w in zip(xy, draw):
            np.testing.assert_array_equal(u, w)  # the writer's points, bit for bit
        s.set_eq_training_data(X=xy, weights=d.sdf_weights)
        s.load(path)
        s.train(num_epoch=6, lr=1e-4, resume_in_stage=True)
        runs[name] = s
    jh = np.asarray(runs["jax"]._loss_history)[:, 1:]
    ph = np.asarray([(m.total, m.equation, m.boundary, m.eq1, m.eq2, m.eq3, m.eq4)
                     for _, m in runs["port"].loss_history])
    assert jh.shape == ph.shape == (3, 7)
    np.testing.assert_allclose(ph, jh, rtol=2e-5, atol=1e-12)
    assert runs["port"].global_step == int(jax.device_get(runs["jax"].global_step)) == 6

    # the resumed port solver's next checkpoint stays on the native path
    runs["port"].attach_dataset(port_data)
    fmeta = ckpt.load_metadata(runs["port"].save("resumed.ckpt", directory=str(tmp_path)))
    assert fmeta["global_step"] == 6 and fmeta["sampler"]["native"] is True
