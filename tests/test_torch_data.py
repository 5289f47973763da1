"""PyTorch port: its own copies of the config schema, the cavity dataset
and the row padding agree with the JAX package's."""

import glob
import json
import os

import numpy as np
import pytest

from nsfnet_tpu.config import ConfigManager as JaxConfigManager
from nsfnet_tpu.data.cavity import CavityData as JaxCavityData
from nsfnet_tpu.parallel import mesh as jmesh
from nsfnet_tpu_torch.config import ConfigManager
from nsfnet_tpu_torch.data.cavity import CavityData
from nsfnet_tpu_torch.parallel import mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_every_config_parses_as_in_jax():
    paths = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))
    assert paths
    for p in paths:
        mine, ref = ConfigManager.from_file(p), JaxConfigManager.from_file(p)
        assert mine.to_dict() == ref.to_dict(), p
        assert mine.validate() == ref.validate(), p


def test_from_dict_and_unknown_keys():
    d = {"physics": {"Re": 2000, "typo": 1}, "training": {"N_f": 10,
         "training_stages": [{"alpha": 0.1, "epochs": 5, "lr": 1e-3, "bogus": 2}]}}
    mine, ref = ConfigManager.from_dict(d), JaxConfigManager.from_dict(d)
    assert mine.to_dict() == ref.to_dict()
    assert mine.unknown_keys == ref.unknown_keys == [
        "physics.typo", "training.training_stages[1].bogus"]


@pytest.mark.parametrize("sort,sdf,transform", [(False, True, False), (True, True, True),
                                                (False, False, True)])
def test_cavity_draw_matches_jax_numpy_path(sort, sdf, transform):
    kw = dict(N_f=700, sort_training_points=sort, sdf_enabled=sdf, coord_transform=transform,
              seed=12)
    mine, ref = CavityData(**kw), JaxCavityData(**kw, use_native=False)
    for a, b in zip(mine.boundary_data(), ref.boundary_data()):
        np.testing.assert_array_equal(a, b)
    for _ in range(2):  # repeated draws stay aligned
        for a, b in zip(mine.training_data(), ref.training_data()):
            np.testing.assert_array_equal(a, b)
        if sdf:
            np.testing.assert_array_equal(mine.sdf_weights, ref.sdf_weights)
        else:
            assert mine.sdf_weights is None
    assert mine.coord_scale == ref.coord_scale


def test_training_data_needs_boundary_first():
    with pytest.raises(RuntimeError):
        CavityData(N_f=10, seed=0).training_data()


@pytest.mark.parametrize("n,lane", [(1, 8), (2052, 8), (120_000, 32), (120_001, 32)])
def test_padding_matches_jax(n, lane):
    assert mesh.padded_size(n, 1, lane) == jmesh.padded_size(n, 1, lane)
    a = np.arange(6, dtype=np.float32).reshape(3, 2)
    np.testing.assert_array_equal(mesh.pad_rows(a, 5, 7.0), jmesh.pad_rows(a, 5, 7.0))


# ---- sampler state and residual-aware resampling (tests/test_data.py:132-299,
# numpy path; the JAX side pinned to use_native=False)

def _pair(**kw):
    kw = dict(dict(N_f=96, sort_training_points=False, seed=11), **kw)
    mine, ref = CavityData(**kw), JaxCavityData(**kw, use_native=False)
    mine.boundary_data()
    ref.boundary_data()
    return mine, ref


def _json(state):
    return json.loads(json.dumps(state))  # the trip through the JSON sidecar


def test_sampler_state_roundtrip_replays_draw_sequence():
    d, _ = _pair()
    d.training_data()                       # draw 0
    x1, y1 = d.training_data()              # draw 1: the "current" points
    state = _json(d.get_state())
    x2, y2 = d.training_data()              # draw 2
    r = CavityData(N_f=96, sort_training_points=False, seed=None)
    r.boundary_data()
    r.set_state(state)
    for a, b in zip((x1, y1, x2, y2), r.training_data() + r.training_data()):
        np.testing.assert_array_equal(a, b)
    assert state["native"] is False and state["draws_next"] == 1


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_sampler_state_replays_across_the_packages(writer):
    """A state written by one package replays bit for bit in the other,
    through a plain draw, a residual-aware draw and the draw after it."""
    score = lambda x, y: np.hypot(x - 0.3, y - 0.6).reshape(-1)
    mine, ref = _pair(sdf_enabled=True, coord_transform=True)
    w, r = (mine, ref) if writer == "port" else (ref, mine)
    w.training_data()
    states, draws = [], []
    for step in ("plain", "rar", "plain"):
        xy = (w.rar_training_data(score, pool_mult=3, top_frac=0.25) if step == "rar"
              else w.training_data())
        states.append(_json(w.get_state()))
        draws.append((xy, w.sdf_weights))
    for state, (xy, sdf) in zip(states, draws):
        r.set_state(state)
        got = r.training_data()  # the RAR draw replays without scores
        for a, b in zip(got, xy):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(r.sdf_weights, sdf)
        assert _json(r.get_state()) == state


def test_rar_keep_sets_match_jax():
    score = lambda x, y: (x + y).reshape(-1)  # favours the top-right corner
    mine, ref = _pair(N_f=64, seed=5, coord_transform=True)
    draws = []
    for _ in range(2):
        a = mine.rar_training_data(score, pool_mult=3, top_frac=0.5)
        b = ref.rar_training_data(score, pool_mult=3, top_frac=0.5)
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
        assert mine.get_state() == ref.get_state()
        draws.append(a)
    # with sorting off the kept block leads verbatim: the top-scored points
    # of the first pool, which a fresh twin loader's first raw draw gives
    twin = CavityData(N_f=64, sort_training_points=False, seed=5, coord_transform=True)
    pool = twin._raw_draw(3 * 64) * 2.0 - 1.0
    keep = np.sort(np.argpartition(-(pool[:, 0] + pool[:, 1]), 31)[:32])
    x, y = draws[0]
    np.testing.assert_array_equal(x[:32, 0], pool[keep, 0].astype(np.float32))
    np.testing.assert_array_equal(y[:32, 0], pool[keep, 1].astype(np.float32))


def test_rar_state_roundtrip_replays_without_scores():
    d, _ = _pair()
    d.training_data()
    x1, y1 = d.rar_training_data(lambda x, y: np.hypot(x, y).reshape(-1), pool_mult=2,
                                 top_frac=0.25)
    state = _json(d.get_state())
    x2, y2 = d.training_data()
    r = CavityData(N_f=96, sort_training_points=False, seed=None)
    r.boundary_data()
    r.set_state(state)
    x1b, y1b = r.training_data()
    assert _json(r.get_state())["rar"] == state["rar"]  # a second resume replays it too
    x2b, y2b = r.training_data()
    for a, b in ((x1, x1b), (y1, y1b), (x2, x2b), (y2, y2b)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [dict(pool_mult=0), dict(pool_mult=2, top_frac=0.0),
                                dict(pool_mult=2, top_frac=1.5),
                                dict(pool_mult=2, score=lambda x, y: np.zeros(3))])
def test_rar_argument_checks(kw):
    d, _ = _pair(N_f=32, seed=0)
    score = kw.pop("score", lambda x, y: np.zeros(x.shape[0]))
    with pytest.raises(ValueError):
        d.rar_training_data(score, **kw)


def test_stop_while_scoring_leaves_the_state_as_it_was():
    """The bookkeeping moves only after score_fn returns (a SIGTERM inside
    the scoring leaves get_state() describing the previous draw)."""
    d, _ = _pair()
    d.training_data()
    before = _json(d.get_state())

    def stopped(x, y):
        raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        d.rar_training_data(stopped, pool_mult=2)
    assert _json(d.get_state()) == before


def test_native_sampler_state_is_refused(monkeypatch, tmp_path):
    """A native-path state (the JAX package's native sampler) needs the
    native library: where it cannot be built (no C++ compiler here) it is
    refused before any point is drawn; with the compiler the dataset takes
    the native path (tests/test_torch_native.py holds its points)."""
    from nsfnet_tpu_torch.data import native

    state = json.load(open(os.path.join(ROOT, "artifacts", "re4000_ext",
                                        "final_state.ckpt.json")))["sampler"]
    assert state["native"] is True
    d, _ = _pair()
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)  # no library built yet
    monkeypatch.setenv("CXX", "no-such-compiler")
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        d.set_state(state)
    assert d.use_native is False and d.get_state()["native"] is False
    monkeypatch.delenv("CXX")
    d.set_state(state)
    assert d.use_native is True and d.get_state()["native"] is True
