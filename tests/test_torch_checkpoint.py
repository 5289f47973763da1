"""PyTorch port: the checkpoint formats. The pure-Python reader of the JAX
package's flax-msgpack checkpoints against flax itself on the committed
checkpoints; the port's atomic writer and its sidecar; the committed Re=4000
h160 campaign checkpoint loaded into the port and into the JAX solver
(weights, predictions, counters, three Adam steps on the replayed points);
and residuals_at against the JAX solver's."""

import json
import os
import struct

import jax
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from nsfnet_tpu.training.solver import PINNSolver as JaxSolver
from nsfnet_tpu_torch.data.cavity import CavityData
from nsfnet_tpu_torch.models.convert import arch_from_jax, params_from_numpy, params_to_numpy
from nsfnet_tpu_torch.models.mlp import flatten_params
from nsfnet_tpu_torch.training import checkpoint as ckpt
from nsfnet_tpu_torch.training.solver import PINNSolver

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R4B = os.path.join(ROOT, "artifacts", "live_re4000_r4b", "latest.ckpt")
GENTLE = os.path.join(ROOT, "artifacts", "re4000_gentle", "final_state.ckpt")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("path", [R4B, GENTLE])
def test_reader_equals_flax_msgpack_restore(path):
    mine = ckpt.read_flax_msgpack(path)
    with open(path, "rb") as f:
        ref = serialization.msgpack_restore(f.read())
    got, want = dict(_leaves(mine)), dict(_leaves(ref))
    assert got.keys() == want.keys()
    for k, a in want.items():
        b = got[k]
        assert isinstance(b, np.ndarray) and b.dtype == a.dtype and b.shape == a.shape, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    assert ckpt.is_flax_msgpack(path)


def test_decoder_takes_every_msgpack_form():
    """Every form the reader claims, packed by the msgpack package."""
    arr = np.arange(6, dtype=np.float64).reshape(2, 3)
    payload = msgpack.packb([list(arr.shape), arr.dtype.name, arr.tobytes()], use_bin_type=True)
    obj = {
        "ints": [0, 127, -1, -32, -33, 128, 255, 256, 65535, 65536, 2**32, 2**63 + 5,
                 -128, -129, -32768, -32769, -2**31 - 1],
        "floats": [1.5, -2.25e300], "f32": msgpack.ExtType(1, payload),
        "nil": None, "bools": [True, False],
        "str8": "x" * 40, "str16": "y" * 300, "str32": "z" * 70000,
        "bin8": b"\x01" * 10, "bin16": b"\x02" * 300, "bin32": b"\x03" * 70000,
        "array16": list(range(20)), "array32": [7] * 70000,
        "map16": {str(i): i for i in range(20)},
        # a 16-byte payload: fixext 16
        "fixext": msgpack.ExtType(1, msgpack.packb([[6], "int8", b"\x05" * 6],
                                                   use_bin_type=True)),
    }
    big_map = {str(i): i for i in range(70000)}
    path_bytes = msgpack.packb({"m": obj, "map32": big_map}, use_bin_type=True)
    got, end = ckpt._unpack(path_bytes, 0)
    assert end == len(path_bytes)
    m = got["m"]
    assert m["ints"] == obj["ints"] and m["floats"] == obj["floats"]
    assert m["nil"] is None and m["bools"] == [True, False]
    for k in ("str8", "str16", "str32", "bin8", "bin16", "bin32", "array16", "array32",
              "map16"):
        assert m[k] == obj[k], k
    np.testing.assert_array_equal(m["f32"], arr)
    assert len(obj["fixext"].data) == 16
    np.testing.assert_array_equal(m["fixext"], np.full(6, 5, np.int8))
    assert got["map32"] == big_map
    # float32 and an ext code other than flax's ndarray
    f32, _ = ckpt._unpack(b"\xca" + struct.pack(">f", 0.25), 0)
    assert f32 == 0.25
    with pytest.raises(ValueError, match="ext type 2"):
        ckpt._unpack(msgpack.packb(msgpack.ExtType(2, b"ab")), 0)


def test_format_detection_and_atomic_save(tmp_path):
    path = str(tmp_path / "a" / "s.ckpt")
    ckpt.save_state(path, {"x": torch.ones(3)}, {"global_step": 7})
    assert sorted(os.listdir(tmp_path / "a")) == ["s.ckpt", "s.ckpt.json"]  # no tmp left
    assert ckpt.load_metadata(path) == {"global_step": 7}
    assert not ckpt.is_flax_msgpack(path)
    assert ckpt.load_metadata(str(tmp_path / "none.ckpt")) is None
    junk = tmp_path / "junk.ckpt"
    junk.write_bytes(b"\x00\x01\x02\x03")
    with pytest.raises(ValueError, match="neither"):
        ckpt.is_flax_msgpack(str(junk))
    assert ckpt.peek_architecture(str(junk)) is None


def test_peek_architecture_reads_the_state():
    assert ckpt.peek_architecture(R4B) == {"layers": 6, "hidden_size": 160, "num_ins": 2,
                                           "layers_1": 4, "hidden_size_1": 40}
    # the sidecar of this one has no EVM stamp: the state tells it
    assert "hidden_size_1" not in ckpt.load_metadata(GENTLE)
    assert ckpt.peek_architecture(GENTLE)["hidden_size_1"] == 40
    assert arch_from_jax(ckpt.read_flax_msgpack(GENTLE))["hidden_size"] == 80


ARCH_R4B = dict(Re=4000, layers=6, layers_1=4, hidden_size=160, hidden_size_1=40,
                alpha_evm=0.002, bc_weight=10, eq_weight=1, evm_update_freq=10000,
                log_interval=1, checkpoint_freq=10**9)
N_SUB = 512


def _replayed_subset():
    """The points the r4b campaign trained on at step 1,240,000 (its sampler
    state replays draw 1), first N_SUB of them, with their SDF weights."""
    meta = ckpt.load_metadata(R4B)
    d = CavityData(N_f=120_000, sort_training_points=False, sdf_enabled=True,
                   sdf_min_weight=0.2, sdf_decay=5.0, seed=42)
    bc = d.boundary_data()
    d.set_state(meta["sampler"])
    x, y = d.training_data()
    return bc, (x[:N_SUB], y[:N_SUB]), d.sdf_weights[:N_SUB]


def test_campaign_checkpoint_loads_as_in_jax(tmp_path):
    bc, xy, w = _replayed_subset()
    js = JaxSolver(**ARCH_R4B, N_f=N_SUB, mesh_devices=1, matmul_precision="highest",
                   checkpoint_path=str(tmp_path / "jax"))
    ps = PINNSolver(**ARCH_R4B, N_f=N_SUB, checkpoint_path=str(tmp_path / "port"), device="cpu")
    for s in (js, ps):
        s.set_boundary_data(X=bc)
        s.set_eq_training_data(X=xy, weights=w)
        s.load(R4B)
    assert js.global_step == ps.global_step == 1_240_000
    assert js.current_stage == ps.current_stage == "R2"
    assert int(js.state.epoch_in_stage) == ps.state.epoch_in_stage == 410_000
    assert int(js.state.opt_main.count) == ps.state.opt_main.count == 1_240_000
    assert int(js.state.opt_evm.count) == ps.state.opt_evm.count == 122
    np.testing.assert_array_equal(ps.state.vis_t_minus[:N_SUB].numpy(),
                                  np.asarray(js.state.vis_t_minus)[:N_SUB])

    for got, ref in ((ps.params(), js.state.params), (ps.params_evm(), js.state.params_evm)):
        for a, b in zip(params_to_numpy(got), jax.device_get(ref)):
            for t, r in zip(a, b):
                np.testing.assert_array_equal(t, r)  # the weights, bit for bit

    # predictions on an 8x8 grid: each package's fp32 GEMMs sum in their own
    # order, and each sits up to 1.4e-6 from a float64 evaluation of these
    # weights (v at |v| <= 0.36), so 1e-6 is below this net's fp32 rounding
    g = np.linspace(0.0, 1.0, 8, dtype=np.float32)
    gx, gy = (a.reshape(-1, 1) for a in np.meshgrid(g, g))
    for a, b in zip(ps.predict((gx, gy)), js.predict((gx, gy))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=2e-6)

    # three Adam steps of R2 from its restored epoch: the EVM gate fires at
    # epoch 410,000 (a multiple of evm_update_freq), then stays shut
    before = ps.state.params.detach().clone()
    for s in (js, ps):
        s.train(num_epoch=410_003, lr=2e-6, resume_in_stage=True)  # R2's lr
    assert ps.state.opt_evm.count == int(js.state.opt_evm.count) == 123
    # R2's lr moves a param by ~1e-5 in three steps; the two updates agree
    # norm-wise to 8.1e-3 (the gradient of this converged state is a small
    # difference of O(1) terms, summed in each package's order)
    jax_flat = flatten_params(params_from_numpy(jax.device_get(js.state.params)))
    step_p, step_j = ps.state.params.detach() - before, jax_flat - before
    assert step_j.abs().max() > 1e-5
    assert ((step_p - step_j).norm() / step_j.norm()).item() < 2e-2
    for got, ref in ((ps.params(), js.state.params), (ps.params_evm(), js.state.params_evm)):
        for (gw, gb), (rw, rb) in zip(params_to_numpy(got), jax.device_get(ref)):
            np.testing.assert_allclose(gw, rw, rtol=5e-4, atol=5e-6)
            np.testing.assert_allclose(gb, rb, rtol=5e-4, atol=5e-6)


@pytest.mark.parametrize("evm,formulation", [(True, "velocity"), (False, "velocity"),
                                             (True, "streamfunction")])
def test_residuals_at_matches_jax(tmp_path, evm, formulation):
    """The RAR score from JAX-initialised weights (coordinate transform on,
    the EVM viscosity included), in chunks with a ragged last one."""
    arch = dict(Re=400, layers=2, layers_1=2 if evm else None, hidden_size=16,
                hidden_size_1=8, N_f=64, alpha_evm=0.05, evm=evm, seed=4,
                formulation=formulation)
    js = JaxSolver(**arch, mesh_devices=1, checkpoint_path=str(tmp_path))
    ps = PINNSolver(**arch, device="cpu")
    ps.set_params(params_from_numpy(jax.device_get(js.state.params)),
                  params_from_numpy(jax.device_get(js.state.params_evm)) if evm else None)
    for s in (js, ps):
        s.set_coordinate_transform(2.0)
    rng = np.random.default_rng(1)
    px, py = rng.uniform(-1, 1, (2, 300, 1)).astype(np.float32)
    np.testing.assert_allclose(ps.residuals_at(px, py, chunk=128),
                               js.residuals_at(px, py, chunk=128), rtol=1e-5, atol=1e-7)


def test_port_checkpoint_sidecar_has_the_jax_keys(tmp_path):
    s = PINNSolver(**{**ARCH_R4B, "hidden_size": 16, "layers": 2, "hidden_size_1": 8,
                      "layers_1": 2}, N_f=64, device="cpu")
    d = CavityData(N_f=64, sort_training_points=False, seed=3)
    s.attach_dataset(d)
    s.set_boundary_data(X=d.boundary_data())
    s.set_eq_training_data(X=d.training_data(), weights=d.sdf_weights)
    path = s.save("x.ckpt", directory=str(tmp_path))
    meta = json.loads(open(path + ".json").read())
    assert set(meta) == {"global_step", "Re", "alpha_evm", "alpha_b", "stage", "layers",
                         "hidden_size", "backbone", "formulation", "layers_1",
                         "hidden_size_1", "sampler"}
    assert meta["sampler"]["native"] is False and meta["sampler"]["draws_next"] == 0
    assert "meta" not in torch.load(path, weights_only=True)  # the sidecar is the one source
    assert ckpt.peek_architecture(path) == {"layers": 2, "hidden_size": 16, "layers_1": 2,
                                            "hidden_size_1": 8}
    os.remove(path + ".json")
    with pytest.raises(ValueError, match="no sidecar"):
        s.load(path)
