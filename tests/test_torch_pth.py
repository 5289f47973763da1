"""PyTorch port: the reference's `.pth` format (utils/torch_import.py,
PINNSolver.save_torch / load_torch) against the JAX package's
(nsfnet_tpu/utils/torch_import.py, its solver's save_torch / load_torch):
files written by either load into the other to the same weights, bit for
bit; the DDP `module.` prefix is accepted; bad keys and shapes raise."""

import jax
import numpy as np
import pytest
import torch

from nsfnet_tpu.training.solver import PINNSolver as JaxSolver
from nsfnet_tpu.utils import torch_import as jax_ti
from nsfnet_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from nsfnet_tpu_torch.training.solver import PINNSolver
from nsfnet_tpu_torch.utils import torch_import as ti

torch.set_num_threads(2)

ARCH = dict(Re=100, layers=3, layers_1=2, hidden_size=12, hidden_size_1=8, N_f=64, seed=3)


def _numpy_params(seed, sizes):
    rng = np.random.default_rng(seed)
    return tuple((rng.standard_normal((i, o)).astype(np.float32),
                  rng.standard_normal(o).astype(np.float32))
                 for i, o in zip(sizes[:-1], sizes[1:]))


def _equal(got, want):
    assert len(got) == len(want)
    for (gw, gb), (ww, wb) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(gw), np.asarray(ww))
        np.testing.assert_array_equal(np.asarray(gb), np.asarray(wb))


def test_files_cross_between_the_packages(tmp_path):
    main, evm = _numpy_params(0, (2, 12, 12, 3)), _numpy_params(1, (2, 8, 1))
    # JAX writes, the port reads
    jax_ti.save_torch_params(main, str(tmp_path / "jax.pth"), evm)
    _equal(params_to_numpy(ti.load_torch_params(str(tmp_path / "jax.pth"))), main)
    _equal(params_to_numpy(ti.load_torch_params(str(tmp_path / "jax.pth_evm"))), evm)
    # the port writes, JAX reads; the state_dicts are equal key by key
    ti.save_torch_params(params_from_numpy(main), str(tmp_path / "port.pth"),
                         params_from_numpy(evm))
    _equal(jax_ti.load_torch_params(str(tmp_path / "port.pth")), main)
    _equal(jax_ti.load_torch_params(str(tmp_path / "port.pth_evm")), evm)
    a, b = torch.load(tmp_path / "jax.pth"), torch.load(tmp_path / "port.pth")
    assert list(a) == list(b) == [f"layers.layer_{i}.{k}" for i in range(3)
                                  for k in ("weight", "bias")]
    assert all(torch.equal(a[k], b[k]) and a[k].dtype == torch.float32 for k in a)


def test_ddp_prefix_and_bad_state_dicts():
    sd = jax_ti.params_to_state_dict(_numpy_params(2, (2, 5, 3)))
    ddp = {f"module.{k}": v for k, v in sd.items()}
    _equal(params_to_numpy(ti.state_dict_to_params(ddp)), jax_ti.state_dict_to_params(ddp))
    with pytest.raises(ValueError, match="unrecognized state_dict key"):
        ti.state_dict_to_params({**sd, "layers.layer_0.scale": torch.ones(3)})
    with pytest.raises(ValueError, match="missing layer_1"):
        ti.state_dict_to_params({k: v for k, v in sd.items() if k != "layers.layer_1.bias"})
    with pytest.raises(ValueError, match="inconsistent"):
        ti.state_dict_to_params({**sd, "layers.layer_1.bias": torch.zeros(4)})


def test_solvers_exchange_pth_files(tmp_path):
    js = JaxSolver(**ARCH, mesh_devices=1, checkpoint_path=str(tmp_path))
    ps = PINNSolver(**ARCH, device="cpu")
    assert not np.array_equal(params_to_numpy(ps.params())[0][0],
                              np.asarray(js.state.params[0][0]))
    js.save_torch(str(tmp_path / "from_jax.pth"))
    ps.load_torch(str(tmp_path / "from_jax.pth"))  # the _evm sibling read too
    _equal(params_to_numpy(ps.params()), jax.device_get(js.state.params))
    _equal(params_to_numpy(ps.params_evm()), jax.device_get(js.state.params_evm))
    assert ps.state.opt_main.count == 0 and float(ps.state.opt_main.mu.abs().max()) == 0.0

    ps2 = PINNSolver(**{**ARCH, "seed": 11}, device="cpu")
    ps2.save_torch(str(tmp_path / "from_port.pth"))
    js.load_torch(str(tmp_path / "from_port.pth"))
    _equal(jax.device_get(js.state.params), params_to_numpy(ps2.params()))
    _equal(jax.device_get(js.state.params_evm), params_to_numpy(ps2.params_evm()))
    # and back again: save_torch then load_torch is the identity
    ps2.save_torch(str(tmp_path / "again.pth"))
    ps.load_torch(str(tmp_path / "again.pth"))
    assert torch.equal(ps.state.params, ps2.state.params)
    assert torch.equal(ps.state.params_evm, ps2.state.params_evm)


def test_load_torch_guards(tmp_path):
    ps = PINNSolver(**ARCH, device="cpu")
    ps.save_torch(str(tmp_path / "net.pth"))
    wider = PINNSolver(**{**ARCH, "hidden_size": 16}, device="cpu")
    with pytest.raises(ValueError, match="imported net shapes"):
        wider.load_torch(str(tmp_path / "net.pth"))
    other_evm = PINNSolver(**{**ARCH, "hidden_size_1": 6}, device="cpu")
    with pytest.raises(ValueError, match="imported EVM shapes"):
        other_evm.load_torch(str(tmp_path / "net.pth"))
    # without the sibling the EVM net keeps its initialization
    fresh = PINNSolver(**{**ARCH, "seed": 5}, device="cpu")
    evm_before = fresh.state.params_evm.detach().clone()
    torch.save(torch.load(tmp_path / "net.pth"), tmp_path / "alone.pth")
    fresh.load_torch(str(tmp_path / "alone.pth"))
    assert torch.equal(fresh.state.params, ps.state.params)
    assert torch.equal(fresh.state.params_evm, evm_before)
    sf = PINNSolver(**ARCH, formulation="streamfunction", device="cpu")
    with pytest.raises(ValueError, match="velocity-formulation MLP"):
        sf.save_torch(str(tmp_path / "sf.pth"))
    kan = PINNSolver(Re=100, backbone="kan", layers_1=None, kan_width=(2, 4, 3), N_f=64,
                     device="cpu")
    with pytest.raises(ValueError, match="FCNet"):
        kan.load_torch(str(tmp_path / "net.pth"))
