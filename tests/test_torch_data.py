"""PyTorch port: its own copies of the config schema, the cavity dataset
and the row padding agree with the JAX package's."""

import glob
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
