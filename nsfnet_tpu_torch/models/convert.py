"""Weights and train states carried across frameworks.

Both packages keep the same (W[fan_in, fan_out], b[fan_out]) layout, so a
conversion is a copy: numpy arrays (for example, JAX-initialised weights
fetched with `np.asarray`) become port tensors and back. The tests use it
to run the two packages on the same weights.

A whole JAX train state, as read from the JAX package's checkpoint
(training/checkpoint.read_flax_msgpack: nested dicts, tuples keyed "0",
"1", ...), becomes the port's TrainState: the networks and both Adam
moments in the flat layout of models/mlp.py, the update counts, the
viscosity carry and the step counters. Shapes come from the state itself.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from nsfnet_tpu_torch.models.mlp import Params, flatten_params
from nsfnet_tpu_torch.training.state import AdamState, TrainState

NumpyParams = Tuple[Tuple[np.ndarray, np.ndarray], ...]


def params_from_numpy(params: Sequence, device: torch.device | str = "cpu",
                      dtype=torch.float32) -> Params:
    """((W, b), ...) array-likes -> ((W, b), ...) tensors on `device`."""
    return tuple(
        (torch.as_tensor(np.array(w), dtype=dtype, device=device),
         torch.as_tensor(np.array(b), dtype=dtype, device=device))
        for w, b in params)


def params_to_numpy(params: Params) -> NumpyParams:
    """((W, b), ...) tensors -> ((W, b), ...) numpy arrays on the host
    (copies: later in-place updates of the tensors do not reach them)."""
    return tuple((w.detach().cpu().numpy().copy(), b.detach().cpu().numpy().copy())
                 for w, b in params)


def _layers(tree: dict) -> NumpyParams:
    """A serialised ((W, b), ...) tuple {"0": {"0": W, "1": b}, ...} in order."""
    return tuple((tree[str(i)]["0"], tree[str(i)]["1"]) for i in range(len(tree)))


def sizes_of(params: NumpyParams) -> Tuple[int, ...]:
    """Layer sizes (num_ins, hidden..., num_outs) of ((W, b), ...)."""
    return tuple([int(params[0][0].shape[0])] + [int(w.shape[1]) for w, _ in params])


def arch_from_jax(tree: dict) -> dict:
    """The network shapes of a JAX state tree, in the metadata's words."""
    main = sizes_of(_layers(tree["params"]))
    arch = {"layers": len(main) - 2, "hidden_size": main[1], "num_ins": main[0]}
    if tree.get("params_evm"):
        evm = sizes_of(_layers(tree["params_evm"]))
        arch.update(layers_1=len(evm) - 2, hidden_size_1=evm[1])
    return arch


def train_state_from_jax(tree: dict, device: torch.device | str = "cpu"):
    """A JAX TrainState tree -> (TrainState, main-net sizes, EVM-net sizes or
    None). The carry keeps the writer's rows (its padding included): the
    solver cuts and re-pads it to its own batch."""
    flat = lambda layers: flatten_params(params_from_numpy(layers, device))

    def adam(opt: Optional[dict]) -> Optional[AdamState]:
        if not opt:
            return None
        return AdamState(flat(_layers(opt["mu"])), flat(_layers(opt["nu"])),
                         int(opt["count"]))

    main = _layers(tree["params"])
    evm = _layers(tree["params_evm"]) if tree.get("params_evm") else None
    vtm = tree.get("vis_t_minus")
    state = TrainState(
        params=flat(main), params_evm=None if evm is None else flat(evm),
        opt_main=adam(tree["opt_main"]), opt_evm=adam(tree.get("opt_evm")),
        vis_t_minus=None if vtm is None else torch.as_tensor(
            np.array(vtm), dtype=torch.float32, device=device),
        step=int(tree["step"]), epoch_in_stage=int(tree["epoch_in_stage"]))
    return state, sizes_of(main), None if evm is None else sizes_of(evm)
