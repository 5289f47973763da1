"""Weights and train states carried across frameworks.

Both packages keep the same (W[fan_in, fan_out], b[fan_out]) layout, so a
conversion is a copy: numpy arrays (for example, JAX-initialised weights
fetched with `np.asarray`) become port tensors and back. The tests use it
to run the two packages on the same weights.

A whole JAX train state, as read from the JAX package's checkpoint
(training/checkpoint.read_flax_msgpack: nested dicts, tuples keyed "0",
"1", ...), becomes the port's TrainState: the networks and both Adam
moments in the flat layout of models/mlp.py (models/kan.py for a KAN), the
update counts, the viscosity carry and the step counters. Shapes come from
the state itself, and so does the backbone: a layer of two leaves (W 2-D,
b 1-D) is an MLP layer, one of three (coef 3-D, w_base and w_sp 2-D) a KAN
layer; any other layer is refused. A Fourier MLP's tree is an ordinary
(W, b) tree whose first fan_in is num_ins + 2m.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from nsfnet_tpu_torch.models.kan import KanParams, flatten_kan
from nsfnet_tpu_torch.models.mlp import Params, flatten_params
from nsfnet_tpu_torch.training.state import AdamState, TrainState

NumpyParams = Tuple[Tuple[np.ndarray, ...], ...]


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


def kan_params_from_numpy(params: Sequence, device: torch.device | str = "cpu",
                         dtype=torch.float32) -> KanParams:
    """((coef, w_base, w_sp), ...) array-likes -> tensors on `device`."""
    return tuple(tuple(torch.as_tensor(np.array(a), dtype=dtype, device=device) for a in layer)
                 for layer in params)


def kan_params_to_numpy(params: KanParams) -> NumpyParams:
    """((coef, w_base, w_sp), ...) tensors -> numpy copies on the host."""
    return tuple(tuple(a.detach().cpu().numpy().copy() for a in layer) for layer in params)


_LEAF_NDIMS = {"mlp": (2, 1), "kan": (3, 2, 2)}


def _layers(tree: dict) -> Tuple[str, NumpyParams]:
    """A serialised per-layer tuple {"0": {"0": ..., "1": ...}, ...} -> (its
    backbone, the layers in order): (W, b) layers are "mlp", (coef, w_base,
    w_sp) layers "kan". Raises ValueError on a layer of neither form or on
    a tree that mixes them."""
    kinds, layers = set(), []
    for i in range(len(tree)):
        layer = tree.get(str(i))
        leaves = (tuple(layer[str(j)] for j in range(len(layer)))
                  if isinstance(layer, dict) and all(str(j) in layer for j in range(len(layer)))
                  else None)
        ndims = tuple(getattr(a, "ndim", None) for a in leaves) if leaves else None
        kind = next((k for k, nd in _LEAF_NDIMS.items() if nd == ndims), None)
        if kind is None:
            raise ValueError(f"layer {i} of the network tree is neither (W, b) nor (coef, "
                             f"w_base, w_sp): leaf dims {ndims}")
        kinds.add(kind)
        layers.append(leaves)
    if len(kinds) != 1:
        raise ValueError(f"the network tree mixes layer kinds {sorted(kinds)}" if kinds
                         else "the network tree has no layers")
    return kinds.pop(), tuple(layers)


def sizes_of(params: NumpyParams) -> Tuple[int, ...]:
    """Layer sizes (num_ins, hidden..., num_outs) of ((W, b), ...)."""
    return tuple([int(params[0][0].shape[0])] + [int(w.shape[1]) for w, _ in params])


def shapes_of(params: NumpyParams) -> Tuple[Tuple[Tuple[int, ...], ...], ...]:
    """Every leaf's shape, layer by layer: what a solver's net is compared
    with (models/mlp.MLP.leaf_shapes, models/kan.KAN.leaf_shapes)."""
    return tuple(tuple(tuple(int(d) for d in a.shape) for a in layer) for layer in params)


def arch_from_jax(tree: dict) -> dict:
    """The network shapes of a JAX state tree, in the metadata's words; a KAN
    (read from its layers) says so under "backbone"."""
    kind, main = _layers(tree["params"])
    if kind == "kan":  # grid and k are not in the shapes (their sum is)
        arch = {"backbone": "kan",
                "kan_width": [int(main[0][0].shape[0])] + [int(c.shape[1]) for c, _, _ in main]}
    else:  # no backbone key: an MLP's is the default
        sizes = sizes_of(main)
        arch = {"layers": len(sizes) - 2, "hidden_size": sizes[1], "num_ins": sizes[0]}
    if tree.get("params_evm"):
        evm = sizes_of(_layers(tree["params_evm"])[1])
        arch.update(layers_1=len(evm) - 2, hidden_size_1=evm[1])
    return arch


def train_state_from_jax(tree: dict, device: torch.device | str = "cpu"):
    """A JAX TrainState tree -> (TrainState, main-net leaf shapes, EVM-net
    leaf shapes or None, main backbone "mlp" | "kan"). The carry keeps the
    writer's rows (its padding included): the solver cuts and re-pads it to
    its own batch."""
    def flat(kind_layers):
        kind, layers = kind_layers
        if kind == "kan":
            return flatten_kan(kan_params_from_numpy(layers, device))
        return flatten_params(params_from_numpy(layers, device))

    def adam(opt: Optional[dict]) -> Optional[AdamState]:
        if not opt:
            return None
        return AdamState(flat(_layers(opt["mu"])), flat(_layers(opt["nu"])),
                         int(opt["count"]))

    kind, main = _layers(tree["params"])
    evm = _layers(tree["params_evm"]) if tree.get("params_evm") else None
    if evm is not None and evm[0] != "mlp":
        raise ValueError("the EVM net of the tree is not a (W, b) MLP")
    vtm = tree.get("vis_t_minus")
    state = TrainState(
        params=flat((kind, main)), params_evm=None if evm is None else flat(evm),
        opt_main=adam(tree["opt_main"]), opt_evm=adam(tree.get("opt_evm")),
        vis_t_minus=None if vtm is None else torch.as_tensor(
            np.array(vtm), dtype=torch.float32, device=device),
        step=int(tree["step"]), epoch_in_stage=int(tree["epoch_in_stage"]))
    return state, shapes_of(main), None if evm is None else shapes_of(evm[1]), kind
