"""The reference's `.pth` format for MLP weights (the port's copy of
nsfnet_tpu/utils/torch_import.py).

The reference saves each network as a bare `state_dict` of its `FCNet`
(ev-NSFnet/pinn_solver.py:755-759: `torch.save(net.state_dict(), f)` for
the main net and `f + '_evm'` for the EVM net), with keys
`layers.layer_<i>.weight` ([fan_out, fan_in], torch's layout) and
`layers.layer_<i>.bias` (ev-NSFnet/net.py:36-50). Here they become the
port's per-layer `((W, b), ...)` tuples with W [fan_in, fan_out]
(models/mlp.py), and back, so the reference's checkpoints replay through
`evaluate` / `test` and the port's nets replay in the reference's tooling.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import torch

_KEY = re.compile(r"^(?:module\.)?layers\.layer_(\d+)\.(weight|bias)$")


def state_dict_to_params(state_dict: Dict[str, object]):
    """An FCNet state_dict (a DDP `module.` prefix allowed) as
    `((W, b), ...)`, W transposed to [fan_in, fan_out], float32 CPU tensors."""
    layers: Dict[int, Dict[str, torch.Tensor]] = {}
    for key, value in state_dict.items():
        m = _KEY.match(key)
        if m is None:
            raise ValueError(f"unrecognized state_dict key {key!r} — expected "
                             "'layers.layer_<i>.weight|bias' (reference FCNet format)")
        layers.setdefault(int(m.group(1)), {})[m.group(2)] = torch.as_tensor(
            value, dtype=torch.float32).detach().cpu()
    params = []
    for idx in range(len(layers)):
        if idx not in layers or set(layers[idx]) != {"weight", "bias"}:
            raise ValueError(f"state_dict missing layer_{idx} weight/bias")
        w = layers[idx]["weight"].T.contiguous()  # torch [out, in] -> [in, out]
        b = layers[idx]["bias"]
        if w.dim() != 2 or b.dim() != 1 or w.shape[1] != b.shape[0]:
            raise ValueError(f"layer_{idx}: weight {tuple(w.shape)} inconsistent with "
                             f"bias {tuple(b.shape)}")
        params.append((w, b))
    return tuple(params)


def load_torch_params(path: str):
    """A reference `.pth` state_dict file as `((W, b), ...)`."""
    return state_dict_to_params(torch.load(path, map_location="cpu", weights_only=True))


def params_shapes(params) -> Tuple[Tuple[int, ...], ...]:
    return tuple(tuple(w.shape) for w, _ in params)


def params_to_state_dict(params):
    """`((W, b), ...)` as an FCNet state_dict: reference key names,
    [fan_out, fan_in] float32 CPU weights."""
    sd = {}
    for idx, (w, b) in enumerate(params):
        sd[f"layers.layer_{idx}.weight"] = torch.as_tensor(
            w, dtype=torch.float32).detach().cpu().T.contiguous()
        sd[f"layers.layer_{idx}.bias"] = torch.as_tensor(
            b, dtype=torch.float32).detach().cpu().clone()
    return sd


def save_torch_params(params, path: str, params_evm=None) -> str:
    """Write reference-format `.pth` file(s): the main net at `path` and the
    EVM net at `<path>_evm`, the reference's sibling convention
    (ev-NSFnet/pinn_solver.py:755-759)."""
    torch.save(params_to_state_dict(params), path)
    if params_evm is not None:
        torch.save(params_to_state_dict(params_evm), path + "_evm")
    return path
