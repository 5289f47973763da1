"""Full-train-state checkpoints on disk (port of
nsfnet_tpu/training/checkpoint.py).

Two formats are read:
  * the port's own: a `torch.save` blob (a zip file) of the flat train state;
  * the JAX package's: the flax msgpack serialisation of its TrainState
    pytree. This module decodes it in pure Python (no msgpack or flax
    package is needed): maps with string keys, tuples as maps keyed "0",
    "1", ..., and every array, 0-d scalars included, as msgpack ext type 1
    whose payload is itself msgpack `[shape, dtype name, raw bytes]`.
Both carry a JSON sidecar `<path>.json` with the run's metadata (step,
stage, architecture stamp, sampler state). A checkpoint is written
atomically and becomes visible only after its sidecar: a run killed while
writing never leaves a torn file as the newest one.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Optional

import numpy as np
import torch

ZIP_MAGIC = b"PK\x03\x04"  # torch.save's zip container
FLAX_NDARRAY_EXT = 1       # flax.serialization's ext code for an ndarray


def save_state(path: str, blob: dict, metadata: dict) -> None:
    """torch.save `blob` to `path` atomically: tmp file + fsync, then the
    sidecar, then the rename that makes the checkpoint visible."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.save(blob, f)
        f.flush()
        os.fsync(f.fileno())
    with open(path + ".json.tmp", "w") as f:
        json.dump(metadata, f, indent=2)
    os.replace(path + ".json.tmp", path + ".json")
    os.replace(tmp, path)


def load_metadata(path: str) -> Optional[dict]:
    """The sidecar `<path>.json`, or None where there is none."""
    meta_path = path + ".json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            return json.load(f)
    return None


def is_flax_msgpack(path: str) -> bool:
    """True for the JAX package's format, False for a torch.save blob;
    raises on anything else."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head == ZIP_MAGIC:
        return False
    if head and (0x80 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF)):
        return True
    raise ValueError(f"{path}: neither a torch.save checkpoint nor a flax msgpack "
                     f"checkpoint (first bytes {head!r})")


def read_flax_msgpack(path: str) -> dict:
    """The JAX package's checkpoint as nested dicts of numpy arrays, leaf for
    leaf what flax.serialization.msgpack_restore returns."""
    with open(path, "rb") as f:
        data = f.read()
    obj, end = _unpack(data, 0)
    if end != len(data):
        raise ValueError(f"{path}: {len(data) - end} bytes after the msgpack object")
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: the top level is not a msgpack map")
    return obj


def peek_architecture(path: str) -> Optional[dict]:
    """The main / EVM network shapes: layers, hidden_size and, where the run
    had an EVM net, layers_1 and hidden_size_1; a KAN adds "backbone" and
    "kan_width" (a JAX checkpoint's has no MLP keys). A JAX checkpoint gives them from its state itself
    (no template, no metadata; num_ins too); the port's flat vectors carry
    no shapes, so its sidecar gives them. None if the file cannot be read
    as a checkpoint."""
    from nsfnet_tpu_torch.models import convert

    try:
        if is_flax_msgpack(path):
            return convert.arch_from_jax(read_flax_msgpack(path))
    except (OSError, ValueError, KeyError):
        return None
    meta = load_metadata(path)
    if meta is None or "hidden_size" not in meta:
        return None
    keys = ("layers", "hidden_size", "layers_1", "hidden_size_1")
    if meta.get("backbone", "mlp") != "mlp":
        keys += ("backbone", "kan_width")
    return {k: meta[k] for k in keys if meta.get(k) is not None}


# ------------------------------------------------------------ msgpack decoding

_FIXED = {  # first byte -> (struct format, size) of a fixed-width scalar
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LEN = {1: ">B", 2: ">H", 4: ">I"}


def _length(data: bytes, pos: int, width: int):
    return struct.unpack_from(_LEN[width], data, pos)[0], pos + width


def _unpack(data: bytes, pos: int):
    """Decode one msgpack object at `pos`; returns (object, next position)."""
    b = data[pos]
    pos += 1
    if b <= 0x7F:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8F:
        return _map(data, pos, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _array(data, pos, b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        n = b & 0x1F
        return data[pos:pos + n].decode("utf-8"), pos + n
    if b == 0xC0:
        return None, pos
    if b in (0xC2, 0xC3):
        return b == 0xC3, pos
    if b in _FIXED:
        fmt, size = _FIXED[b]
        return struct.unpack_from(fmt, data, pos)[0], pos + size
    if b in (0xC4, 0xC5, 0xC6, 0xD9, 0xDA, 0xDB):  # bin8-32, str8-32
        n, pos = _length(data, pos, {0xC4: 1, 0xC5: 2, 0xC6: 4, 0xD9: 1, 0xDA: 2, 0xDB: 4}[b])
        raw = data[pos:pos + n]
        return (raw if b <= 0xC6 else raw.decode("utf-8")), pos + n
    if b in (0xDC, 0xDD):
        n, pos = _length(data, pos, 2 if b == 0xDC else 4)
        return _array(data, pos, n)
    if b in (0xDE, 0xDF):
        n, pos = _length(data, pos, 2 if b == 0xDE else 4)
        return _map(data, pos, n)
    if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
        return _ext(data, pos, 1 << (b - 0xD4))
    if b in (0xC7, 0xC8, 0xC9):  # ext8-32
        n, pos = _length(data, pos, {0xC7: 1, 0xC8: 2, 0xC9: 4}[b])
        return _ext(data, pos, n)
    raise ValueError(f"msgpack: unknown type byte 0x{b:02x} at offset {pos - 1}")


def _array(data: bytes, pos: int, n: int):
    out = []
    for _ in range(n):
        item, pos = _unpack(data, pos)
        out.append(item)
    return out, pos


def _map(data: bytes, pos: int, n: int):
    out: dict = {}
    for _ in range(n):
        key, pos = _unpack(data, pos)
        out[key], pos = _unpack(data, pos)
    return out, pos


def _ext(data: bytes, pos: int, n: int) -> Any:
    code = struct.unpack_from(">b", data, pos)[0]
    payload = data[pos + 1:pos + 1 + n]
    if code != FLAX_NDARRAY_EXT:
        raise ValueError(f"msgpack: ext type {code} is not flax's ndarray (type "
                         f"{FLAX_NDARRAY_EXT})")
    (shape, dtype, raw), used = _unpack(payload, 0)
    if used != len(payload):
        raise ValueError("msgpack: a flax ndarray payload has trailing bytes")
    arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)
    return arr, pos + 1 + n
