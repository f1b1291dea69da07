"""msgpack pytree checkpoints, port of ``repro.checkpoint.msgpack_ckpt``:
the same file format, written and read with the port's own codec
(``msgpack_codec``), so no ``msgpack`` package is needed.

Leaves are ``{"__leaf__": True, "dtype", "shape", "data"}`` (numpy's
dtype string, e.g. ``"<f4"``, or ``"bfloat16"``; the raw bytes); lists
and tuples are ``{"__list__": [...], "__tuple__": bool}``; dicts are
maps.  Leaves may be numpy arrays, numbers or tensors (copied to the
host); they load as numpy arrays, except ``bfloat16`` leaves, which numpy
has no type for: those load as ``torch.bfloat16`` tensors, through
``torch.frombuffer`` on the raw bytes.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from . import msgpack_codec

_LEAF_KEY = "__leaf__"


def _leaf(x) -> dict:
    if torch.is_tensor(x):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return {_LEAF_KEY: True, "dtype": "bfloat16",
                    "shape": list(t.shape),
                    "data": t.view(torch.int16).numpy().tobytes()}
        x = t.numpy()
    arr = np.asarray(x)
    dtype = "bfloat16" if arr.dtype.name == "bfloat16" else arr.dtype.str
    return {_LEAF_KEY: True, "dtype": dtype,
            "shape": [int(s) for s in arr.shape], "data": arr.tobytes()}


def _pack(tree):
    """A tree as the codec's nested maps, lists and leaves."""
    if isinstance(tree, dict):
        return {k: _pack(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {"__list__": [_pack(v) for v in tree],
                "__tuple__": isinstance(tree, tuple)}
    return _leaf(tree)


def _unpack(node):
    if isinstance(node, dict) and node.get(_LEAF_KEY):
        shape = tuple(node["shape"])
        if node["dtype"] == "bfloat16":
            return torch.frombuffer(bytearray(node["data"]),
                                    dtype=torch.bfloat16).reshape(shape)
        return np.frombuffer(node["data"],
                             dtype=np.dtype(node["dtype"])).reshape(
                                 shape).copy()
    if isinstance(node, dict) and "__list__" in node:
        vals = [_unpack(v) for v in node["__list__"]]
        return tuple(vals) if node.get("__tuple__") else vals
    if isinstance(node, dict):
        return {k: _unpack(v) for k, v in node.items()}
    return node


def bf16_safe_cast(tree):
    """The tree (dicts, lists, tuples) with every bf16 tensor leaf cast to
    f32, as the reference casts bf16 leaves before a save that numpy must
    read; other leaves as they are."""
    if isinstance(tree, dict):
        return {k: bf16_safe_cast(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(bf16_safe_cast(v) for v in tree)
    if torch.is_tensor(tree) and tree.dtype == torch.bfloat16:
        return tree.to(torch.float32)
    return tree


def write_atomic(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` through a ``.tmp`` file in the same
    directory (parents created), replaced into place."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def save_pytree(path: str, tree: Any) -> None:
    write_atomic(path, msgpack_codec.packb(_pack(tree)))


def load_pytree(path: str) -> Any:
    with open(path, "rb") as f:
        return _unpack(msgpack_codec.unpackb(f.read()))
