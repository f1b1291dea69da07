"""Train-state checkpoints (DESIGN.md §11: train -> save -> serve), port of
``repro.checkpoint.train_state``, in the JAX package's format.

``save_train_state`` writes the port's train state (``train_t2drl``'s,
single or batched) or exported policy in the JAX package's layout
(``bridge.train_state_to_numpy`` / ``policy_to_numpy``), so the JAX
package's ``load_train_state`` reads it; ``load_train_state`` reads a
file of either package and builds the port's state on the device
(``bridge.train_state_from_numpy`` / ``policy_from_numpy``).  The
payload is the reference's: ``{"format": 1, "meta": {...}, "state":
...}``, ``ModelParams`` as a single-entry map ``{"__nt__:ModelParams":
fields}`` (the tag rides in the key, which the leaf codec leaves as it
is).  The file is written atomically through a ``.tmp`` file.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch import bridge
from repro_torch.core.env import ModelParams

from . import msgpack_codec
from .msgpack_ckpt import _pack, _unpack, write_atomic

FORMAT_VERSION = 1
_NT_TAG = "__nt__:"
_NT_REGISTRY = {"ModelParams": ModelParams}
_POLICY_KEYS = {"actor", "ddqn", "cache"}


def _encode(node):
    """Registered NamedTuples as tagged maps (recursively)."""
    for name, cls in _NT_REGISTRY.items():
        if isinstance(node, cls):
            return {_NT_TAG + name: {k: _encode(v)
                                     for k, v in node._asdict().items()}}
    if isinstance(node, dict):
        return {k: _encode(v) for k, v in node.items()}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        raise TypeError(
            f"unregistered NamedTuple {type(node).__name__!r} in the "
            f"checkpoint tree; add it to train_state._NT_REGISTRY")
    if isinstance(node, (list, tuple)):
        return type(node)(_encode(v) for v in node)
    return node


def _decode(node):
    if isinstance(node, dict):
        if len(node) == 1:
            (key, fields), = node.items()
            if isinstance(key, str) and key.startswith(_NT_TAG):
                cls = _NT_REGISTRY[key[len(_NT_TAG):]]
                return cls(**{k: _decode(v) for k, v in fields.items()})
        return {k: _decode(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_decode(v) for v in node)
    return node


def _is_train_state(tree) -> bool:
    return isinstance(tree, dict) and "models" in tree


def _has_torch(tree) -> bool:
    if torch.is_tensor(tree) or isinstance(tree, torch.nn.Module):
        return True
    if isinstance(tree, dict):
        return any(_has_torch(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_has_torch(v) for v in tree)
    return False


def _port_tree(ts, cfg=None):
    """The JAX-layout numpy tree of what is saved: the port's train state
    or policy through the bridge; any other tree (a numpy tree, say) as
    it is."""
    if not _has_torch(ts):
        return ts
    if _is_train_state(ts):
        return bridge.train_state_to_numpy(ts, cfg)
    if isinstance(ts, dict) and set(ts) <= _POLICY_KEYS:
        return bridge.policy_to_numpy(ts)
    return ts


def save_train_state(path: str, ts: Any,
                     meta: Optional[Dict[str, Any]] = None, cfg=None) -> str:
    """Checkpoint a train state or policy to ``path``: the port's (from
    ``train_t2drl`` or ``export_policy``) in the JAX package's layout, or
    a numpy tree as it is.  ``meta``: JSON-safe scalars and strings
    stored beside it (returned by ``load_train_state``); ``cfg`` is
    checked against a train state's learner layout when given.  Returns
    the path."""
    payload = {"format": FORMAT_VERSION, "meta": dict(meta or {}),
               "state": _pack(_encode(_port_tree(ts, cfg)))}
    write_atomic(path, msgpack_codec.packb(payload))
    return path


def _load_payload(path: str):
    """``(tree, meta)`` of a checkpoint: the saved tree with numpy leaves
    and ``ModelParams`` rebuilt, in the JAX package's layout."""
    with open(path, "rb") as f:
        payload = msgpack_codec.unpackb(f.read())
    fmt = payload.get("format")
    if fmt != FORMAT_VERSION:
        raise ValueError(f"unsupported train-state checkpoint format {fmt!r} "
                         f"(expected {FORMAT_VERSION}) in {path}")
    return _decode(_unpack(payload["state"])), payload.get("meta", {})


def load_train_state(path: str, cfg=None, device=None):
    """Restore a checkpoint of either package as the port's ``(state,
    meta)`` on ``resolve_device(device)``: a train state through
    ``bridge.train_state_from_numpy`` (``cfg``, the port's ``T2DRLCfg``,
    is required: it says whether the learners are shared), an exported
    policy through ``bridge.policy_from_numpy``."""
    tree, meta = _load_payload(path)
    if _is_train_state(tree):
        if cfg is None:
            raise ValueError(f"{path} holds a train state: pass the "
                             "T2DRLCfg it was trained under")
        return bridge.train_state_from_numpy(tree, cfg, device), meta
    return bridge.policy_from_numpy(tree, device), meta
