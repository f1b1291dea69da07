"""The mesh context (port of ``repro.nn.sharding``'s context half).

The mesh is threaded through an explicit thread-local context, as the
reference threads its own, so that model code reaches the mesh only where
a caller set one (``use_mesh``) and single-device runs see none.  A mesh
here is a ``torch.distributed.device_mesh.DeviceMesh`` over ranks that
were started one process each (``repro_torch.launch.mesh``); code on it
works SPMD: every rank runs the same function on its own share.

The reference's other names map PartitionSpecs to shardings
(``fit_spec``, ``constrain``, ``batch_spec``, ``shard_batch_act``,
``named_sharding``, ``make_param_shardings``).  In torch those become
DTensor placements over the mesh, and they come with the parameter and
cache spec trees of the LM's mesh half (ROADMAP A.12 step 4).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

_state = threading.local()


def current_mesh():
    """The ``DeviceMesh`` set by the innermost ``use_mesh`` of this
    thread, or ``None``."""
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh``, or ``None`` for none) the current
    mesh of this thread inside the block."""
    prev = current_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def batch_axes(mesh: Optional[object] = None) -> tuple:
    """The mesh dimensions the batch is split over, ``"pod"`` first where
    present, of ``mesh`` or else the current mesh; ``()`` without one."""
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None:
        return ()
    names = mesh.mesh_dim_names or ()
    return tuple(a for a in ("pod", "data") if a in names)
