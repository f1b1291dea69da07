"""The mesh context and PartitionSpecs as DTensor placements (port of
``repro.nn.sharding``).

The mesh is threaded through an explicit thread-local context, as the
reference threads its own, so that model code reaches the mesh only where
a caller set one (``use_mesh``) and single-device runs see none.  A mesh
here is a ``torch.distributed.device_mesh.DeviceMesh`` over ranks that
were started one process each (``repro_torch.launch.mesh``); code on it
works SPMD: every rank runs the same function on its own share.

A PartitionSpec (``P``, a tuple: one entry per tensor dimension, each
``None``, a mesh dimension's name, or a tuple of names) becomes DTensor
placements (``placements``): for each mesh dimension ``Shard(d)`` where
the spec names it on tensor dimension ``d``, else ``Replicate()``.  A
tuple entry such as ``("data", "model")`` puts both mesh dimensions on
one tensor dimension, the first the major one, as in JAX; its names must
come in the mesh's order.  ``fit_spec`` drops the mesh dimensions that do
not divide their tensor dimension, as the reference does.

Parameters, optimizer moments, batches and caches are DTensors with the
placements of their fitted specs (``distribute``, ``meta_dtensor``).
Activations cross the reference's ``constrain`` points as
``redistribute`` calls.  A mixer (attention, MLA, the SSD, the MoE's
experts) runs on local shards between the ``constrain`` calls that bound
it (``Region``), so a kernel never sees a DTensor.  Without a current
mesh, or on plain tensors, every function here is a no-op.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

_state = threading.local()


class P(tuple):
    """A PartitionSpec: ``P(None, "model")``, ``P(("data", "model"))``;
    dimensions past its length are unsharded."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


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


def axis_names(mesh) -> tuple:
    """The mesh's dimension names (a ``DeviceMesh``'s
    ``mesh_dim_names``, or a duck mesh's ``axis_names``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> dict:
    """{name: size} of the mesh's dimensions (a duck mesh may give its
    ``shape`` as that dict, as JAX's ``Mesh.shape`` is)."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(axis_names(mesh), tuple(shape)))


def batch_axes(mesh: Optional[object] = None) -> tuple:
    """The mesh dimensions the batch is split over, ``"pod"`` first where
    present, of ``mesh`` or else the current mesh; ``()`` without one."""
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None:
        return ()
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def fit_spec(spec, shape, mesh) -> P:
    """Drop mesh axes that do not evenly divide their dim.  For tuple
    entries the longest dividing prefix is kept.  Dims beyond
    ``len(spec)`` are left unsharded (PartitionSpec semantics)."""
    sizes = axis_sizes(mesh)
    new = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            new.append(None)
            continue
        keep, prod = [], 1
        for a in _axes(entry):
            if shape[i] % (prod * sizes[a]) == 0:
                keep.append(a)
                prod *= sizes[a]
            else:
                break
        new.append(tuple(keep) if len(keep) > 1
                   else (keep[0] if keep else None))
    return P(*new)


def placements(spec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: per mesh dimension
    ``Shard(d)`` where the spec names it on tensor dim ``d``, else
    ``Replicate()``.  The one map from specs to placements."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        idx = [names.index(a) for a in _axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} names mesh dimensions "
                             f"out of the mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec!r} names {names[i]!r} twice")
            out[i] = Shard(d)
    return tuple(out)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x, spec):
    """``x`` redistributed to the placements of ``spec`` fitted to its
    shape, iff a mesh is current and ``x`` is a DTensor; else ``x``."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    pl = placements(fit_spec(spec, x.shape, mesh), mesh)
    if tuple(x.placements) == pl:
        return x
    return local_contiguous(x.redistribute(mesh, pl))


def local_contiguous(x):
    """``x`` with a contiguous local shard where it is a DTensor: an
    uneven shard on the way (DTensor pads it) may leave a padded stride,
    which DTensor's views of the local shard refuse."""
    if is_dtensor(x) and not x._local_tensor.is_contiguous():
        return x.clone(memory_format=torch.contiguous_format)
    return x


def batch_spec(*rest) -> P:
    """PartitionSpec with leading batch dim over ('pod','data')."""
    ba = batch_axes()
    lead = ba if len(ba) != 1 else ba[0]
    return P(lead if ba else None, *rest)


def shard_batch_act(x, *rest):
    """Constrain activation whose dim0 is batch; rest are explicit axes."""
    return constrain(x, batch_spec(*rest))


def named_sharding(spec) -> Optional[tuple]:
    """The placements of ``spec`` over the current mesh (``None``
    without one)."""
    mesh = current_mesh()
    if mesh is None:
        return None
    return placements(spec, mesh)


def tree_map_specs(fn, specs, *trees):
    """``fn(spec, *leaves)`` over a tree of dicts and lists whose leaves
    are ``P``s, with ``trees`` of the same layout."""
    if isinstance(specs, dict):
        return {k: tree_map_specs(fn, specs[k], *(t[k] for t in trees))
                for k in specs}
    if isinstance(specs, list):
        return [tree_map_specs(fn, s, *ts) for s, *ts in
                zip(specs, *trees)]
    return fn(specs, *trees)


def make_param_shardings(specs):
    """Map a PartitionSpec tree to a tree of placements over the current
    mesh (``None`` without one)."""
    mesh = current_mesh()
    if mesh is None:
        return None
    return tree_map_specs(lambda s: placements(s, mesh), specs)


# -- DTensors from specs ---------------------------------------------------------

def distribute(t: torch.Tensor, spec, mesh):
    """A DTensor of the whole tensor ``t``, which every rank holds alike,
    with the placements of ``spec`` fitted to its shape: each rank keeps
    a copy of its own shard (no communication)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    pl = placements(fit_spec(spec, t.shape, mesh), mesh)
    d = distribute_tensor(t.detach(), mesh, pl, src_data_rank=None)
    # the shard in storage of its own: ``t`` may be freed after
    return DTensor.from_local(d.to_local().clone(), mesh, pl,
                              run_check=False)


def local_shape(shape, pl, mesh) -> tuple:
    """The shape of one rank's shard of an evenly sharded ``shape``."""
    from torch.distributed.tensor import Shard
    out = list(shape)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            n = mesh.size(i)
            if out[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                                 f"split over {n}")
            out[p.dim] //= n
    return tuple(out)


def meta_dtensor(shape, dtype, spec, mesh):
    """A DTensor of global ``shape`` whose shard is a meta tensor (no
    storage), with the placements of ``spec`` fitted to ``shape``."""
    from torch.distributed.tensor import DTensor
    pl = placements(fit_spec(spec, shape, mesh), mesh)
    loc = torch.empty(local_shape(shape, pl, mesh), dtype=dtype,
                      device="meta")
    return DTensor.from_local(loc, mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def replicate_like(t, x):
    """The plain tensor ``t``, which every rank computes alike, as a
    replicated DTensor on ``x``'s mesh where ``x`` is a DTensor."""
    if not is_dtensor(x) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def gather_dim(x, dim: int):
    """``x`` with tensor dim ``dim`` replicated (its other placements
    kept); a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim else p
               for p in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(
        x.device_mesh, pl)


def split_last(x, n: int, d: int):
    """``x`` (..., n·d) reshaped to (..., n, d); a DTensor whose last dim
    is sharded over a mesh dimension that does not divide ``n`` is
    gathered on it first."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard
        last = x.dim() - 1
        mesh = x.device_mesh
        pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == last
                   and n % mesh.size(i) else p
                   for i, p in enumerate(x.placements))
        if pl != tuple(x.placements):
            x = x.redistribute(mesh, pl)
    return x.reshape(x.shape[:-1] + (n, d))


def like(x, ref):
    """``x`` with the placements of the DTensor ``ref`` (a plain ``ref``
    leaves ``x`` as it is)."""
    if not is_dtensor(ref) or not is_dtensor(x):
        return x
    if tuple(x.placements) == tuple(ref.placements):
        return x
    return x.redistribute(ref.device_mesh, ref.placements)


class Region:
    """A mixer's local region: the DTensors entering it are constrained
    to a spec and taken as local shards (``take``); its results leave as
    DTensors (``give``).  ``active`` is false off a mesh or for plain
    tensors, and then both are the identity.

    ``split`` are the mesh dimensions the region's work is divided over
    (those on which its leading activation, ``open``'s, is sharded).  A
    shard that is replicated on such a dimension is used by each rank for
    its own part of the work, so the gradient of its local copy is
    declared ``Partial`` there; elsewhere it keeps the forward's
    placement."""

    def __init__(self, x):
        self.active = current_mesh() is not None and is_dtensor(x)
        self.mesh = current_mesh()
        self.split = ()

    def open(self, x, spec):
        """Constrain the region's leading activation and take its local
        shard; the dimensions it is sharded on become ``split``."""
        if not self.active:
            return x
        from torch.distributed.tensor import Shard
        x = constrain(x, spec)
        self.split = tuple(i for i, p in enumerate(x.placements)
                           if isinstance(p, Shard))
        return x.to_local()

    def take(self, x, spec=None):
        """The local shard of ``x`` (constrained to ``spec`` first)."""
        if not self.active or not is_dtensor(x):
            return x
        from torch.distributed.tensor import Partial, Replicate
        if spec is not None:
            x = constrain(x, spec)
        elif any(p.is_partial() for p in x.placements):
            # a pending sum (a row-parallel product upstream) is reduced:
            # a partial shard is not this rank's value
            x = x.redistribute(self.mesh, tuple(
                Replicate() if p.is_partial() else p for p in x.placements))
        grad = tuple(Partial() if isinstance(p, Replicate)
                     and i in self.split else p
                     for i, p in enumerate(x.placements))
        return x.to_local(grad_placements=grad)

    def rows(self, t):
        """This rank's rows of a plain tensor whose dim 0 is the global
        batch, where the work is split over the batch axes."""
        if not self.active:
            return t
        idx, n = 0, 1
        for a in batch_axes(self.mesh):
            if self.sharded(a):
                size = axis_sizes(self.mesh)[a]
                idx, n = idx * size + self.mesh.get_local_rank(a), n * size
        b = t.shape[0] // n
        return t[idx * b:(idx + 1) * b]

    def groups_of_heads(self, ts, dim: int, n_heads: int, n_groups: int,
                        h_loc: int) -> list:
        """The groups this rank's heads read, of tensors ``ts`` holding
        all ``n_groups`` groups on ``dim``, where the ``n_heads`` heads are
        split over ``"model"`` (``h_loc`` a rank): head ``h`` reads group
        ``h // (n_heads / n_groups)``, so the rank's heads [a, a + h_loc)
        take a slice of the groups, or (where ``h_loc`` and the group size
        do not nest) one group per head.  Unchanged where the heads are
        whole or the groups already split."""
        if h_loc == n_heads or ts[0].shape[dim] != n_groups:
            return list(ts)
        a = self.local_index("model") * h_loc
        g = n_heads // n_groups
        idx = [(a + i) // g for i in range(h_loc)]
        lo, n = idx[0], idx[-1] + 1 - idx[0]
        if h_loc % n == 0 and idx == [lo + i // (h_loc // n)
                                      for i in range(h_loc)]:
            return [t.narrow(dim, lo, n) for t in ts]
        sel = torch.tensor(idx, device=ts[0].device)
        return [t.index_select(dim, sel) for t in ts]

    def local_index(self, name: str) -> int:
        """This rank's coordinate on mesh dimension ``name``."""
        return self.mesh.get_local_rank(name)

    def sharded(self, name: str) -> bool:
        """Whether the work is split over mesh dimension ``name``."""
        return (self.active and name in axis_names(self.mesh)
                and axis_names(self.mesh).index(name) in self.split)

    def give(self, t, pl: tuple):
        """The local result ``t`` as a DTensor of placements ``pl``."""
        if not self.active:
            return t
        from torch.distributed.tensor import DTensor
        # contiguous: DTensor's reshape of it views the local shard
        return DTensor.from_local(t.contiguous(), self.mesh, pl,
                                  run_check=False)

    def give_spec(self, t, spec):
        """``give`` with the placements of ``spec``, whose mesh axes the
        region shards on (fitting is the caller's)."""
        if not self.active:
            return t
        return self.give(t, placements(spec, self.mesh))

    def spec(self, *entries) -> P:
        """A batch-leading spec of the region's own split: ``"model"``
        entries kept only where the work is split over it, the batch
        axes only where it is."""
        ba = tuple(a for a in batch_axes(self.mesh)
                   if self.sharded(a))
        lead = ba if len(ba) != 1 else ba[0]
        return P(lead if ba else None,
                 *(e if e is None or self.sharded(e) else None
                   for e in entries))
