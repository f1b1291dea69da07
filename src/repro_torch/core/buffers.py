"""Fixed-capacity cyclic replay buffers (port of ``repro.core.buffers``).

A buffer is ``{"data": {name: (capacity, ...) device tensor}, "ptr": int,
"size": int}``.  ``ptr`` and ``size`` are host ints: the episode's update
gates read them every slot, and a device int would cost a device read
each time.  Writes go in place into ``data`` (the JAX functions return a
new buffer; these return the same dict, updated).

B cells' buffers are one dict with a leading (B,) axis on every ``data``
leaf and per-cell host ints ``ptr`` and ``size`` (lists of B).  The
``*_batch`` helpers work cell by cell, as the reference's ``vmap`` of the
single-buffer functions; the ``*_stacked`` ones (the fused learners) do
one indexed gather or write per leaf for all B cells.  Either draws cell
b's minibatch indices from its own generator (or, given one generator,
every cell's from it in cell order), as ``buffer_sample`` draws them.
"""
from __future__ import annotations

import torch

from repro_torch.obs import profiling


def buffer_init(capacity: int, item_example: dict) -> dict:
    """Zeroed storage for ``capacity`` items shaped and typed like
    ``item_example`` (a dict of tensors), on the example's devices."""
    data = {k: torch.zeros((capacity,) + tuple(v.shape), dtype=v.dtype,
                           device=v.device)
            for k, v in item_example.items()}
    return {"data": data, "ptr": 0, "size": 0}


def _capacity(buf) -> int:
    return next(iter(buf["data"].values())).shape[0]


def buffer_add(buf: dict, item: dict) -> dict:
    """Write one item at ``ptr``; ``ptr`` wraps, ``size`` saturates."""
    ptr, cap = buf["ptr"], _capacity(buf)
    for k, d in buf["data"].items():
        d[ptr] = item[k]
    buf["ptr"] = (ptr + 1) % cap
    buf["size"] = min(buf["size"] + 1, cap)
    return buf


def buffer_add_many(buf: dict, items: dict) -> dict:
    """Append ``n`` items (leaves with a leading ``(n,)`` axis, oldest
    first) in one indexed write per leaf; equal to ``n`` successive
    ``buffer_add`` calls, wraparound included.  ``n`` may exceed the room
    left but not the capacity: duplicate write indices would make the rows
    that survive depend on the write order, so that is refused."""
    n = next(iter(items.values())).shape[0]
    cap = _capacity(buf)
    if n > cap:
        raise ValueError(f"buffer_add_many: cannot write {n} items into a "
                         f"buffer of capacity {cap}; writes batched per "
                         f"frame require capacity >= K")
    ptr = buf["ptr"]
    if ptr + n <= cap:
        for k, d in buf["data"].items():
            d[ptr:ptr + n] = items[k]
    else:
        idx = (ptr + torch.arange(n)) % cap
        for k, d in buf["data"].items():
            d[idx.to(d.device)] = items[k]
    buf["ptr"] = (ptr + n) % cap
    buf["size"] = min(buf["size"] + n, cap)
    return buf


def buffer_sample(buf: dict, generator: torch.Generator = None,
                  batch: int = 1, *, idx=None) -> dict:
    """Uniform minibatch drawn **with replacement** from the stored items
    (as the reference: the occasional duplicate row only reweights a
    gradient term).  The indices come from ``generator`` on its device,
    or are injected as ``idx``."""
    if idx is None:
        dev = generator.device
        idx = torch.randint(0, max(buf["size"], 1), (batch,),
                            generator=generator, device=dev)
    return {k: d[idx] for k, d in buf["data"].items()}


# -- B cells ------------------------------------------------------------------

def buffer_init_batch(num_envs: int, capacity: int,
                      item_example: dict) -> dict:
    """B empty buffers: ``data`` leaves (B, capacity, ...), per-cell
    ``ptr`` and ``size`` lists."""
    data = {k: torch.zeros((num_envs, capacity) + tuple(v.shape),
                           dtype=v.dtype, device=v.device)
            for k, v in item_example.items()}
    return {"data": data, "ptr": [0] * num_envs, "size": [0] * num_envs}


def stack_buffers(bufs) -> dict:
    """B single buffers -> one B-cell buffer (copies)."""
    bufs = list(bufs)
    return {"data": {k: torch.stack([b["data"][k] for b in bufs])
                     for k in bufs[0]["data"]},
            "ptr": [b["ptr"] for b in bufs],
            "size": [b["size"] for b in bufs]}


def buffer_cell(buf: dict, b: int) -> dict:
    """Cell b of a B-cell buffer as a single buffer whose ``data`` are
    views of the stack (writes through them land in it; ``ptr`` and
    ``size`` are copies, see ``set_buffer_cell``)."""
    return {"data": {k: d[b] for k, d in buf["data"].items()},
            "ptr": buf["ptr"][b], "size": buf["size"][b]}


def set_buffer_cell(buf: dict, b: int, cell: dict) -> dict:
    """Take back cell b's ``ptr`` and ``size`` after writes through
    ``buffer_cell``."""
    buf["ptr"][b], buf["size"][b] = cell["ptr"], cell["size"]
    return buf


def _cells(buf) -> int:
    return len(buf["ptr"])


def buffer_add_batch(buf: dict, items: dict) -> dict:
    """Add one item per cell; items' leaves carry a leading (B,) axis."""
    for b in range(_cells(buf)):
        cell = buffer_add(buffer_cell(buf, b), {k: v[b]
                                                for k, v in items.items()})
        set_buffer_cell(buf, b, cell)
    return buf


def buffer_add_many_batch(buf: dict, items: dict) -> dict:
    """Append ``n`` items to each cell; items' leaves are (B, n, ...)."""
    for b in range(_cells(buf)):
        cell = buffer_add_many(buffer_cell(buf, b),
                               {k: v[b] for k, v in items.items()})
        set_buffer_cell(buf, b, cell)
    return buf


def _sample_idx(buf, generators, batch: int):
    """(B, batch) indices, cell b's drawn as ``buffer_sample`` draws them:
    from ``generators[b]``, or from ``generators`` itself when it is one
    generator (every cell's in cell order)."""
    gens = (generators if isinstance(generators, (list, tuple))
            else [generators] * _cells(buf))
    return torch.stack([
        torch.randint(0, max(size, 1), (batch,), generator=g,
                      device=g.device)
        for g, size in zip(gens, buf["size"])])


def buffer_sample_batch(buf: dict, generators=None, batch: int = 1, *,
                        idx=None) -> dict:
    """A (B, batch, ...) minibatch, one independent draw per cell (with
    replacement), gathered cell by cell; ``idx`` (B, batch) injects the
    indices."""
    if idx is None:
        idx = _sample_idx(buf, generators, batch)
    return {k: torch.stack([d[b][idx[b]] for b in range(d.shape[0])])
            for k, d in buf["data"].items()}


def buffer_sample_stacked(buf: dict, generators=None, batch: int = 1, *,
                          idx=None) -> dict:
    """``buffer_sample_batch`` with one (B, batch) gather per leaf."""
    if profiling.ON:
        with profiling.span("replay.sample"):
            return _buffer_sample_stacked(buf, generators, batch, idx)
    return _buffer_sample_stacked(buf, generators, batch, idx)


def _buffer_sample_stacked(buf, generators, batch, idx):
    if idx is None:
        idx = _sample_idx(buf, generators, batch)
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return {k: d[rows, idx] for k, d in buf["data"].items()}


def buffer_add_many_stacked(buf: dict, items: dict) -> dict:
    """``buffer_add_many_batch`` with one indexed write per leaf: items'
    leaves are (B, n, ...); cell b's land at ``ptr[b]``, wrapping."""
    n = next(iter(items.values())).shape[1]
    cap = next(iter(buf["data"].values())).shape[1]
    if n > cap:
        raise ValueError(f"buffer_add_many_stacked: cannot write {n} items "
                         f"into buffers of capacity {cap}")
    p0 = buf["ptr"][0]
    if all(p == p0 for p in buf["ptr"]) and p0 + n <= cap:
        for k, d in buf["data"].items():     # lockstep cells: one slice
            d[:, p0:p0 + n] = items[k]
    else:
        dev = next(iter(buf["data"].values())).device
        idx = (torch.tensor(buf["ptr"], device=dev)[:, None]
               + torch.arange(n, device=dev)[None, :]) % cap
        rows = torch.arange(len(buf["ptr"]), device=dev)[:, None]
        for k, d in buf["data"].items():
            d[rows, idx] = items[k]
    buf["ptr"] = [(p + n) % cap for p in buf["ptr"]]
    buf["size"] = [min(sz + n, cap) for sz in buf["size"]]
    return buf


def buffer_occupancy(buf: dict, prefix: str, capacity: int = None) -> dict:
    """``{prefix_size, prefix_fill}``: stored items and fill fraction,
    as host floats, or lists of B of them for a B-cell buffer (pass its
    ``capacity``: its leaves lead with the cells)."""
    cap = _capacity(buf) if capacity is None else capacity
    if isinstance(buf["size"], list):
        return {prefix + "_size": [float(s) for s in buf["size"]],
                prefix + "_fill": [s / cap for s in buf["size"]]}
    size = float(buf["size"])
    return {prefix + "_size": size, prefix + "_fill": size / cap}
