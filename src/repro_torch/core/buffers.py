"""Fixed-capacity cyclic replay buffers (port of ``repro.core.buffers``).

A buffer is ``{"data": {name: (capacity, ...) device tensor}, "ptr": int,
"size": int}``.  ``ptr`` and ``size`` are host ints: the episode's update
gates read them every slot, and a device int would cost a device read
each time.  Writes go in place into ``data`` (the JAX functions return a
new buffer; these return the same dict, updated).  The batched and
stacked (B-cell) helpers wait for ROADMAP A.6.
"""
from __future__ import annotations

import torch


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


def buffer_occupancy(buf: dict, prefix: str, capacity: int = None) -> dict:
    """``{prefix_size, prefix_fill}``: stored items and fill fraction,
    as host floats."""
    cap = _capacity(buf) if capacity is None else capacity
    size = float(buf["size"])
    return {prefix + "_size": size, prefix + "_fill": size / cap}
