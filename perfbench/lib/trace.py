"""A bounded stretch of work under ``torch.profiler``, reduced in memory.

No trace file is written: the profiler's events are read once the
stretch ends, and only their reduction is kept.  The device's events
(kernels, copies, fills) give the busy time (the union of their
intervals), each kernel's time by name and the gaps between them.  The
host's operator events, recorded only where asked for (``host=True``:
they slow the host about twofold, so a stretch that records them is not
the one whose busy share is read), name what the host was doing when
each gap ended.
"""
from __future__ import annotations

import bisect
import time
from typing import Callable, NamedTuple

import torch


class Trace(NamedTuple):
    window_s: float        # host clock over the stretch, synchronised
    busy_s: float          # union of the device's event intervals
    kernels: list          # (name, seconds) of every device kernel
    device_ops: list       # [name, seconds] of the 10 costliest kernels
    idle_gaps: list        # [host op, seconds] of the gaps, 10 largest


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespaces and
    argument list."""
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    return name.split("(", 1)[0][:120]


def union_s(intervals) -> float:
    """Seconds covered by (start_ns, end_ns) intervals."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e9


def _gaps(intervals):
    """(start_ns, end_ns) of the idle stretches between merged device
    intervals."""
    out, end = [], None
    for s, e in sorted(intervals):
        if end is not None and s > end:
            out.append((end, s))
        end = e if end is None else max(end, e)
    return out


def reduce_events(events, window_s: float) -> Trace:
    """The reduction of a list of ``(device, name, start_ns, end_ns)``
    events, ``device`` True for the card's own events."""
    dev = [(n, s, e) for d, n, s, e in events if d]
    host = sorted((s, n) for d, n, s, e in events
                  if not d and not n.startswith(("cuda", "cu")))
    kernels = [(n, (e - s) / 1e9) for n, s, e in dev
               if not n.startswith(("Memcpy", "Memset"))]
    by_name: dict = {}
    for n, sec in kernels:
        k = short_name(n)
        by_name[k] = by_name.get(k, 0.0) + sec
    gaps: dict = {}
    starts = [s for s, _ in host]
    for g0, g1 in _gaps([(s, e) for _, s, e in dev]):
        i = bisect.bisect_right(starts, g1) - 1
        k = host[i][1] if i >= 0 else "(none)"
        gaps[k] = gaps.get(k, 0.0) + (g1 - g0) / 1e9
    top = lambda d: [[k, v] for k, v in  # noqa: E731
                     sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return Trace(window_s=window_s,
                 busy_s=union_s([(s, e) for _, s, e in dev]),
                 kernels=kernels,
                 device_ops=top(by_name), idle_gaps=top(gaps))


def profile(stretch: Callable[[], None], device: torch.device,
            host: bool = False) -> Trace:
    """Run ``stretch()`` under the profiler (the card's events where there
    is one, and with ``host`` the host's operators; the CPU alone records
    its operators) and reduce what it recorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] if host or not cuda else []
    if cuda:
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        stretch()
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    events = [(e.device_type() == DeviceType.CUDA, e.name(), e.start_ns(),
               e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    return reduce_events(events, window_s)
