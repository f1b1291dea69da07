"""The program's own spans over the cell's traced work, reduced in memory.

The program records spans at its layer boundaries
(``repro_torch.obs.profiling``: name, start, end, parent, trace id, on
the clock of ``torch.profiler``'s events) while its recorder is on; it is
off in the measured window and in the other traced stretches.  Two more
stretches run with it on: one with no profiler, which gives each span's
host time, and one under a profile of the card's activity alone (no
host events, so the host runs nearly at its own pace), which lays the
spans over the device's idle gaps.  A gap's part that a span covers is
put down to the innermost span there; the rest is the harness's own
loop, its synchronise and its copies.

A span's self time is its length less the union of its children's.  A
decision is one ``t2drl.greedy_slot_action`` root, with the
``t2drl.greedy_frame_cache`` root just before it where there is one (a
frame decision).  Where the program has no recorder, ``collect`` returns
None and the readers of spans read nothing.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from perfbench.lib.trace import _gaps, union_s

FRAME, SLOT = "t2drl.greedy_frame_cache", "t2drl.greedy_slot_action"


def recorder():
    """The program's span recorder, or None where it has none."""
    try:
        from repro_torch.obs import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "take") else None


def builds():
    """Kernel libraries the program has built so far (None where it does
    not count them)."""
    try:
        from repro_torch.obs.profiling import compile_count
    except ImportError:
        return None
    return compile_count()


class Spans(NamedTuple):
    table: dict        # name -> n, total_ms, self_ms_median, self_ms_p95
    #                    (the spans stretch), idle_ms (the device idle its
    #                    self-intervals cover a unit of the profiled work)
    decisions: list    # (frame?, host ms, cacher ms, slot ms) a decision
    units: dict        # the spans stretch's work
    idle_in_program_ms: float    # the profiled stretch's, a unit of work
    idle_outside_ms: float
    dropped: int
    before: int        # spans recorded before the spans stretch


def _self_intervals(spans) -> list:
    """Each span's (start, end) pieces that none of its children covers,
    the children clipped to their parent."""
    kids: dict = {}
    for i, s in enumerate(spans):
        if s.parent >= 0:
            kids.setdefault(s.parent, []).append(i)
    out = []
    for i, s in enumerate(spans):
        pieces, at = [], s.start_ns
        for c0, c1 in sorted((max(spans[k].start_ns, s.start_ns),
                              min(spans[k].end_ns, s.end_ns))
                             for k in kids.get(i, [])):
            if c0 > at:
                pieces.append((at, c0))
            at = max(at, c1)
        if s.end_ns > at:
            pieces.append((at, s.end_ns))
        out.append(pieces)
    return out


def self_ms(spans) -> list:
    """Each span's self time in ms: its length less the union of its
    children's intervals."""
    return [1e3 * union_s(p) for p in _self_intervals(spans)]


def split_gaps(spans, device) -> tuple:
    """The device's idle gaps (between the merged ``device`` intervals, ns)
    split into the ns each span name's self-intervals cover, the innermost
    span taking each instant, and the ns no span covers."""
    pieces = sorted((a, b, spans[i].name)
                    for i, ps in enumerate(_self_intervals(spans))
                    for a, b in ps)
    by_name: dict = {}
    outside, j = 0, 0
    for g0, g1 in _gaps(device):
        covered = 0
        while j < len(pieces) and pieces[j][1] <= g0:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < g1:
            a, b, name = pieces[k]
            ov = min(b, g1) - max(a, g0)
            if ov > 0:
                by_name[name] = by_name.get(name, 0) + ov
                covered += ov
            k += 1
        outside += (g1 - g0) - covered
    return by_name, outside


def decisions(spans) -> list:
    """``(frame, host_ms, cacher_ms, slot_ms)`` of each decision, in order:
    ``host_ms`` the host time its roots cover."""
    out, frame = [], None
    for s in spans:
        if s.parent >= 0:
            continue
        ms = (s.end_ns - s.start_ns) / 1e6
        if s.name == FRAME:
            frame = ms
        elif s.name == SLOT:
            out.append((frame is not None, ms + (frame or 0.0), frame, ms))
            frame = None
    return out


def reduce(spans, dropped: int, units: dict, traced=(), device=(),
           traced_units: int = 1, before: int = 0) -> Spans:
    """The reduction of the spans stretch's ``spans`` (its work
    ``units``) and of the profiled stretch's ``traced`` spans over its
    ``device`` intervals (ns), whose idle time is given a unit of its
    work (``traced_units`` of them)."""
    own = self_ms(spans)
    idle, outside = split_gaps(traced, device)
    names: dict = {}
    for s, ms in zip(spans, own):
        names.setdefault(s.name, []).append(
            (ms, (s.end_ns - s.start_ns) / 1e6))
    table = {}
    for name, rows in names.items():
        selfs = np.array([r[0] for r in rows])
        table[name] = {"n": len(rows),
                       "total_ms": float(sum(r[1] for r in rows)),
                       "self_ms_median": float(np.median(selfs)),
                       "self_ms_p95": float(np.percentile(selfs, 95)),
                       "idle_ms": idle.get(name, 0) / 1e6 / traced_units}
    n = traced_units
    return Spans(table=table, decisions=decisions(spans), units=units,
                 idle_in_program_ms=sum(idle.values()) / 1e6 / n,
                 idle_outside_ms=outside / 1e6 / n, dropped=dropped,
                 before=before)


def _device_intervals(run) -> list:
    """``run()`` under a profile of the card's activity alone: the (start,
    end) ns of every device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return [(e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def collect(run, work: dict, device: torch.device):
    """The spans stretch (``run()`` 5 times where its work is decisions,
    once otherwise, the recorder on and no profiler), then one ``run()``
    with the recorder on under a profile of the card alone (on the CPU,
    with no profiler and so no device gaps); None where the program has
    no recorder.  Spans recorded before it (none, with the recorder off
    in the window and the other stretches) are counted and let go."""
    rec = recorder()
    if rec is None:
        return None
    before = len(rec.take().spans)
    reps = 5 if "decisions" in work else 1
    with rec.recording(annotate=False):
        for _ in range(reps):
            run()
        if device.type == "cuda":
            torch.cuda.synchronize()
    log = rec.take()
    units = {k: v * reps for k, v in work.items()
             if isinstance(v, int) and k not in ("cells", "learners")}
    with rec.recording(annotate=False):
        if device.type == "cuda":
            dev = _device_intervals(run)
        else:
            run()
            dev = []
    traced = rec.take()
    per = work.get("decisions", work.get("slots", 1))
    return reduce(log.spans, log.dropped + traced.dropped, units,
                  traced.spans, dev, per, before)


def line(sp, builds0) -> dict:
    """The run's ``spans`` line: per span name its count, total and
    self-time median and p95 (ms), and the device idle ms its
    self-intervals cover a unit of the profiled stretch's work (a
    decision, or a slot); the idle ms a unit that spans cover and that
    none does; ``dropped``; ``builds``, the kernel libraries built since
    ``builds0`` was read (0: none rebuilt); ``before``, the spans recorded
    before the spans stretch (0: the recorder was off until then)."""
    now = builds()
    out = {"recorder": sp is not None,
           "builds": (now - builds0 if None not in (now, builds0)
                      else None)}
    if sp is not None:
        out.update(names=sp.table, units=sp.units,
                   idle_in_program_ms=sp.idle_in_program_ms,
                   idle_outside_ms=sp.idle_outside_ms, dropped=sp.dropped,
                   before=sp.before)
    return out


def of(ctx):
    """The run's span reduction where a reader may read it: on the card,
    with spans recorded."""
    sp = getattr(ctx, "spans", None)
    return sp if ctx.platform == "gpu" and sp is not None and sp.table \
        else None


def median(xs):
    xs = [x for x in xs if x is not None]
    return float(np.median(xs)) if xs else None


def ms_per(ctx, names, unit: str, minus=()):
    """Total ms of the spans named, less that of ``minus``, per ``unit`` of
    the spans stretch's work."""
    sp = of(ctx)
    if sp is None or not sp.units.get(unit):
        return None
    def total(ns):
        return sum(sp.table.get(n, {}).get("total_ms", 0.0) for n in ns)

    return (total(names) - total(minus)) / sp.units[unit]
