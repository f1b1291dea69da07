"""Arithmetic the per-layer readers share (``perfbench/metrics/``).

A reader's ``read(ctx)`` returns a number or None; None leaves the
metric out of the run's line.  ``ctx`` carries ``platform`` ("gpu" or
"cpu"), ``trace`` (``trace.Trace`` of the traced stretch), ``work`` (what
the traced stretch held), ``window`` (what the measured window held, with
its ``seconds``), ``window_flops`` and ``config`` (the configuration
file).  Device metrics read nothing off a card.
"""
from __future__ import annotations

from perfbench import counts


def kernel_seconds(ctx, names) -> float:
    """Device seconds of the kernels whose names hold one of ``names``."""
    return sum(s for n, s in ctx.trace.kernels
               if any(k in n for k in names))


def roofline(ctx, names, works) -> float | None:
    """Percent of the least time (``counts.bound_s`` of each launch's
    work, summed) in the device time of the kernels named."""
    if ctx.platform != "gpu":
        return None
    t = kernel_seconds(ctx, names)
    if t <= 0:
        return None
    return 100.0 * sum(n * counts.bound_s(w)[0] for n, w in works) / t


def per_unit(ctx, unit: str) -> float | None:
    """Device kernels (copies and fills left out) per unit of work."""
    if ctx.platform != "gpu" or not ctx.trace.kernels:
        return None
    return len(ctx.trace.kernels) / ctx.work[unit]


def idle_share(ctx, unit: str) -> float | None:
    """Percent of the measured window in which no device event ran: one
    minus the traced device busy time per ``unit`` of work over the
    window's host time per unit.  The traced stretch's own length is not
    the base, since the profiler slows the host that paces the card."""
    if ctx.platform != "gpu" or ctx.trace.busy_s <= 0:
        return None
    busy = ctx.trace.busy_s / ctx.work[unit]
    return 100.0 * (1.0 - busy * ctx.window[unit] / ctx.window["seconds"])


def mfu(ctx) -> float | None:
    """Percent of the card's f32 peak that the measured window's
    operations (``counts``) reach over its host-clock length."""
    if ctx.platform != "gpu":
        return None
    return 100.0 * ctx.window_flops / (ctx.window["seconds"]
                                       * counts.F32_FLOPS)
