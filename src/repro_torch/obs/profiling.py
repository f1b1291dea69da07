"""Profiling hooks (DESIGN.md §15), port of ``repro.obs.profiling``:
stage timers, a ``torch.profiler`` trace, and a build counter.

The reference counts fresh XLA compiles of its episode programs; the port
compiles no episode program, and the compiles it does make are the CUDA
kernels' ``nvcc`` builds.  So :func:`record_compile` is fed by
``repro_torch.kernels.build``: one event per library built (tag
``"nvcc:<source>"``, signature the library's file name), none for a
library found already built.  :func:`stage` wraps host-side phases in
wall-clock timers (``profile`` records through a ``MetricWriter`` when
one is attached), and :func:`profiler_trace` gates a ``torch.profiler``
trace behind an opt-in directory.
"""
from __future__ import annotations

import contextlib
import time
import warnings

# (tag, signature) per build, appended by kernels.build.  Module-global on
# purpose: builds happen once per process, whoever asks for the kernel.
_COMPILE_EVENTS: list = []
_WARNED_TAGS: set = set()


def record_compile(tag: str, signature: str = "") -> None:
    """Register one fresh build of the program named ``tag``; warns once
    per tag past two distinct signatures (a source rebuilt over and
    over)."""
    _COMPILE_EVENTS.append((tag, signature))
    sigs = {s for t, s in _COMPILE_EVENTS if t == tag}
    if len(sigs) > 2 and tag not in _WARNED_TAGS:
        _WARNED_TAGS.add(tag)
        warnings.warn(f"obs.profiling: {len(sigs)} distinct builds of "
                      f"{tag!r} in one process", stacklevel=2)


def compile_count(tag: str | None = None) -> int:
    """Number of builds recorded (for ``tag``, or in total)."""
    if tag is None:
        return len(_COMPILE_EVENTS)
    return sum(1 for t, _ in _COMPILE_EVENTS if t == tag)


def compile_events(tag: str | None = None) -> list:
    """The recorded ``(tag, signature)`` events, optionally filtered."""
    if tag is None:
        return list(_COMPILE_EVENTS)
    return [(t, s) for t, s in _COMPILE_EVENTS if t == tag]


def reset_compiles() -> None:
    """Clear the build-event log (test isolation)."""
    _COMPILE_EVENTS.clear()
    _WARNED_TAGS.clear()


@contextlib.contextmanager
def stage(name: str, writer=None, **fields):
    """Wall-clock a host-side stage; writes a ``profile`` record when a
    ``MetricWriter`` is attached.  The yielded dict is live: callers may
    add fields before the record is written on exit."""
    info = dict(fields)
    t0 = time.perf_counter()
    try:
        yield info
    finally:
        info["wall_s"] = time.perf_counter() - t0
        if writer is not None:
            writer.write("profile", stage=name, **info)


@contextlib.contextmanager
def profiler_trace(trace_dir=None):
    """Opt-in ``torch.profiler`` trace of the CPU and, where there is a
    card, its CUDA activity, exported as a Chrome trace into
    ``trace_dir`` on exit; a no-op when ``trace_dir`` is empty.  Yields
    the profiler (or None)."""
    if not trace_dir:
        yield None
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(str(trace_dir), "trace.json"))
