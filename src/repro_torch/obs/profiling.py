"""Profiling hooks (DESIGN.md §15), port of ``repro.obs.profiling``:
the span recorder, a ``torch.profiler`` trace, and a build counter.

The span recorder is the program's one account of where its host time
goes.  A span is a named stretch of the host's clock (``Span``: name,
start, end, the index of its parent span and a trace id; a root span
opens a new trace id and its descendants share it).  The decision and
training paths open spans at their layer boundaries.  The recorder is off
by default, and then a span site of the decision path costs one test of
the module flag ``ON``::

    if profiling.ON:
        with profiling.span("env.observe"):
            return _observe(state, cfg, models, mask)
    return _observe(state, cfg, models, mask)

and one of the training episode, whose slots take milliseconds, a
``with span(name):`` that returns a shared no-op context.  Either way,
with the recorder off the program launches the same work, draws the
same numbers and reads no clock.  ``recording()`` turns it on; spans are
kept in memory, at most ``CAPACITY`` of them (the rest are counted as
dropped), until ``take()`` returns and clears them.  Stamps are
``time.perf_counter_ns``; ``take()`` gives them on the clock of
``torch.profiler``'s events (Unix-epoch ns), from one pair of clock
readings taken when the recorder is turned on, so that spans lie over a
profile of the card's kernels alone.  While a profiler is running each
span also opens a ``record_function`` range of its name, so that the
profiler's own trace shows the program's spans.  Spans time the host: an
enqueue, not the device's work.

The reference counts fresh XLA compiles of its episode programs; the port
compiles no episode program, and the compiles it does make are the CUDA
kernels' ``nvcc`` builds.  So :func:`record_compile` is fed by
``repro_torch.kernels.build``: one event per library built (tag
``"nvcc:<source>"``, signature the library's file name), none for a
library found already built.  Counters (:func:`count`) add up numbers
while the recorder is on: a tensor stays on its device, so a count in a
hot path adds no synchronise, and :func:`take_counts` reads them all to
the host once, after the stretch they cover.  :func:`stage` is a span
that also writes a ``profile`` record (its host wall time) through a
``MetricWriter`` when one is attached, and :func:`profiler_trace` gates
a ``torch.profiler`` trace, with the program's spans in it, behind an
opt-in directory.
"""
from __future__ import annotations

import contextlib
import time
import warnings
from typing import NamedTuple

from torch.autograd import profiler as _autograd_profiler

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


# -- the span recorder -------------------------------------------------------

ON = False              # the one test a span site makes
CAPACITY = 1 << 20      # spans kept until take(); further ones are dropped


class Span(NamedTuple):
    name: str
    start_ns: int       # on the profiler's clock (Unix-epoch ns)
    end_ns: int
    parent: int         # index of the parent span in the same take(), or -1
    trace: int          # shared by a root span and its descendants


class SpanLog(NamedTuple):
    spans: list         # of Span, in the order they were opened
    dropped: int        # spans not kept because the buffer was full


class _Buffer:
    """Spans as parallel lists, the open ones on a stack of indices."""

    def __init__(self):
        self.clear()

    def clear(self) -> None:
        self.name, self.start, self.end = [], [], []
        self.parent, self.trace = [], []
        self.stack, self.dropped, self.traces = [], 0, 0


_BUF = _Buffer()
_ANNOTATE = False       # open record_function ranges under a profiler
_OFFSET_NS = 0          # profiler's clock minus perf_counter_ns


def _clock_offset_ns() -> int:
    """``time.time_ns()`` minus ``time.perf_counter_ns()``, from the
    narrowest of a few bracketed readings."""
    best = None
    for _ in range(5):
        p0 = time.perf_counter_ns()
        t = time.time_ns()
        p1 = time.perf_counter_ns()
        if best is None or p1 - p0 < best[0]:
            best = (p1 - p0, t - (p0 + p1) // 2)
    return best[1]


@contextlib.contextmanager
def recording(annotate: bool = True):
    """The recorder on for the block, and as it was after it.
    ``annotate``: while a profiler runs, each span also opens a
    ``record_function`` range (leave it off under a profile of the card's
    kernels alone, which records no host ranges).  The clock pair that
    ``take`` converts with is read here when no span is waiting."""
    global ON, _ANNOTATE, _OFFSET_NS
    saved = ON, _ANNOTATE
    if not _BUF.name:
        _OFFSET_NS = _clock_offset_ns()
    ON, _ANNOTATE = True, annotate
    try:
        yield
    finally:
        ON, _ANNOTATE = saved


def take() -> SpanLog:
    """The spans recorded since the last ``take`` (all closed: taking
    while a span is open is refused), and how many were dropped; clears
    them."""
    b = _BUF
    if b.stack:
        raise RuntimeError(f"obs.profiling.take: {len(b.stack)} span(s) "
                           f"still open")
    off = _OFFSET_NS
    spans = [Span(n, s + off, e + off, p, t) for n, s, e, p, t
             in zip(b.name, b.start, b.end, b.parent, b.trace)]
    log = SpanLog(spans, b.dropped)
    b.clear()
    return log


class _Open:
    """One span while it is open (``span`` makes it only with the recorder
    on)."""
    __slots__ = ("name", "i", "rf")

    def __init__(self, name: str):
        self.name, self.i, self.rf = name, -1, None

    def __enter__(self):
        b = _BUF
        parent = b.stack[-1] if b.stack else -1
        if len(b.name) >= CAPACITY or parent == -2:
            b.dropped += 1
            b.stack.append(-2)          # a dropped span's children drop too
            return self
        if parent < 0:
            b.traces += 1
        self.i = len(b.name)
        b.name.append(self.name)
        b.parent.append(parent)
        b.trace.append(b.traces if parent < 0 else b.trace[parent])
        b.end.append(0)
        b.stack.append(self.i)
        b.start.append(time.perf_counter_ns())
        if _ANNOTATE and _autograd_profiler._is_profiler_enabled:
            self.rf = _autograd_profiler.record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        b = _BUF
        if self.i >= 0:
            b.end[self.i] = time.perf_counter_ns()
        b.stack.pop()
        return False


_OFF = contextlib.nullcontext()
_COUNTS: dict = {}      # counter name -> number, or a tensor on its device


def span(name: str):
    """A span named ``name`` over the ``with`` block; nothing (and no
    clock read) with the recorder off.  Hot paths test ``ON`` first."""
    return _Open(name) if ON else _OFF


def count(name: str, value) -> None:
    """Add ``value`` (a number, or a tensor, kept on its device) to the
    counter ``name`` while the recorder is on; nothing with it off."""
    if not ON:
        return
    c = _COUNTS.get(name)
    if c is None:
        _COUNTS[name] = value.detach().clone() if hasattr(value, "detach") \
            else value
    else:
        _COUNTS[name] = c + value


def take_counts() -> dict:
    """The counters since the last ``take_counts``, read to host numbers
    (a tensor's read waits for the device); clears them."""
    out = {k: (v.tolist() if hasattr(v, "tolist") else v)
           for k, v in _COUNTS.items()}
    _COUNTS.clear()
    return out


@contextlib.contextmanager
def stage(name: str, writer=None, **fields):
    """A span over a host-side stage, which also takes its wall time on
    the host's clock (``wall_s``: the time the host spent in the block,
    an enqueue where the block launches device work, not the device's
    time) and writes it as a ``profile`` record when a ``MetricWriter``
    is attached.  The yielded dict is live: callers may add fields before
    the record is written on exit."""
    info = dict(fields)
    t0 = time.perf_counter()
    try:
        with span(name):
            yield info
    finally:
        info["wall_s"] = time.perf_counter() - t0
        if writer is not None:
            writer.write("profile", stage=name, **info)


@contextlib.contextmanager
def profiler_trace(trace_dir=None):
    """Opt-in ``torch.profiler`` trace of the CPU and, where there is a
    card, its CUDA activity, exported as a Chrome trace into
    ``trace_dir`` on exit, with the span recorder on for its duration so
    that the trace carries the program's spans as ``record_function``
    ranges (the recorder's state is restored on exit; the spans stay for
    ``take``); a no-op when ``trace_dir`` is empty.  Yields the profiler
    (or None)."""
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
    with recording(annotate=True):
        with profile(activities=acts) as prof:
            yield prof
    prof.export_chrome_trace(os.path.join(str(trace_dir), "trace.json"))
