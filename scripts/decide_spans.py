"""The decision path's host time split by the program's spans, on the card.

For each decision cell of the benchmark (``BENCHMARK.json``): its traffic
set up as ``perfbench/run.py`` sets it up, a measured window with the span
recorder off, then blocks of the cell's traced stretch with the recorder
off and on in turns (the recorder's cost, and the spans of the on blocks:
five stretches, as the spans stretch of ``perfbench/lib/spans.py`` runs),
then frame decisions whose spans are held against the harness's own
clock of their enqueue, then ``spans.collect`` (the spans stretch and
one stretch under a profile of the card alone).  Prints one JSON line a
cell: the card, the window, the cost, the self-time split of frame and of
slot decisions by span, the clock check, the span table with the device
idle each span covers, and the values of the span readers in
``perfbench/metrics/``.

Usage: python3 scripts/decide_spans.py [--cells a,b] [--seed n]
           [--seconds s] [--blocks n]
"""
import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
from perfbench.lib import runner, spans, spec  # noqa: E402

CELLS = ("decide-table2-c4096", "decide-u18l10-c4096")
READERS = ("frame_host_ms.decide", "cacher_host_ms.decide",
           "slot_host_ms.decide", "idle_in_program_ms.decide")


def _rows(log, rows: dict) -> None:
    """A row of self ms by span name for each decision of one ``take()``'s
    ``log``, appended to ``rows["frame"]`` or ``rows["slot"]``."""
    by_trace: dict = {}
    for s, ms in zip(log, spans.self_ms(log)):
        row = by_trace.setdefault(s.trace, {})
        row[s.name] = row.get(s.name, 0.0) + ms
    frame = None
    for s in log:
        if s.parent >= 0:
            continue
        if s.name == spans.FRAME:
            frame = by_trace[s.trace]
        elif s.name == spans.SLOT:
            row = dict(by_trace[s.trace])
            for k, v in (frame or {}).items():
                row[k] = row.get(k, 0.0) + v
            rows["frame" if frame else "slot"].append(row)
            frame = None


def split(logs) -> dict:
    """Median self ms of each span name over the frame decisions and over
    the other decisions of ``logs`` (one list of spans a ``take()``), a
    decision's spans summed by name."""
    rows = {"frame": [], "slot": []}
    for log in logs:
        _rows(log, rows)
    out = {}
    for kind, rs in rows.items():
        names = sorted({k for r in rs for k in r})
        out[kind] = {"n": len(rs), **{k: float(np.median([r.get(k, 0.0)
                                                          for r in rs]))
                                      for k in names}}
    return out


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def timed(run, on: bool, rec, n: int, dev) -> float:
    """ms a decision of one ``run()``, the recorder ``on`` or off."""
    _sync(dev)
    t0 = time.perf_counter()
    if on:
        with rec.recording(annotate=False):
            run()
    else:
        run()
    _sync(dev)
    return 1e3 * (time.perf_counter() - t0) / n


def span_cost_us(rec, n: int = 100_000) -> dict:
    """The host's us for one empty span site of the decision path, the
    recorder off (its flag test) and on (a span kept and taken)."""
    def site():
        if rec.ON:
            with rec.span("probe"):
                pass

    out = {}
    for on in (False, True):
        rec.take()
        t0 = time.perf_counter()
        if on:
            with rec.recording(annotate=False):
                for _ in range(n):
                    site()
        else:
            for _ in range(n):
                site()
        out["on" if on else "off"] = 1e6 * (time.perf_counter() - t0) / n
    rec.take()
    return out


def clock_pairs(traffic, rec, n: int) -> dict:
    """``n`` decisions with the recorder on, one ``take()`` each: at each
    frame decision the harness's own host clock of its enqueue
    (``traffic.enqueue_ms``: from its clock's start until the copy to the
    host is asked for, ``env_set_cache`` and a ``cat`` besides the two
    roots) against the host time its spans' roots cover."""
    rec.take()
    pairs = []
    with rec.recording(annotate=False):
        for _ in range(n):
            traffic.decide()
            d = spans.decisions(rec.take().spans)
            if d and d[0][0]:
                pairs.append((traffic.enqueue_ms, d[0][1]))
    gap = [e - h for e, h in pairs]
    return {"frames": len(pairs),
            "enqueue_ms_median": float(np.median([e for e, _ in pairs])),
            "spans_ms_median": float(np.median([h for _, h in pairs])),
            "enqueue_less_spans_ms_median": float(np.median(gap)),
            "spans_within_enqueue": sum(g >= 0 for g in gap)}


def one_cell(name: str, seed: int, seconds: float, blocks: int,
             dev: torch.device, pkg: Path = spec.PKG) -> dict:
    """One cell's line (``dev`` the CPU rehearses it at a tiny size)."""
    rec = spans.recorder()
    cell, traffic = runner.make_traffic(name, seed, dev, pkg)
    traffic.setup()
    builds0 = spans.builds()
    w = traffic.window(seconds)
    run, work = traffic.stretch()
    n = work["decisions"]
    rec.take()
    cost = {"off": [], "on": []}
    logs = []
    for i in range(2 * blocks):
        on = (i % 2 == 1) == (i // 2 % 2 == 0)      # off, on, on, off, ...
        cost["on" if on else "off"].append(timed(run, on, rec, n, dev))
        if on:
            logs.append(rec.take().spans)
    clock = clock_pairs(traffic, rec, 5 * n)
    sp = spans.collect(run, work, dev)
    gpu = dev.type == "cuda"
    ctx = SimpleNamespace(platform="gpu" if gpu else "cpu", spans=sp)
    line = spans.line(sp, builds0)
    traffic.free()
    off, on = (float(np.median(cost[k])) for k in ("off", "on"))
    return {
        "cell": name, "seed": seed,
        "card": ([torch.cuda.get_device_name(0), runner._power_limit_w()]
                 if gpu else None),
        "window": {"decisions": w["decisions"],
                   "decision_ms_p95": float(np.percentile(w["unit_s"], 95)),
                   "frame_ms_median": w["frame_ms_median"],
                   "slot_ms_median": w["slot_ms_median"],
                   "frame_enqueue_ms_median": w["frame_enqueue_ms_median"]},
        "cost": {"blocks": blocks, "decisions_a_block": n,
                 "off_ms": cost["off"], "on_ms": cost["on"],
                 "off_ms_median": off, "on_ms_median": on,
                 "percent": 100.0 * (on - off) / off},
        "split": split(logs),
        "clock": clock,
        "span_us": span_cost_us(rec),
        "metrics": {m: spec.reader(m, pkg).read(ctx) for m in READERS},
        "spans": line}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--seed", type=int, default=2**31 + 2501)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--blocks", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    for i, name in enumerate(args.cells.split(",")):
        print(json.dumps(one_cell(name, args.seed + i, args.seconds,
                                  args.blocks, torch.device("cuda", 0))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
