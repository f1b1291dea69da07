"""One run of one cell: set-up, the measured window, the traced stretch
(``--trace 1``), the output check, and the result's line.

``run_cell`` takes the device it runs on; the command (``perfbench/run.py``)
gives it the card and refuses to run without one, and the CPU tests give
it the CPU at a tiny size to rehearse everything but the kernels.
"""
from __future__ import annotations

import math
import subprocess
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from . import check, spec, trace


def _power_limit_w():
    """The card's power limit from ``nvidia-smi`` (None where it cannot
    be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def host_ms(reps: int = 5) -> list:
    """The host's speed beside the host-clock metrics: the least and the
    median time, in ms, of a fixed pure-Python loop run ``reps`` times.
    It moves with the speed the host gives this process, not with the
    program."""
    times = []
    for _ in range(reps):
        t0, x = time.perf_counter(), 0
        for i in range(100_000):
            x += i & 7
        times.append(1e3 * (time.perf_counter() - t0))
    times.sort()
    return [times[0], times[reps // 2]]


def _number(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def make_traffic(name: str, seed: int, device, pkg: Path = spec.PKG):
    """The cell's files read in, and its mix's generator made for it."""
    cell = spec.cell(name, pkg)
    gen = spec.generator(cell["mix"]["generator"], pkg)
    return cell, gen.Traffic(cell, seed, device)


def run_cell(name: str, seed: int, seconds: float, traced: bool,
             device: torch.device, t_start: float,
             root: Path = spec.ROOT, pkg: Path = spec.PKG,
             after_window=None) -> dict:
    """The result's fields for one run.  ``t_start``: the process's start
    on the host clock (``time.perf_counter``), so that set-up counts from
    it.  ``after_window()`` runs once the window and the traced stretch
    have closed, before the check."""
    bench = spec.benchmark(root)
    if name not in {w["name"] for w in bench["workloads"]}:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    e2e, per = spec.metrics_of(bench, name)
    t_cell = time.perf_counter()
    cell, traffic = make_traffic(name, seed, device, pkg)
    gpu = device.type == "cuda"
    if gpu:
        torch.cuda.reset_peak_memory_stats()
    traffic.setup()
    setup_s = time.perf_counter() - t_start
    phases = {"before_cell_s": t_cell - t_start,
              "cell_s": setup_s - (t_cell - t_start),
              "cpu_s": time.process_time()}
    host0 = host_ms()
    cpu0 = time.process_time()
    w = traffic.window(seconds)
    cpu_s = time.process_time() - cpu0
    host1 = host_ms()
    result = {}
    if not traced:
        values = {"setup_s": setup_s, **traffic.end_to_end(w)}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in e2e if values.get(m["name"]) is not None}
    else:
        run, work = traffic.stretch()
        tr = trace.profile(run, device)
        gaps = trace.profile(run, device, host=True).idle_gaps
        ctx = SimpleNamespace(platform="gpu" if gpu else "cpu", trace=tr,
                              work=work, config=cell["config"],
                              window={k: v for k, v in w.items()
                                      if k != "unit_s"},
                              window_flops=traffic.work_flops(w))
        metrics = {}
        for m in per:
            v = spec.reader(m["name"], pkg).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["breakdown"] = {"device_ops": tr.device_ops,
                               "idle_gaps": gaps}
    dev_info = {"platform": "gpu" if gpu else "cpu",
                "kind": torch.cuda.get_device_name(0) if gpu else "cpu",
                "count": 1,
                "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                      if gpu else 0)}
    if traced:
        dev_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
    if gpu:
        dev_info["power_limit_w"] = _power_limit_w()
    if after_window is not None:
        after_window()
    traffic.free()
    values = traffic.readings()
    correct, checks = check.verdict(values, cell["workload"]["limits"])
    for c in checks.values():
        c["value"] = _number(c["value"])
    units = sorted(w["unit_s"])
    window = {k: v for k, v in w.items() if not isinstance(v, list)}
    window.update(cpu_s=cpu_s, units=len(units), unit_min=units[0],
                  unit_median=units[len(units) // 2],
                  unit_p95=units[int(0.95 * (len(units) - 1))],
                  unit_max=units[-1], host_ms_before=host0,
                  host_ms_after=host1)
    return {"correct": correct, "attempted": traffic.attempted(w),
            "failed": w["failed"], "metrics": metrics, "device": dev_info,
            **result, "checks": checks, "setup": phases, "window": window}
