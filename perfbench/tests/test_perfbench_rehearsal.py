"""The harness end to end at a tiny size on the CPU (the kernels' plain
versions): set-up, window, traced stretch, metric readers and the check;
and the reductions the readers rest on, on made-up events."""
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from perfbench import counts
from perfbench.lib import readers, runner, spec, trace
from perfbench.tests.tiny import REPO, tiny_copy

sys.path.insert(0, str(REPO / "src"))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", ["train-tiny", "decide-tiny"])
@pytest.mark.parametrize("traced", [False, True])
def test_a_run_on_the_cpu(root, cell, traced):
    torch.set_num_threads(1)
    out = runner.run_cell(cell, 2**31 + 77, 0.2, traced, torch.device("cpu"),
                          time.perf_counter(), root=root,
                          pkg=root / "perfbench")
    assert out.pop("window")["units"] > 0
    assert out.pop("setup")["cell_s"] > 0
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    e2e, per = spec.metrics_of(spec.benchmark(root), cell)
    host = lambda ms: {m["name"] for m in ms  # noqa: E731
                       if m["source"] == "host_clock"}
    if traced:
        # no device number is ever read off a CPU run
        assert set(out["metrics"]) <= host(per)
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert out["device"]["window_s"] > 0
    else:
        assert set(out["metrics"]) == host(e2e)
        assert all(m["value"] > 0 for m in out["metrics"].values())
    assert out["device"]["platform"] == "cpu"
    json.loads(json.dumps(out))


def test_a_run_writes_only_in_its_checkout_and_given_dirs(root, tmp_path):
    """Every file a run opens for writing lies in the checkout or under the
    HOME, XDG_CACHE_HOME and TMPDIR it was given."""
    dirs = {k: tmp_path / k.lower() for k in ("HOME", "XDG_CACHE_HOME",
                                              "TMPDIR")}
    for d in dirs.values():
        d.mkdir()
    code = f"""
import sys, time
written = []
def hook(ev, args):
    if ev == "open" and isinstance(args[0], str) and args[1] and \\
            any(c in str(args[1]) for c in "wax+"):
        written.append(args[0])
sys.addaudithook(hook)
sys.path[:0] = [{str(root)!r}, {str(REPO / 'src')!r}]
import torch
from pathlib import Path
from perfbench.lib import runner
root = Path({str(root)!r})
runner.run_cell("decide-tiny", 9, 0.1, True, torch.device("cpu"),
                time.perf_counter(), root=root, pkg=root / "perfbench")
print("\\n".join(written))
"""
    env = {**os.environ, **{k: str(v) for k, v in dirs.items()}}
    out = subprocess.run([sys.executable, "-c", code], env=env, timeout=600,
                         capture_output=True, text=True, check=True)
    allowed = [str(root)] + [str(d) for d in dirs.values()]
    written = [p for p in out.stdout.splitlines() if p and p != os.devnull]
    assert not [p for p in written
                if not any(os.path.abspath(p).startswith(a)
                           for a in allowed)], written


def test_trace_reduction_on_made_up_events():
    ev = [(True, "void (anonymous namespace)::ddpm_chain_kernel(ChainNet)",
           0, 100),
          (True, "void (anonymous namespace)::ddpm_chain_kernel(ChainNet)",
           50, 150),
          (True, "Memcpy DtoH", 300, 310),
          (True, "at::native::add_kernel(float)", 400, 450),
          (False, "aten::randn", 160, 170),
          (False, "cudaLaunchKernel", 390, 395),
          (False, "aten::add", 380, 399)]
    tr = trace.reduce_events(ev, 1e-6)
    assert tr.busy_s == pytest.approx((150 + 10 + 50) / 1e9)
    assert len(tr.kernels) == 3     # the copy is busy time, not a kernel
    assert tr.device_ops[0] == ["ddpm_chain_kernel", pytest.approx(2e-7)]
    # the gap 150-300 ended while aten::randn was the last host op; the
    # gap 310-400 after aten::add (runtime calls are not host ops)
    assert dict((k, v) for k, v in tr.idle_gaps) == {
        "aten::randn": pytest.approx(150e-9),
        "aten::add": pytest.approx(90e-9)}


def test_readers_on_a_made_up_trace():
    cfg = spec.cell("decide-table2-c4096")["config"]
    n = counts.nets_of(cfg)
    tr = trace.Trace(window_s=2.0, busy_s=1.0,
                     kernels=[("(anonymous namespace)::ddpm_chain_kernel",
                               0.5)] * 4 + [("other", 0.1)] * 6,
                     device_ops=[], idle_gaps=[])
    ctx = SimpleNamespace(platform="gpu", trace=tr, config=cfg,
                          work={"decisions": 4, "frame_decisions": 0,
                                "cells": 4096},
                          window={"seconds": 10.0, "decisions": 20},
                          window_flops=67e12)
    bound = counts.bound_s(counts.slot_decision(n, 4096))[0]
    assert readers.roofline(ctx, ("ddpm_chain_kernel",),
                            [(4, counts.slot_decision(n, 4096))]) == \
        pytest.approx(100 * 4 * bound / 2.0)
    assert readers.per_unit(ctx, "decisions") == pytest.approx(10 / 4)
    # 0.25 s busy a decision against 0.5 s of window a decision
    assert readers.idle_share(ctx, "decisions") == pytest.approx(50.0)
    assert readers.mfu(ctx) == pytest.approx(10.0)
    assert readers.mfu(SimpleNamespace(**{**vars(ctx),
                                          "platform": "cpu"})) is None
