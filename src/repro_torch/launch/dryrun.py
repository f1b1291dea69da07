"""Multi-pod dry run (port of ``repro.launch.dryrun``): one step of every
(architecture × input shape × mesh) traced as rank 0 of a fake world of
256 or 512 ranks, proving the distribution config coherent without
hardware.

The reference lowers and compiles the step ahead of time on 512 forced
host devices.  Here the world is torch's fake process group (backend
``"fake"``: every collective returns at once), the mesh
``make_production_mesh``'s, and ``build_step``'s bundle holds DTensors of
meta shards, so the step runs as rank 0 would, allocating nothing and
needing no card.  Per pair it reports rank 0's argument bytes (params,
moments, inputs and caches, exact from the local shapes), the peak of the
trace where ``torch.distributed._tools.mem_tracker`` gives one, the
collectives DTensor issued (bytes and counts by kind), the FLOPs and
bytes of rank 0's local ops, and the roofline terms with the H100
constants of ``launch.roofline``.  One JSON a pair goes under
``experiments/dryrun_torch/``.  It is a trace on a fake group, not a
measurement.

Usage:
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape decode_32k
  python -m repro_torch.launch.dryrun --all [--multi-pod|--both]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import (ARCH_IDS, SHAPES, canonical_id, get_arch,
                                 make_cfg, supports)
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import PerfOpts, build_step
from repro_torch.models import lm as lm_mod
from repro_torch.nn import sharding as shlib

OUT_DIR = "experiments/dryrun_torch"


@contextlib.contextmanager
def fake_world(n: int):
    """Rank 0 of a fake process group of ``n`` ranks (every collective
    returns at once), destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_bytes(tree) -> int:
    """Bytes of rank 0's shards of the DTensors (and of the plain
    tensors) in ``tree``."""
    total = 0
    for t in lm_mod.tree_leaves(tree):
        if not isinstance(t, torch.Tensor):
            continue
        t = t.to_local() if shlib.is_dtensor(t) else t
        total += t.numel() * t.element_size()
    return total


def _args_bytes(bundle, step: str) -> dict:
    a = bundle.args
    if step == "train":
        out = {"params": _local_bytes(a[0]), "moments": _local_bytes(
            [a[1]["mu"], a[1]["nu"]]), "inputs": _local_bytes(a[2]),
            "caches": 0}
    else:
        cache = a[-1] if step == "prefill" else a[2]
        inputs = a[1:-1] if step == "prefill" else (a[1], a[3])
        out = {"params": _local_bytes(a[0]), "moments": 0,
               "inputs": _local_bytes(list(inputs)),
               "caches": _local_bytes(cache)}
    out["total"] = sum(out.values())
    return out


def _trace(bundle, mesh):
    """One run of the step on the mesh, counted (``roofline.step_cost``),
    and its peak where the memory tracker gives one."""
    peak = {"bytes": None}
    try:
        from torch.distributed._tools.mem_tracker import MemTracker
        mt = MemTracker()
        with shlib.use_mesh(mesh), mt:
            _, cost = rl.step_cost(bundle.step_fn, *bundle.args)
        snap = mt.get_tracker_snapshot("peak")
        peak = {"bytes": int(sum(v.get("Total", 0) for dev in snap.values()
                                 for v in [dev] if isinstance(v, dict)))}
        if not peak["bytes"]:
            peak = {"bytes": None, "why": "the memory tracker saw no "
                    "storage: the trace's tensors are meta tensors"}
    except Exception as e:  # the tracker refused the trace
        peak = {"bytes": None, "why": f"memory tracker: {e!r}"[:300]}
        with shlib.use_mesh(mesh):
            _, cost = rl.step_cost(bundle.step_fn, *bundle.args)
    return cost, peak


def run_one(arch_name: str, shape: str, *, multi_pod: bool,
            out_dir: str = OUT_DIR, lr: float = 3e-4, save: bool = True,
            opts=None) -> dict:
    """Trace one pair in the current (fake) world, which must have the
    mesh's ranks.  Returns its record (``status`` "ok" or "skipped")."""
    opts = opts or PerfOpts()
    arch = get_arch(arch_name)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    rec = {"arch": arch.name, "shape": shape, "mesh": mesh_name,
           "family": arch.family, "cite": arch.cite, "opts": opts.tag,
           "what": "a trace of rank 0 on a fake process group, not a "
                   "measurement"}
    ok, why = supports(arch, shape)
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        return rec
    t0 = time.time()
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size()
    cfg = make_cfg(arch, shape)
    bundle = build_step(arch, shape, mesh, lr=lr, opts=opts)
    t_build = time.time() - t0
    cost, peak = _trace(bundle, mesh)
    t_trace = time.time() - t0 - t_build
    coll = cost.pop("collectives")

    sc = SHAPES[shape]
    n_params = sum(t.numel() for t in lm_mod.tree_leaves(bundle.args[0]))
    frac = rl.active_fraction(cfg)
    tokens = sc.global_batch * (sc.seq_len if sc.step != "decode" else 1)
    mf = rl.model_flops(n_params * frac, tokens,
                        "train" if sc.step == "train" else "infer")
    roof = rl.roofline(cost, coll, chips=chips, model_flops_total=mf)
    rec.update({
        "status": "ok", "step": sc.step, "chips": chips,
        "seq_len": sc.seq_len, "global_batch": sc.global_batch,
        "n_params": int(n_params), "active_frac": frac,
        "tokens_per_step": tokens,
        "build_s": round(t_build, 2), "trace_s": round(t_trace, 2),
        "arg_bytes_per_rank": _args_bytes(bundle, sc.step),
        "peak": peak,
        "collectives": {k: v for k, v in coll.items() if k != "counts"},
        "collective_counts": coll["counts"],
        "cost": cost,
        "roofline": roof.as_dict(),
    })
    if save:
        os.makedirs(out_dir, exist_ok=True)
        suffix = "" if opts.tag == "base" else f"_{opts.tag}"
        fn = f"{canonical_id(arch_name)}_{shape}_{mesh_name}{suffix}.json"
        with open(os.path.join(out_dir, fn), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def _summary_line(rec: dict) -> str:
    if rec["status"] != "ok":
        return (f"{rec['arch']:18s} {rec['shape']:12s} {rec['mesh']:10s} "
                f"SKIP ({rec['reason'][:40]}...)")
    r = rec["roofline"]
    arg_gb = rec["arg_bytes_per_rank"]["total"] / 2**30
    peak = rec["peak"]["bytes"]
    peak_s = f"{peak / 2**30:7.2f}GiB" if peak else "    n/a"
    return (f"{rec['arch']:18s} {rec['shape']:12s} {rec['mesh']:10s} "
            f"comp {r['compute_s']:9.4f}s mem {r['memory_s']:9.4f}s "
            f"coll {r['collective_s']:9.4f}s -> {r['bottleneck']:10s} "
            f"| arg {arg_gb:7.2f}GiB peak {peak_s} "
            f"| build {rec['build_s']:.0f}s trace {rec['trace_s']:.0f}s")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both", action="store_true",
                    help="run single-pod AND multi-pod meshes")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--continue-on-error", action="store_true")
    ap.add_argument("--fsdp", action="store_true",
                    help="ZeRO-3: shard params+moments over data/pod axes")
    ap.add_argument("--bf16-moments", action="store_true")
    ap.add_argument("--impl", default="plain", choices=["plain", "chunked"],
                    help="attention path; the kernels ('kernel') launch "
                         "on device memory, which a meta trace has not")
    ap.add_argument("--ring", action="store_true",
                    help="ring-buffer sliding-window decode caches")
    ap.add_argument("--moe-shardmap", action="store_true",
                    help="expert-parallel MoE dispatch")
    args = ap.parse_args(argv)
    opts = PerfOpts(fsdp=args.fsdp, bf16_moments=args.bf16_moments,
                    impl=args.impl, ring=args.ring,
                    moe_shardmap=args.moe_shardmap)

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both else [args.multi_pod]

    failures = []
    for mp in meshes:
        with fake_world(512 if mp else 256):
            for a in archs:
                for s in shapes:
                    try:
                        rec = run_one(a, s, multi_pod=mp, out_dir=args.out,
                                      opts=opts)
                        print(_summary_line(rec), flush=True)
                    except Exception as e:
                        failures.append((a, s, mp, repr(e)))
                        print(f"{a:18s} {s:12s} {'mp' if mp else 'sp':10s} "
                              f"FAIL {e!r}", flush=True)
                        if not args.continue_on_error:
                            traceback.print_exc()
                            raise SystemExit(1)
    if failures:
        print(f"\n{len(failures)} FAILURES")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("\nAll dry-runs lowered + compiled successfully.")


if __name__ == "__main__":
    main()
