"""The readings that the output check's limits are set from.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1 2 3 \
        [--window 2] [--control] [--fault unchanged|half_batch|altered]

For each seed in one process: the cell's set-up and a window of its
traffic (a serving cell's as long as a run's, ``--window 51``), then
every number the check compares, for the program and, with
``--control``, for the control: the plain reference in the program's
place, computed one precision below the configuration's (TF32 products
for float32, float8_e4m3fn product inputs for bf16).  ``--fault`` plants
one of ``lib.faults`` in the program first.  One JSON line per seed on
standard output; ``check_s`` in it gives the seconds the program's and
the control's readings took.  The limits in ``workloads/<cell>.json``
lie between the largest reading of sound runs and the smallest reading
of the control or of a fault.  Needs the card, as ``run.py`` does.
"""
import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--window", type=float, default=2.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from perfbench.lib import faults, runner
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        _, traffic = runner.make_traffic(args.workload, seed, dev)
        with (faults.planted(args.fault) if args.fault
              else contextlib.nullcontext()):
            traffic.setup()
            t1 = time.perf_counter()
            w = traffic.window(args.window)
        traffic.free()
        t2 = time.perf_counter()
        row = {"workload": args.workload, "seed": seed, "fault": args.fault,
               "setup_s": t1 - t0, "window": {k: v for k, v in w.items()
                                              if not isinstance(v, list)},
               "program": traffic.readings(),
               "worst_leaf": getattr(traffic, "where", None)}
        t3 = time.perf_counter()
        if args.control:
            row["control"] = traffic.readings(control=True)
        row["check_s"] = [t3 - t2, time.perf_counter() - t3]
        print(json.dumps(row), flush=True)
        del traffic
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
