"""Run one cell of the benchmark once, on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Prints, as its last line on standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number of the output check beside its limit, which also close standard
error.  Exits non-zero, printing no result, where no card is present or
fewer than the cell asks for, and where the process has loaded JAX or the
JAX package (``repro``).  Every cache the run builds lies in the
checkout: the kernels' libraries under ``build/torch_kernels``, any
Triton or extension cache under ``build/perfbench_cache``, and the
bytecode that Python compiles from every module it imports under
``build/perfbench_cache/pycache``, written whatever
``PYTHONDONTWRITEBYTECODE`` says, so that only a checkout's first run
compiles torch's sources.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _caches() -> None:
    cache = ROOT / "build" / "perfbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(cache / sub)
    sys.pycache_prefix = str(cache / "pycache")
    sys.dont_write_bytecode = False


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    marks = [("start", time.perf_counter(), time.process_time())]
    import torch
    marks.append(("torch_import", time.perf_counter(), time.process_time()))
    from perfbench.lib import runner, spec
    marks.append(("harness_import", time.perf_counter(),
                  time.process_time()))
    chips = next((w["chips"] for w in spec.benchmark(ROOT)["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    marks.append(("cuda_start", time.perf_counter(), time.process_time()))
    if found < chips:
        print(f"the cell needs {chips} CUDA device(s); {found} found",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    # each phase of set-up before the cell's own: wall and CPU seconds
    phases = {name: [t - t0, c - c0] for (_, t0, c0), (name, t, c)
              in zip(marks, marks[1:])}
    phases["args"] = [marks[0][1] - T_START, marks[0][2]]
    bad = []

    def after_window():
        bad.extend(forbidden_modules())

    out = runner.run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), torch.device("cuda", 0), T_START,
                          after_window=after_window)
    bad = sorted(set(bad) | set(forbidden_modules()))
    if bad:
        print(f"modules of JAX or the JAX package are loaded: {bad}",
              file=sys.stderr)
        return 3
    print("setup " + json.dumps({**phases, **out.pop("setup")}),
          file=sys.stderr)
    print("window " + json.dumps(out.pop("window")), file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
