"""Counts how often torch's CPU ``exp`` goes wrong on its first call in a
fresh process, with the intra-op pool at N threads and at one.

Each trial is a fresh Python process that takes ``torch.exp`` of 8192 f32
values in [-3, 0] twice and reports the largest error relative to the f64
answer; a trial is wrong when it exceeds 1e-6.  Trials run ``--parallel``
at a time, so the processes contend for the cores as a parallel test
run's workers do.  The threaded trials and the one-thread trials
alternate, so both see the same load.

    python tests/_exp_thread_probe.py --trials 1000 --parallel 16

(Not a test: a tool behind the note on ``tests/test_torch_kernels.py``'s
one-thread fixture.)
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

_TRIAL = """
import sys
import numpy as np
import torch
torch.set_num_threads(int(sys.argv[1]))
x = torch.tensor(np.random.default_rng(int(sys.argv[2]))
                 .uniform(-3, 0, 8192).astype(np.float32))
exact = torch.tensor(np.exp(x.numpy().astype(np.float64)))
print(max(((torch.exp(x).double() - exact).abs() / exact).max().item()
          for _ in range(2)))
"""


def _trial(threads: int, seed: int) -> float:
    out = subprocess.run([sys.executable, "-c", _TRIAL, str(threads),
                          str(seed)], capture_output=True, text=True,
                         check=True)
    return float(out.stdout.split()[-1])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trials", type=int, default=1000,
                    help="trials per thread count")
    ap.add_argument("--parallel", type=int, default=16)
    ap.add_argument("--threads", type=int, default=8)
    args = ap.parse_args()
    jobs = [(t, i) for i in range(args.trials) for t in (args.threads, 1)]
    with ThreadPoolExecutor(args.parallel) as pool:
        errs = list(pool.map(lambda j: _trial(*j), jobs))
    out = {}
    for (t, _), e in zip(jobs, errs):
        row = out.setdefault(f"threads={t}", {"trials": 0, "wrong": 0,
                                              "max_rel_err": 0.0})
        row["trials"] += 1
        row["wrong"] += e > 1e-6
        row["max_rel_err"] = max(row["max_rel_err"], e)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
