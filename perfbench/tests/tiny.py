"""A copy of the benchmark with two tiny cells added, for CPU tests.

``tiny_copy(dest)`` copies ``BENCHMARK.json`` and ``perfbench/`` into
``dest`` and adds, as data files and entries only, a configuration
``tiny`` (Table 2's with U = 3, M = 4, T = 5, K = 3, L = 2, warmup 5; the
networks keep their widths, which the program fixes) and the cells
``train-tiny`` (2 learners of ``tiny``) and ``decide-tiny`` (512 cells of
Table 2's configuration: the control's widest gap needs many rows to
show), each holding the limits of the Table 2 cell of its mix.  The train
cells are not in ``BENCHMARK.json`` yet, so ``train-tiny`` brings the
end-to-end metric ``train_cell_slots_per_s`` and the readers
``metrics/*.train.py`` into the copy itself.  Nothing is edited but
``BENCHMARK.json``'s lists.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TINY_CELLS = {"train-tiny": ("train-table2-b64", "tiny", {"cells": 2}),
              "decide-tiny": ("decide-table2-c4096", "t2drl-table2",
                              {"cells": 512, "trace_decisions": 6})}


def _dump(obj, path: Path) -> None:
    path.write_text(json.dumps(obj, indent=1))


def _train_metrics(bench: dict, pkg: Path) -> None:
    """The train mix's end-to-end metric and its ``.train`` readers, for
    ``train-tiny`` alone."""
    bench["end_to_end"].append({
        "name": "train_cell_slots_per_s", "unit": "cell-slots/s",
        "better": "higher", "bound": 0.25, "source": "host_clock",
        "workloads": ["train-tiny"]})
    for path in sorted((pkg / "metrics").glob("*.train.py")):
        bench["per_layer"].append({
            "name": path.name[:-3], "unit": "x", "better": "higher",
            "source": "device_trace", "layer": "a CPU rehearsal",
            "moves": "train_cell_slots_per_s", "workloads": ["train-tiny"]})


def tiny_copy(dest: Path) -> Path:
    dest = Path(dest)
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(REPO / "perfbench", dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    pkg = dest / "perfbench"
    cfg = json.loads((pkg / "configs" / "t2drl-table2.json").read_text())
    cfg["name"] = "tiny"
    cfg["env"].update(U=3, M=4, T=5, K=3)
    cfg["t2drl"].update(L=2, warmup=5)
    _dump(cfg, pkg / "configs" / "tiny.json")
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    _train_metrics(bench, pkg)
    for name, (like, config, params) in TINY_CELLS.items():
        w = json.loads((pkg / "workloads" / f"{like}.json").read_text())
        w.update(config=config, traffic_params=params)
        _dump(w, pkg / "workloads" / f"{name}.json")
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": w["traffic"], "chips": 1,
                                   "why": "a CPU rehearsal"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(name)
    _dump(bench, dest / "BENCHMARK.json")
    return dest
