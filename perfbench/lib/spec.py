"""The benchmark's files, found by name.

``BENCHMARK.json`` at the root of the checkout lists the cells and the
metrics; everything that belongs to one configuration, one traffic mix,
one cell or one per-layer metric sits in a file of its own under
``perfbench/``:

- ``configs/<config>.json``: the configuration as it is run;
- ``traffic/<mix>.json``: a mix's parameters, with ``generator`` naming the
  general generator that reads them;
- ``generators/<generator>.py``: a generator, whose ``Traffic(cell, seed,
  device)`` drives the program: set-up, the measured window, the traced
  stretch and the check's readings;
- ``workloads/<cell>.json``: the cell's configuration and mix, parameters
  that override the mix's, and the limits of its output check;
- ``metrics/<metric>.py``: the reader of one per-layer metric.

Adding a cell, a mix, a configuration or a metric adds files and entries
only; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(Path(root) / "BENCHMARK.json")


def cell(name: str, pkg: Path = PKG) -> dict:
    """A cell with its configuration and mix read in: ``{"name",
    "workload", "config", "mix"}``, the mix's parameters updated by the
    cell's ``traffic_params``."""
    w = _json(pkg / "workloads" / f"{name}.json")
    mix = _json(pkg / "traffic" / f"{w['traffic']}.json")
    mix.update(w.get("traffic_params", {}))
    return {"name": name, "workload": w,
            "config": _json(pkg / "configs" / f"{w['config']}.json"),
            "mix": mix}


def metrics_of(bench: dict, cell_name: str) -> tuple:
    """The end-to-end and the per-layer metric entries that ``cell_name``
    reports: an entry with ``workloads`` lists its cells; a per-layer
    entry without one goes with every cell that reports the end-to-end
    metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (cell_name in m["workloads"] if "workloads" in m
               else m["moves"] in names)]
    return e2e, per


def _module(path: Path, prefix: str):
    spec = importlib.util.spec_from_file_location(
        prefix + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, pkg: Path = PKG):
    """The module of ``metrics/<metric>.py`` (its ``read(ctx)``)."""
    return _module(pkg / "metrics" / f"{metric}.py", "perfbench_metric_")


def generator(name: str, pkg: Path = PKG):
    """The module of ``generators/<name>.py`` (its ``Traffic``)."""
    return _module(pkg / "generators" / f"{name}.py", "perfbench_generator_")
