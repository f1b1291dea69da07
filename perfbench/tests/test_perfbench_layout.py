"""BENCHMARK.json against the rules its readers hold it to, and the harness
found by name: a new cell, mix and metric are files and entries only."""
import hashlib
import json
import re
import subprocess
import sys
import time

import pytest
import torch

from perfbench.lib import runner, spec
from perfbench.tests.tiny import REPO, tiny_copy

sys.path.insert(0, str(REPO / "src"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs_cells_and_their_files():
    bench = BENCH
    cfgs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["why"])
        assert json.loads((REPO / c["file"]).read_text())["name"] == \
            c["name"]
    used = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and _line(w["why"]) and w["chips"] == 1
        cell = spec.cell(w["name"])
        assert cell["workload"]["config"] == w["config"] in cfgs
        assert cell["workload"]["traffic"] == w["traffic"]
        assert cell["workload"]["why"] == w["why"]
        gen = cell["mix"]["generator"]
        assert NAME.match(gen)
        assert hasattr(spec.generator(gen), "Traffic")
        used.add(w["config"])
    assert used == set(cfgs)
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) \
        == len(bench["workloads"])


def test_metrics():
    bench = BENCH
    e2e, per = bench["end_to_end"], bench["per_layer"]
    names = [m["name"] for m in e2e + per]
    assert len(names) == len(set(names))
    assert e2e[0]["name"] == "setup_s" and e2e[0]["bound"] <= 0.25
    for m in e2e:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in bench["workloads"]}
    for m in per:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert _line(m["layer"])
        assert (REPO / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
        moves = next(e for e in e2e if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moves.get("workloads", cells))
    for cell in cells:
        got, per_cell = spec.metrics_of(bench, cell)
        assert "setup_s" in {m["name"] for m in got} and len(got) >= 2
        assert per_cell


def test_a_new_cell_mix_and_metric_need_no_edit(tmp_path):
    root = tiny_copy(tmp_path)
    pkg = root / "perfbench"
    before = {p: hashlib.sha256(p.read_bytes()).hexdigest()
              for p in pkg.rglob("*") if p.is_file()}
    mix = json.loads((pkg / "traffic" / "decide_batch.json").read_text())
    mix["cells"] = 16
    (pkg / "traffic" / "decide_wide.json").write_text(json.dumps(mix))
    w = json.loads((pkg / "workloads" / "decide-tiny.json").read_text())
    w.update(traffic="decide_wide", traffic_params={"trace_decisions": 3})
    (pkg / "workloads" / "dummy-cell.json").write_text(json.dumps(w))
    (pkg / "metrics" / "dummy_decisions.decide.py").write_text(
        "def read(ctx):\n    return float(ctx.work['decisions'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "dummy-cell", "config": w["config"],
                               "traffic": "decide_wide", "chips": 1,
                               "why": "a dummy"})
    next(m for m in bench["end_to_end"]
         if m["name"] == "decision_card_ms")["workloads"].append("dummy-cell")
    bench["per_layer"].append({"name": "dummy_decisions.decide",
                               "unit": "decision", "better": "higher",
                               "source": "program_counter", "layer": "x",
                               "moves": "decision_card_ms",
                               "workloads": ["dummy-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    torch.set_num_threads(1)
    out = runner.run_cell("dummy-cell", 5, 0.1, True, torch.device("cpu"),
                          time.perf_counter(), root=root, pkg=pkg)
    assert out["metrics"] == {"dummy_decisions.decide": {
        "value": 3.0, "unit": "decision"}}
    assert out["correct"]
    after = {p: hashlib.sha256(p.read_bytes()).hexdigest()
             for p in before}
    assert after == before


# a generator of a mix that needs behaviour of its own: the decide loop,
# its cell's end-to-end metric the window's longest decision
WORST = """
from pathlib import Path

from perfbench.lib import spec

base = spec.generator("decide", Path(__file__).resolve().parents[1])


class Traffic(base.Traffic):
    @staticmethod
    def end_to_end(w):
        return {"decision_ms_max": max(w["unit_s"])}
"""


def test_a_new_generator_is_a_file_found_by_its_name(tmp_path):
    root = tiny_copy(tmp_path)
    pkg = root / "perfbench"
    before = {p: hashlib.sha256(p.read_bytes()).hexdigest()
              for p in pkg.rglob("*") if p.is_file()}
    (pkg / "generators" / "decide_worst.py").write_text(WORST)
    mix = json.loads((pkg / "traffic" / "decide_batch.json").read_text())
    mix.update(generator="decide_worst", cells=16)
    (pkg / "traffic" / "decide_worst.json").write_text(json.dumps(mix))
    w = json.loads((pkg / "workloads" / "decide-tiny.json").read_text())
    w.update(traffic="decide_worst", traffic_params={})
    (pkg / "workloads" / "worst-cell.json").write_text(json.dumps(w))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "worst-cell", "config": w["config"],
                               "traffic": "decide_worst", "chips": 1,
                               "why": "a dummy"})
    bench["end_to_end"].append({"name": "decision_ms_max", "unit": "ms",
                                "better": "lower", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["worst-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    torch.set_num_threads(1)
    out = runner.run_cell("worst-cell", 6, 0.1, False, torch.device("cpu"),
                          time.perf_counter(), root=root, pkg=pkg)
    assert out["metrics"]["decision_ms_max"]["value"] == \
        out["window"]["unit_max"]
    assert out["correct"]
    after = {p: hashlib.sha256(p.read_bytes()).hexdigest()
             for p in before}
    assert after == before


@pytest.mark.parametrize("only_bench", [False, True])
def test_the_command_refuses_without_a_card_or_the_program(tmp_path,
                                                           only_bench):
    """Here no card is present; in a checkout of BENCHMARK.json and the
    benchmark's files alone the program is missing as well."""
    import shutil
    cwd = REPO
    if only_bench:
        shutil.copy(REPO / "BENCHMARK.json", tmp_path)
        shutil.copytree(REPO / "perfbench", tmp_path / "perfbench",
                        ignore=shutil.ignore_patterns("__pycache__"))
        cwd = tmp_path
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          "decide-table2-c4096", "--seed", "1", "--seconds",
                          "1"], cwd=cwd, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert not out.stdout.strip()
