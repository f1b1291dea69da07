"""Nothing the benchmark runs imports JAX or the JAX package, or reads
the JAX benchmark's folder; the reference imports nothing of the port."""
import json
import subprocess
import sys
import textwrap

from perfbench.tests.tiny import REPO, tiny_copy

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

HEAD = """
import json, sys
opened = []
sys.addaudithook(lambda ev, args: opened.append(str(args[0]))
                 if ev == "open" and isinstance(args[0], str) else None)
sys.path[:0] = [{root!r}, {src!r}]
from pathlib import Path
"""
TAIL = """
print(json.dumps({"modules": sorted({m.split(".")[0] for m in sys.modules}),
                  "opened": opened}))
"""


def _probe(body: str, root) -> dict:
    code = (HEAD.format(root=str(root), src=str(REPO / "src"))
            + textwrap.dedent(body) + TAIL)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_and_reads_no_jax_benchmark(tmp_path):
    root = tiny_copy(tmp_path)
    got = _probe("""
        import time, torch
        from perfbench.lib import runner, spec
        root = Path(ROOT)
        bench = spec.benchmark(root)
        for w in bench["workloads"]:
            spec.cell(w["name"], root / "perfbench")
        for m in bench["per_layer"]:
            spec.reader(m["name"], root / "perfbench")
        for g in sorted((root / "perfbench" / "generators").glob("*.py")):
            spec.generator(g.stem, root / "perfbench")
        runner.run_cell("train-tiny", 2**31 + 5, 0.1, False,
                        torch.device("cpu"), time.perf_counter(), root=root,
                        pkg=root / "perfbench")
        """.replace("ROOT", repr(str(root))), root)
    names = set(got["modules"])
    assert "repro_torch" in names and "perfbench" in names
    assert not names & FORBIDDEN, names & FORBIDDEN
    jax_bench = str(REPO / "benchmarks")
    assert not [p for p in got["opened"] if p.startswith(jax_bench)]


def test_the_reference_imports_nothing_of_the_program():
    got = _probe("""
        import perfbench.reference.env, perfbench.reference.nets
        import perfbench.reference.t2drl, perfbench.counts
        """, REPO)
    names = set(got["modules"])
    assert "perfbench" in names
    assert not names & (FORBIDDEN | {"repro_torch"})
