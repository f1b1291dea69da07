"""The port's public names (ROADMAP A.13), on the CPU.

* Every name a reference package's ``__init__`` exports resolves in its
  port twin, but for the ``jax``/``jnp`` modules and the three Pallas
  source modules.
* ``run_episode`` against the JAX package's ``run_episode`` with the
  env's draws injected (the mechanism of ``tests/test_torch_cache.py``),
  ``static_popular_cache_batch`` exactly against JAX's,
  ``random_cache_batch`` with the permutations injected, and
  ``bf16_safe_cast``.
* The example twins import only the port's public names (an AST check),
  and the quickstart twin runs in a subprocess at one episode.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import bf16_safe_cast as jbf16_safe_cast
from repro.core import baselines as jbase
from repro.core import env as jenv
from repro.core import t2drl as jt2
from repro_torch.bridge import (env_state_from_numpy, models_from_numpy,
                                train_state_from_numpy)
from repro_torch.checkpoint import bf16_safe_cast
from repro_torch.core import baselines as tbase
from repro_torch.core import env as tenv
from repro_torch.core import t2drl as tt2
from test_torch_cache import EP_ENV

REPO = Path(__file__).resolve().parents[1]
PACKAGES = sorted(p.name for p in (REPO / "src" / "repro").iterdir()
                  if (p / "__init__.py").is_file())
NOT_NAMES = {"jax", "jnp"}                  # the reference's own imports
PALLAS_SOURCES = {"kernels": {"ddpm_step", "flash_attention", "ssd_scan"}}
TWINS = ("quickstart", "serve_edge", "train_lm")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _exported(pkg: str) -> set:
    """The public names the reference's ``repro/<pkg>/__init__.py``
    binds: imports, assignments, definitions, ``__all__``, and the lazy
    names of its module ``__getattr__`` (``_AGENT_COMPAT``)."""
    tree = ast.parse((REPO / "src" / "repro" / pkg / "__init__.py")
                     .read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    mod = __import__(f"repro.{pkg}", fromlist=["_"])
    names |= set(getattr(mod, "__all__", ()))
    names |= set(getattr(mod, "_AGENT_COMPAT", ()))
    return {n for n in names if not n.startswith("_") and n != "annotations"}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_every_reference_export_resolves_in_the_port(pkg):
    import importlib
    twin = importlib.import_module(f"repro_torch.{pkg}")
    skip = NOT_NAMES | PALLAS_SOURCES.get(pkg, set())
    want = _exported(pkg)
    missing = sorted(n for n in want - skip if not hasattr(twin, n))
    assert not missing, f"repro_torch.{pkg} lacks {missing}"


def _replayed_states(key, ec):
    """reset, [(advanced, [slot states])] of the JAX env, as
    ``tests/test_torch_cache.py`` replays them, through jitted steps."""
    env = reset = jax.jit(jenv.env_reset, static_argnums=1)(key, ec)
    advance = jax.jit(jenv.env_advance_frame, static_argnums=1)
    step = jax.jit(lambda e: jenv._refresh_slot(
        jax.random.split(e.key)[0],
        e._replace(key=jax.random.split(e.key)[1]), ec))
    frames = []
    for _ in range(ec.T):
        env = advance(env, ec)
        adv, slots = env, []
        for _ in range(ec.K):
            env = step(env)
            slots.append(env)
        frames.append((adv, slots))
    return reset, frames


def test_run_episode_matches_jax_with_the_env_draws_injected(monkeypatch):
    """An rcars/lru episode (no learned draw) on the JAX env's states: the
    same stats and final cache as the JAX package's ``run_episode``."""
    ecj, ect = jenv.EnvCfg(**EP_ENV), tenv.EnvCfg(**EP_ENV)
    cfg_j = jt2.T2DRLCfg(env=ecj, allocator="rcars", cacher="lru", L=2)
    cfg_t = tt2.T2DRLCfg(env=ect, allocator="rcars", cacher="lru", L=2)
    ts_j = jax.jit(jt2.t2drl_init, static_argnums=1)(jax.random.PRNGKey(3),
                                                    cfg_j)
    ts_t = train_state_from_numpy(jax.tree.map(np.asarray, ts_j), cfg_t,
                                  device="cpu")
    key = jax.random.PRNGKey(4)
    reset, frames = _replayed_states(jax.random.split(key)[0], ecj)
    gen = torch.Generator().manual_seed(0)
    conv = lambda e: env_state_from_numpy(  # noqa: E731
        jax.tree.map(np.asarray, e), gen)
    queue = {"frames": list(frames)}
    real_step = tt2.env_step_slot

    def advance(env, ec, P=None, mod=None):
        adv, slots = queue["frames"].pop(0)
        queue["slots"] = list(slots)
        return conv(adv)._replace(rho=env.rho)

    def step_slot(env, ec, models, b, xi, mask=None, mod=None):
        _, r, m = real_step(env, ec, models, b, xi, mask, mod)
        return conv(queue["slots"].pop(0))._replace(rho=env.rho), r, m

    monkeypatch.setattr(tt2, "env_reset", lambda g, ec, mod=None:
                        conv(reset))
    monkeypatch.setattr(tt2, "env_advance_frame", advance)
    monkeypatch.setattr(tt2, "env_step_slot", step_slot)
    from repro_torch.core import run_episode
    ts_t, stats = run_episode(ts_t, cfg_t, gen, 1.0, 0.1)
    jts, jstats = jt2.run_episode(ts_j, cfg_j, key, 1.0, 0.1)
    assert set(stats) == set(jstats)
    for k in stats:
        np.testing.assert_allclose(stats[k].item(), float(jstats[k]),
                                   rtol=2e-5, atol=2e-5, err_msg=k)
    for k, v in jts["cache"].items():
        np.testing.assert_array_equal(ts_t["cache"][k].numpy(),
                                      np.asarray(v), k)
    assert not queue["frames"]


def _zoos(B: int):
    ec = jenv.EnvCfg(U=3, M=6, C=9.0)
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    jm = jenv.make_models_batch(keys, ec)
    return ec, tenv.EnvCfg(U=3, M=6, C=9.0), keys, jm, models_from_numpy(
        jax.tree.map(np.asarray, jm), "cpu")


def test_static_popular_cache_batch_matches_jax():
    ecj, ect, _, jm, tm = _zoos(5)
    want = np.asarray(jbase.static_popular_cache_batch(jm, ecj))
    got = tbase.static_popular_cache_batch(tm, ect)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size


def test_random_cache_batch_matches_jax_with_its_orders_injected(
        monkeypatch):
    """JAX's per-cell permutations fed to the port's draws, cell by cell;
    and, drawn for real, cell b's order comes from ``generators[b]``."""
    ecj, ect, keys, jm, tm = _zoos(5)
    want = np.asarray(jbase.random_cache_batch(keys, jm, ecj))
    perms = [torch.tensor(np.asarray(jax.random.permutation(k, ecj.M)))
             for k in keys]
    real = torch.randperm
    monkeypatch.setattr(torch, "randperm", lambda n, **kw: perms.pop(0))
    gens = [torch.Generator().manual_seed(b) for b in range(5)]
    got = tbase.random_cache_batch(gens, tm, ect)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not perms
    monkeypatch.setattr(torch, "randperm", real)
    got = tbase.random_cache_batch(
        [torch.Generator().manual_seed(b) for b in range(5)], tm, ect)
    for b in range(5):
        one = tbase.random_cache(torch.Generator().manual_seed(b),
                                 tenv.ModelParams(*(f[b] for f in tm)), ect)
        assert torch.equal(got[b], one)


def test_bf16_safe_cast_matches_the_reference():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 4)).astype(np.float32)
    b = rng.integers(0, 9, 5).astype(np.int32)
    tree = {"w": torch.tensor(a).to(torch.bfloat16),
            "rest": [torch.tensor(b), (torch.tensor(a),)]}
    jtree = {"w": jnp.asarray(a, jnp.bfloat16),
             "rest": [jnp.asarray(b), (jnp.asarray(a),)]}
    got, want = bf16_safe_cast(tree), jbf16_safe_cast(jtree)
    assert got["w"].dtype == torch.float32
    assert got["rest"][0].dtype == torch.int32
    assert isinstance(got["rest"][1], tuple)
    assert got["rest"][1][0] is tree["rest"][1][0]
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    np.testing.assert_array_equal(got["rest"][0].numpy(),
                                  np.asarray(want["rest"][0]))


def _imports(path: Path) -> list:
    """(module, [names]) of every import of a source file."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out += [(a.name, []) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            out.append((node.module or "", [a.name for a in node.names]))
    return out


@pytest.mark.parametrize("name", TWINS)
def test_example_twins_use_the_ports_public_names_alone(name):
    src = REPO / "examples" / f"{name}_torch.py"
    stdlib = {"argparse", "time"}
    imports = _imports(src)
    assert any(m.startswith("repro_torch") for m, _ in imports)
    for mod, names in imports:
        top = mod.split(".")[0]
        assert top in stdlib | {"numpy", "torch", "repro_torch"}, mod
        if top == "repro_torch":
            assert not any(p.startswith("_") for p in mod.split(".")), mod
            assert not any(n.startswith("_") for n in names), (mod, names)
    # the reference example is its twin's: same arguments, and --device
    ref = {a.args[0].value for a in ast.walk(ast.parse(
        (REPO / "examples" / f"{name}.py").read_text()))
        if isinstance(a, ast.Call) and getattr(a.func, "attr", "")
        == "add_argument"}
    twin = {a.args[0].value for a in ast.walk(ast.parse(src.read_text()))
            if isinstance(a, ast.Call) and getattr(a.func, "attr", "")
            == "add_argument"}
    assert twin == ref | {"--device"} | (
        {"--episodes"} if name == "quickstart" else set())


def test_quickstart_twin_runs_one_episode_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, str(REPO / "examples" / "quickstart_torch.py"),
         "--episodes", "1", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=str(REPO), env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    for tag in ("model hit ratio", "RCARS baseline", "flash-crowd"):
        line = next(l for l in lines if tag in l)
        nums = [float(t) for t in line.replace(":", " ").split()
                if t.lstrip("-").replace(".", "", 1).isdigit()]
        assert nums and all(np.isfinite(nums)), line
