"""The classical cache policies of the port (``repro_torch.core.
cache_policies``) and the cachers built on them, on the CPU.

Every decision is integer arithmetic, so every comparison here is exact:

* each policy against the pure-Python loops of ``tests/_cache_refs.py``
  over seeded streams (sizes, capacities, masked accesses), one cell and
  B = 4 cells in one batched call, access by access: hit, admitted,
  evicted, and every state leaf;
* the same against the JAX machines (``repro.core.cache_policies``,
  vmapped over B = 4 cells) on a few streams;
* invariants: the resident units never exceed the capacity, and every
  valid access is a hit or a miss, the resident count moving by the
  admissions less the evictions;
* a training episode per classical cacher with the env's draws injected
  (the JAX env's states, step by step): the resident set of every frame
  equals what the JAX cacher's ``step_frame`` gives on the same request
  streams, and, for ARC, the final cache state and hit ratio equal those
  of the JAX package's own ``run_episode``.
"""
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.agents import cachers as jcachers
from repro.core import cache_policies as jcp
from repro.core import env as jenv
from repro.core import t2drl as jt2
from repro_torch.bridge import env_state_from_numpy, train_state_from_numpy
from repro_torch.core import cache_policies as tcp
from repro_torch.core import env as tenv
from repro_torch.core import t2drl as tt2

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _cache_refs import CACHE_REFS  # noqa: E402

KINDS = tcp.CACHE_POLICIES


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tests run many small ops, which several
    threads only slow down when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed, M, n):
    """A seeded stream: item sizes, capacity (sometimes below the largest
    item), requests and ~15% invalid (masked) accesses."""
    rng = np.random.default_rng(seed)
    c_units = rng.integers(64, 400, size=M).astype(np.int32)
    cap = int(rng.integers(96, max(int(c_units.sum()), 97)))
    stream = rng.integers(0, M, size=n)
    valid = rng.random(n) > 0.15
    return c_units, cap, stream, valid


_STATE_REF = {"in_t1": "in_t1", "in_t2": "in_t2", "in_b1": "in_b1",
              "in_b2": "in_b2", "last": "last", "glast": "glast",
              "freq": "freq"}


def _check_against_refs(kind, cases):
    """Run the cells of ``cases`` (same M and length) through one batched
    port call per access and each through its oracle."""
    B, M, n = len(cases), len(cases[0][0]), len(cases[0][2])
    cu = torch.tensor(np.stack([c[0] for c in cases]))
    cap = torch.tensor([c[1] for c in cases])
    st = tcp.cache_state_init(M, lead=(B,))
    refs = [CACHE_REFS[kind](M, c[0], c[1]) for c in cases]
    for i in range(n):
        m = torch.tensor([c[2][i] for c in cases])
        v = torch.tensor([bool(c[3][i]) for c in cases])
        st, info = tcp.cache_access(kind, st, m, cu, cap, v)
        for b, (ref, c) in enumerate(zip(refs, cases)):
            want = ref.access(int(c[2][i]), bool(c[3][i]))
            assert bool(info["hit"][b]) == want["hit"], (kind, i, b)
            assert bool(info["admitted"][b]) == want["admitted"], (kind, i)
            np.testing.assert_array_equal(info["evicted"][b].numpy(),
                                          want["evicted"])
            for k, attr in _STATE_REF.items():
                np.testing.assert_array_equal(st[k][b].numpy(),
                                              getattr(ref, attr),
                                              err_msg=f"{kind} {k} at {i}")
            assert st["time"][b].item() == ref.time
            assert st["p"][b].item() == ref.p


@pytest.mark.parametrize("kind", KINDS)
def test_policies_match_the_python_references_one_cell(kind):
    for seed in range(8):
        _check_against_refs(kind, [_case(seed, 4 + seed % 7, 120)])


@pytest.mark.parametrize("kind", KINDS)
def test_policies_match_the_python_references_batched(kind):
    for seed in range(3):
        _check_against_refs(kind, [_case(100 + 10 * seed + b, 10, 150)
                                   for b in range(4)])


def test_state_layout_matches_the_jax_machines():
    j = jax.tree.map(np.asarray, jcp.cache_state_init(6))
    t = tcp.cache_state_init(6)
    assert set(j) == set(t)
    for k in j:
        assert t[k].numpy().dtype == j[k].dtype and t[k].shape == j[k].shape
        np.testing.assert_array_equal(t[k].numpy(), j[k])
    c = np.array([2.0, 2.5, 9.99, 10.0], np.float32)
    np.testing.assert_array_equal(tcp.quantize_sizes(torch.from_numpy(c))
                                  .numpy(), np.asarray(jcp.quantize_sizes(c)))
    assert tcp.quantize_capacity(20.3) == jcp.quantize_capacity(20.3)
    assert tcp.SIZE_UNITS_PER_GB == jcp.SIZE_UNITS_PER_GB
    assert tcp.CACHE_POLICIES == jcp.CACHE_POLICIES


@functools.lru_cache(maxsize=None)
def _jax_trace(kind):
    """The JAX machine scanned over a stream and vmapped over cells: final
    state and the (n, B) / (n, B, M) decision trace."""
    def run(c_units, cap, stream, valid):
        def one(st, mx):
            m, v = mx
            st, info = jax.vmap(
                lambda s, mm, c, cp, vv: jcp.cache_access(kind, s, mm, c,
                                                          cp, vv))(
                st, m, c_units, cap, v)
            return st, info
        B, M = c_units.shape
        st0 = jax.vmap(lambda _: jcp.cache_state_init(M))(jnp.arange(B))
        return jax.lax.scan(one, st0, (stream, valid))
    return jax.jit(run)


@pytest.mark.parametrize("kind", KINDS)
def test_policies_match_the_jax_machines_batched(kind):
    B, M, n = 4, 10, 200
    for seed in range(2):
        cases = [_case(500 + 7 * seed + b, M, n) for b in range(B)]
        cu = np.stack([c[0] for c in cases])
        cap = np.array([c[1] for c in cases], np.int32)
        stream = np.stack([c[2] for c in cases], axis=1).astype(np.int32)
        valid = np.stack([c[3] for c in cases], axis=1)
        jst, jinfo = _jax_trace(kind)(cu, cap, stream, valid)
        st = tcp.cache_state_init(M, lead=(B,))
        for i in range(n):
            st, info = tcp.cache_access(
                kind, st, torch.from_numpy(stream[i]).long(),
                torch.from_numpy(cu), torch.from_numpy(cap),
                torch.from_numpy(valid[i]))
            for k in ("hit", "admitted", "evicted"):
                np.testing.assert_array_equal(info[k].numpy(),
                                              np.asarray(jinfo[k][i]))
        for k, v in jst.items():
            np.testing.assert_array_equal(st[k].numpy(), np.asarray(v), k)


@pytest.mark.parametrize("kind", KINDS)
def test_capacity_and_access_conservation(kind):
    c_units, cap, stream, valid = _case(7, 8, 300)
    cu = torch.from_numpy(c_units)
    st = tcp.cache_state_init(8)
    hits = misses = 0
    for m, v in zip(stream, valid):
        before = tcp.cache_rho(st)
        st, info = tcp.cache_access(kind, st, torch.tensor(int(m)), cu, cap,
                                    torch.tensor(bool(v)))
        rho = tcp.cache_rho(st)
        assert int((rho * cu).sum()) <= cap
        if not v:
            assert torch.equal(rho, before) and not info["hit"] \
                and not info["evicted"].any()
            continue
        hits += int(info["hit"])
        misses += int(~info["hit"])
        assert int(rho.sum()) == int(before.sum()) + int(info["admitted"]) \
            - int(info["evicted"].sum())
        assert not (info["hit"] and info["admitted"])
    assert hits + misses == int(valid.sum()) and hits > 0


def test_cache_access_rejects_unknown_kinds():
    with pytest.raises(ValueError, match="unknown cache policy"):
        tcp.cache_access("fifo", tcp.cache_state_init(3),
                         torch.tensor(0), torch.ones(3, dtype=torch.int32),
                         5)


# -- a training episode per classical cacher, the env's draws injected --------

EP_ENV = dict(U=3, M=5, T=4, K=3, C=14.0)


def _replayed_states(key, ec):
    """reset, [(advanced, [slot states])] of the JAX env."""
    env = jenv.env_reset(key, ec)
    reset = env
    frames = []
    step = jax.jit(lambda e: jenv._refresh_slot(
        jax.random.split(e.key)[0],
        e._replace(key=jax.random.split(e.key)[1]), ec))
    for _ in range(ec.T):
        env = jenv.env_advance_frame(env, ec)
        adv, slots = env, []
        for _ in range(ec.K):
            env = step(env)
            slots.append(env)
        frames.append((adv, slots))
    return reset, frames


@pytest.mark.parametrize("kind,allocator", [("lru", "rcars"),
                                            ("lfu", "rcars"),
                                            ("lru-ghost", "rcars"),
                                            ("arc", "d3pg")])
def test_training_episode_resident_sets_match_jax(kind, allocator,
                                                  monkeypatch):
    ecj, ect = jenv.EnvCfg(**EP_ENV), tenv.EnvCfg(**EP_ENV)
    cfg_j = jt2.T2DRLCfg(env=ecj, allocator=allocator, cacher=kind, L=2,
                         warmup=4)
    cfg_t = tt2.T2DRLCfg(env=ect, allocator=allocator, cacher=kind, L=2,
                         warmup=4)
    ts_j = jt2.t2drl_init(jax.random.PRNGKey(3), cfg_j)
    ts_t = train_state_from_numpy(jax.tree.map(np.asarray, ts_j), cfg_t,
                                  device="cpu")
    key = jax.random.PRNGKey(4)
    k_env = jax.random.split(key)[0]          # run_episode's env key
    reset, frames = _replayed_states(k_env, ecj)
    gen = torch.Generator().manual_seed(0)
    conv = lambda e: env_state_from_numpy(  # noqa: E731
        jax.tree.map(np.asarray, e), gen)
    queue = {"frames": list(frames)}
    seen_rho = []
    real_step = tt2.env_step_slot

    def reset_(generator, ec, mod=None):
        return conv(reset)

    def advance(env, ec, P=None, mod=None):
        adv, slots = queue["frames"].pop(0)
        queue["slots"] = list(slots)
        return conv(adv)._replace(rho=env.rho)

    def set_cache(env, rho):
        seen_rho.append(rho.clone())
        return env._replace(rho=rho)

    def step_slot(env, ec, models, b, xi, mask=None, mod=None):
        _, r, m = real_step(env, ec, models, b, xi, mask, mod)
        return conv(queue["slots"].pop(0))._replace(rho=env.rho), r, m

    for name, fn in (("env_reset", reset_), ("env_advance_frame", advance),
                     ("env_set_cache", set_cache),
                     ("env_step_slot", step_slot)):
        monkeypatch.setattr(tt2, name, fn)
    ts_t, stats = tt2._episode_core(ts_t, cfg_t, gen,
                                    {"eps": 1.0, "sigma": 0.1})
    # the JAX cacher's step_frame on the same request streams, frame by frame
    jc = jcachers.classical_cacher(kind, ecj)
    step_frame = jax.jit(jc.step_frame)
    cstate = jcp.cache_state_init(ecj.M)
    want_rho = []
    for adv, slots in frames:
        want_rho.append(np.asarray(jcp.cache_rho(cstate)))
        reqs = jnp.stack([adv.req] + [s.req for s in slots[:-1]])
        cstate = step_frame(cstate, reqs, ts_j["models"], None)
    assert len(seen_rho) == ecj.T
    for t, (got, want) in enumerate(zip(seen_rho, want_rho)):
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"frame {t}")
    for k, v in cstate.items():
        np.testing.assert_array_equal(ts_t["cache"][k].numpy(),
                                      np.asarray(v), k)
    assert any(r.any() for r in seen_rho[1:])
    if kind == "arc":
        # the JAX package's own episode: the same final state and hits
        jts, jstats = jt2.run_episode(ts_j, cfg_j, key, 1.0, 0.1)
        for k, v in jts["cache"].items():
            np.testing.assert_array_equal(ts_t["cache"][k].numpy(),
                                          np.asarray(v), k)
        np.testing.assert_allclose(stats["hit_ratio"].item(),
                                   float(jstats["hit_ratio"]), rtol=1e-6)
