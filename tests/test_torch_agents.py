"""Cacher and allocator parity: the port's DDQN acting, amenders and
baselines (CPU) against ``repro.core`` on the same parameters and inputs.
Discrete outputs must be equal; continuous ones agree to 2e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbase
from repro.core import d3pg as jd3
from repro.core import ddqn as jdq
from repro.core import env as jenv
from repro_torch.bridge import (env_state_from_numpy, mlp_from_numpy,
                                models_from_numpy, policy_from_numpy)
from repro_torch.core import baselines as tbase
from repro_torch.core import d3pg as td3
from repro_torch.core import ddqn as tdq
from repro_torch.core import env as tenv

TOL = dict(rtol=2e-5, atol=2e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("M", [4, 10])
def test_ddqn_greedy_act_matches_jax(M):
    dq_j, dq_t = jdq.DDQNCfg(M=M), tdq.DDQNCfg(M=M)
    params = jdq.ddqn_init(jax.random.PRNGKey(M), dq_j)
    tparams = {"q": mlp_from_numpy(_np(params["q"]), device="cpu")}
    for g in range(3):
        j = jdq.ddqn_act(params, dq_j, jnp.int32(g), jax.random.PRNGKey(0),
                         0.0)
        t = tdq.ddqn_act(tparams, dq_t, torch.tensor(g))
        assert int(t) == int(j)
    jb = jdq.ddqn_act(params, dq_j, jnp.arange(3), jax.random.PRNGKey(0), 0.0)
    tb = tdq.ddqn_act(tparams, dq_t, torch.arange(3))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_ddqn_epsilon_one_explores_uniformly():
    dq = tdq.DDQNCfg(M=4)
    params = tdq.qnet_init(dq, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    a = tdq.ddqn_act(params, dq, torch.zeros(8000, dtype=torch.int64), g, 1.0)
    freq = np.bincount(a.numpy(), minlength=16) / 8000
    assert np.all(np.abs(freq - 1 / 16) < 5 * np.sqrt(1 / 16 * 15 / 16 / 8000))


@pytest.mark.parametrize("feasible", [False, True])
def test_amend_caching_matches_jax(feasible):
    M = 6
    dq_j = jdq.DDQNCfg(M=M, feasible_amender=feasible)
    dq_t = tdq.DDQNCfg(M=M, feasible_amender=feasible)
    c = np.random.default_rng(0).uniform(2, 10, M).astype(np.float32)
    amend = jax.jit(lambda a: jdq.amend_caching(a, dq_j, c, 12.0))
    for a in range(2 ** M):
        j = amend(jnp.int32(a))
        t = tdq.amend_caching(torch.tensor(a), dq_t, torch.from_numpy(c),
                              12.0)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        if feasible:
            assert float((t * torch.from_numpy(c)).sum()) <= 12.0
    # batch-safe over leading axes (plain amender)
    a = np.arange(0, 64, 5)
    np.testing.assert_array_equal(
        tdq.amend_caching(torch.from_numpy(a), tdq.DDQNCfg(M=M)).numpy(),
        np.asarray(jdq.amend_caching(jnp.asarray(a), jdq.DDQNCfg(M=M))))


@pytest.mark.parametrize("masked", [False, True])
def test_amend_actions_matches_jax(masked):
    U, M = 5, 4
    rng = np.random.default_rng(1)
    raw = rng.uniform(0, 1, (2 * U,)).astype(np.float32)
    req = rng.integers(0, M, U)
    rho = np.array([1, 0, 1, 0], np.float32)
    mask = np.array([1, 1, 0, 1, 1], np.float32) if masked else None
    jb, jx = jd3.amend_actions(raw, jnp.asarray(req, jnp.int32), rho, U,
                               mask=mask)
    tb, tx = td3.amend_actions(torch.from_numpy(raw), torch.from_numpy(req),
                               torch.from_numpy(rho), U,
                               mask=None if mask is None
                               else torch.from_numpy(mask))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), **TOL)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    # batched raw/req/rho: the take_along_axis branch
    rawb = rng.uniform(0, 1, (3, 2 * U)).astype(np.float32)
    reqb = rng.integers(0, M, (3, U))
    rhob = rng.integers(0, 2, (3, M)).astype(np.float32)
    jb, jx = jd3.amend_actions(rawb, jnp.asarray(reqb, jnp.int32), rhob, U)
    tb, tx = td3.amend_actions(torch.from_numpy(rawb), torch.from_numpy(reqb),
                               torch.from_numpy(rhob), U)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), **TOL)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)


def test_mlp_actor_act_matches_jax():
    d3j = jd3.D3PGCfg(state_dim=14, action_dim=6, actor_kind="mlp")
    d3t = td3.D3PGCfg(state_dim=14, action_dim=6, actor_kind="mlp")
    params = jd3.d3pg_init(jax.random.PRNGKey(3), d3j)
    actor = policy_from_numpy(_np({"actor": params["actor"]}),
                              device="cpu")["actor"]
    s = np.random.default_rng(2).standard_normal((3, 14)).astype(np.float32)
    j = jd3.actor_act(params["actor"], d3j, jd3.make_actor_schedule(d3j), s,
                      jax.random.PRNGKey(0))
    t = td3.actor_act(actor, d3t, td3.make_actor_schedule(d3t),
                      torch.from_numpy(s))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_d3pg_cfg_fields_match_jax():
    assert [f.name for f in dataclasses.fields(td3.D3PGCfg)] == \
        [f.name for f in dataclasses.fields(jd3.D3PGCfg)]
    assert [f.name for f in dataclasses.fields(tdq.DDQNCfg)] == \
        [f.name for f in dataclasses.fields(jdq.DDQNCfg)]


def _zoo(M, seed):
    cfg_j = jenv.EnvCfg(U=6, M=M)
    models = jenv.make_models(jax.random.PRNGKey(seed), cfg_j)
    return cfg_j, tenv.EnvCfg(U=6, M=M), models, \
        models_from_numpy(_np(models), device="cpu")


@pytest.mark.parametrize("seed", range(5))
def test_static_popular_cache_matches_jax(seed):
    cfg_j, cfg_t, models, tm = _zoo(10, seed)
    np.testing.assert_array_equal(
        tbase.static_popular_cache(tm, cfg_t).numpy(),
        np.asarray(jbase.static_popular_cache(models, cfg_j)))


def test_random_cache_respects_capacity_and_varies():
    cfg_j, cfg_t, models, tm = _zoo(10, 0)
    g = torch.Generator().manual_seed(0)
    seen = set()
    for _ in range(50):
        rho = tbase.random_cache(g, tm, cfg_t)
        used = float((rho * tm.c).sum())
        assert used <= cfg_t.C + 1e-5
        # greedy fill: no uncached model would still fit
        free = cfg_t.C - used
        assert all(float(tm.c[m]) > free for m in range(10) if rho[m] == 0)
        seen.add(tuple(rho.tolist()))
    assert len(seen) > 3


def test_rcars_allocate_matches_jax():
    cfg_j, cfg_t, models, tm = _zoo(4, 1)
    st = jenv.env_set_cache(jenv.env_reset(jax.random.PRNGKey(2), cfg_j),
                            jnp.array([1.0, 0.0, 1.0, 0.0]))
    ts = env_state_from_numpy(_np(st), torch.Generator())
    for j, t in zip(jbase.rcars_allocate(st, cfg_j),
                    tbase.rcars_allocate(ts, cfg_t)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
