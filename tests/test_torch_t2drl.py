"""The serving slice as a whole: the port's greedy T2DRL loop against the
JAX package's, at EnvCfg(U=4, M=4, T=3, K=3), on one bridged policy and
model zoo.

* Deterministic replay: a JAX greedy loop built from public functions (as
  examples/serve_edge.py wires them) records every frame's gamma and every
  slot's EnvState and chain draws; the port replays them.  rho must be
  equal; (b, xi) and the slot reward agree to 2e-5 relative.
* Distribution: the port's ``run_eval`` against the JAX ``run_eval`` over
  24 greedy episodes each (independent streams); mean reward and hit
  ratio agree within 4 pooled standard errors.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import env as jenv
from repro.core import t2drl as jt2
from repro_torch.bridge import (env_state_from_numpy, models_from_numpy,
                                policy_from_numpy)
from repro_torch.core import env as tenv
from repro_torch.core import t2drl as tt2

SMALL = dict(U=4, M=4, T=3, K=3)
REL = dict(rtol=2e-5, atol=1e-7)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(allocator, cacher, seed=0):
    cfg_j = jt2.T2DRLCfg(env=jenv.EnvCfg(**SMALL), allocator=allocator,
                         cacher=cacher)
    cfg_t = tt2.T2DRLCfg(env=tenv.EnvCfg(**SMALL), allocator=allocator,
                         cacher=cacher)
    ts = jt2.t2drl_init(jax.random.PRNGKey(seed), cfg_j)
    pol = jt2.export_policy(ts, cfg_j)
    return (cfg_j, cfg_t, ts, pol, policy_from_numpy(_np(pol), device="cpu"),
            models_from_numpy(_np(ts["models"]), device="cpu"))


def test_t2drl_cfg_fields_match_jax():
    names = [f.name for f in dataclasses.fields(tt2.T2DRLCfg)]
    assert names == [f.name for f in dataclasses.fields(jt2.T2DRLCfg)]
    cfg_t, cfg_j = tt2.T2DRLCfg(allocator="ddpg"), jt2.T2DRLCfg(
        allocator="ddpg")
    assert dataclasses.asdict(cfg_t.d3pg_cfg()) == \
        dataclasses.asdict(cfg_j.d3pg_cfg())
    assert dataclasses.asdict(cfg_t.ddqn_cfg()) == \
        dataclasses.asdict(cfg_j.ddqn_cfg())


@pytest.mark.parametrize("allocator,cacher", [("d3pg", "ddqn"),
                                              ("ddpg", "static")])
def test_greedy_loop_replays_exactly(allocator, cacher):
    cfg_j, cfg_t, ts, pol, tpol, tmodels = _pair(allocator, cacher)
    ec = cfg_j.env
    models = ts["models"]
    frame_cache = jax.jit(lambda g, k: jt2.greedy_frame_cache(
        pol, cfg_j, models, g, k))
    slot_action = jax.jit(lambda e, k: jt2.greedy_slot_action(
        pol, cfg_j, e, models, k))
    step = jax.jit(lambda e, b, xi: jenv.env_step_slot(e, ec, models, b, xi))
    key = jax.random.PRNGKey(1)
    env = jenv.env_reset(key, ec)
    n_slots = 0
    for t in range(ec.T):
        env = jenv.env_advance_frame(env, ec)
        kf = jax.random.fold_in(key, 100 + t)
        rho = frame_cache(env.gamma_idx, kf)
        trho = tt2.greedy_frame_cache(tpol, cfg_t, tmodels,
                                      torch.tensor(int(env.gamma_idx)))
        np.testing.assert_array_equal(trho.numpy(), np.asarray(rho))
        env = jenv.env_set_cache(env, rho)
        for k in range(ec.K):
            ks = jax.random.fold_in(kf, k)
            b, xi = slot_action(env, ks)
            # the actor's chain draws, as repro.diffusion.sampler makes them
            kx, ke = jax.random.split(ks)
            A = ec.action_dim
            x_L = torch.tensor(np.asarray(jax.random.normal(kx, (A,))))
            noises = torch.tensor(np.asarray(
                jax.random.normal(ke, (cfg_j.L, A))))
            tstate = env_state_from_numpy(_np(env), torch.Generator())
            tb, txi = tt2.greedy_slot_action(tpol, cfg_t, tstate, tmodels,
                                             x_L=x_L, noises=noises)
            np.testing.assert_allclose(tb.numpy(), np.asarray(b), **REL)
            np.testing.assert_allclose(txi.numpy(), np.asarray(xi), **REL)
            env1, r, _ = step(env, b, xi)
            _, tr, _ = tenv.env_step_slot(tstate, cfg_t.env, tmodels, tb, txi)
            np.testing.assert_allclose(tr.item(), float(r), **REL)
            env = env1
            n_slots += 1
    assert n_slots == ec.T * ec.K


def test_eval_matches_jax_in_distribution():
    E = 24
    cfg_j, cfg_t, ts, _, tpol, tmodels = _pair("d3pg", "ddqn", seed=3)
    jstats = jt2.run_eval(jax.tree.map(lambda x: x[None], ts), cfg_j,
                          jax.random.PRNGKey(11), jnp.arange(E))
    tstats = tt2.run_eval(tpol, tmodels, cfg_t, episodes=E, seed=11,
                          device="cpu")
    assert set(tstats) == set(jstats) == set(tt2.STAT_KEYS)
    for k in ("mean_reward", "hit_ratio"):
        j = np.asarray(jstats[k]).reshape(-1)
        t = np.asarray(tstats[k])
        assert len(j) == len(t) == E
        se = np.sqrt(j.var(ddof=1) / E + t.var(ddof=1) / E)
        assert abs(j.mean() - t.mean()) <= 4 * se + 1e-6, (k, j.mean(),
                                                            t.mean(), se)
    for k in tt2.STAT_KEYS:
        assert np.all(np.isfinite(tstats[k]))


@pytest.mark.parametrize("allocator,cacher", [("d3pg", "ddqn"),
                                              ("ddpg", "ddqn"),
                                              ("rcars", "random"),
                                              ("d3pg", "static"),
                                              ("schrs", "static")])
def test_eval_t2drl_runs_every_served_method(allocator, cacher):
    cfg = tt2.T2DRLCfg(env=tenv.EnvCfg(U=3, M=3, T=2, K=2),
                       allocator=allocator, cacher=cacher,
                       ga=tt2.GACfg(pop=8, gens=3))
    pol = tt2.policy_init(cfg, seed=0, device="cpu")
    models = tenv.make_models(torch.Generator().manual_seed(1), cfg.env)
    out = tt2.eval_t2drl(pol, models, cfg, episodes=2, device="cpu")
    assert set(out) == set(tt2.STAT_KEYS)
    assert all(np.isfinite(v) for v in out.values())
    assert 0.0 <= out["hit_ratio"] <= 1.0
    assert out["episode_reward"] == pytest.approx(
        out["mean_reward"] * cfg.env.T * cfg.env.K, rel=1e-5)


@pytest.mark.parametrize("allocator,cacher", [("d3pg", "arc"),
                                              ("rcars", "lru")])
def test_classical_cacher_methods_train_and_serve(allocator, cacher):
    """The pairs that raised until the classical cachers were ported train
    (the cache state advanced on every valid access), export the resident
    set, and serve it greedily; an unknown allocator still raises."""
    cfg = tt2.T2DRLCfg(env=tenv.EnvCfg(U=3, M=3, T=2, K=2),
                       allocator=allocator, cacher=cacher, warmup=2, L=2)
    ts, hist = tt2.train_t2drl(cfg, episodes=2, device="cpu")
    assert ts["cache"]["time"].item() == 2 * 2 * 2 * 3
    pol = tt2.export_policy(ts, cfg)
    assert torch.equal(pol["cache"]["rho"],
                       (ts["cache"]["in_t1"] | ts["cache"]["in_t2"]).float())
    out = tt2.eval_t2drl(pol, ts["models"], cfg, episodes=1, device="cpu")
    assert all(np.isfinite(v) for v in out.values())
    assert set(tt2.policy_init(cfg, seed=0, device="cpu")) >= {"cache"}
    with pytest.raises(ValueError):
        tt2.policy_init(tt2.T2DRLCfg(allocator="nope"), 0, device="cpu")
