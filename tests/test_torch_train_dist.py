"""Training one cell, held against the JAX package in distribution.

The config is ``benchmarks/bench_cache.py``'s smoke cell
(``EnvCfg(U=6, M=8, T=6, K=6, C=12)``), 25 episodes, ``warmup=50``, the
tuned learning rates of ``benchmarks/common.py`` (``TUNED``) and
``eps_decay_episodes = 0.6 * 25``.  The reference trains 4 independent
learners on one model zoo in one compile
(``train_t2drl(num_envs=4, share_models=True)``, made once and shared by
both tests); the port trains 3 seeds on cell 0's zoo, bridged, one cell
at a time and, as the vector-env modes, 4 fused learners at once.  The two
frameworks draw different random streams, so the runs are compared as
distributions:

    for mean_reward and hit_ratio, the port's mean over its 3 seeds of
    each seed's mean over its last 5 episodes lies within the reference's
    min-max over its 4 cells (each cell's mean over its last 5 episodes),
    widened by half that range on each side.

This file is the slowest of the port's tests: on one CPU core the JAX
compile of the 4-learner program takes ~55 s, the port's ~2500 D3PG
updates one cell at a time ~75 s, and its ~850 fused 4-learner updates
more.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import env as jenv
from repro.core import t2drl as jt2
from repro_torch.bridge import models_from_numpy
from repro_torch.core import env as tenv
from repro_torch.core import t2drl as tt2

EPISODES, LAST = 25, 5
TUNED = dict(lr_actor=1e-4, lr_critic=1e-3, lr_ddqn=1e-3)
SMOKE = dict(U=6, M=8, T=6, K=6, C=12.0)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tests run many small ops, which several
    threads only slow down when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(mod, allocator, cacher):
    return mod.T2DRLCfg(env=(jenv if mod is jt2 else tenv).EnvCfg(**SMOKE),
                        allocator=allocator, cacher=cacher,
                        episodes=EPISODES, warmup=50,
                        eps_decay_episodes=int(EPISODES * 0.6), **TUNED)


_JAX_RUNS = {}


def _jax_run(allocator, cacher):
    """The reference's 4-learner run of a method, made once per worker and
    shared by the single-cell and the vector-env test."""
    if (allocator, cacher) not in _JAX_RUNS:
        _JAX_RUNS[allocator, cacher] = jt2.train_t2drl(
            _cfg(jt2, allocator, cacher), episodes=EPISODES, num_envs=4,
            share_models=True)
    return _JAX_RUNS[allocator, cacher]


def _in_band(k, got, jhist):
    ref = np.asarray(jhist[k])[-LAST:].mean(axis=0)            # (4,) cells
    lo, hi = ref.min(), ref.max()
    band = (lo - 0.5 * (hi - lo), hi + 0.5 * (hi - lo))
    assert band[0] <= got <= band[1], (k, got, band, ref)


@pytest.mark.parametrize("allocator,cacher", [("d3pg", "ddqn"),
                                              ("rcars", "static")])
def test_training_matches_jax_in_distribution(allocator, cacher):
    cfg_t = _cfg(tt2, allocator, cacher)
    jts, jhist = _jax_run(allocator, cacher)
    zoo = models_from_numpy(jax.tree.map(lambda x: np.asarray(x)[0],
                                         jts["models"]), device="cpu")
    port = {k: [] for k in ("mean_reward", "hit_ratio")}
    for seed in range(3):
        g = torch.Generator().manual_seed(seed)
        ts = {**tt2.t2drl_init(g, cfg_t), "models": zoo}
        hist = {k: [] for k in port}
        for step in tt2._training_steps(cfg_t, EPISODES):
            ts, stats = tt2._episode_core(ts, cfg_t, g, step)
            for k in hist:
                hist[k].append(stats[k].item())
        for k in port:
            port[k].append(np.mean(hist[k][-LAST:]))
    for k in port:
        _in_band(k, float(np.mean(port[k])), jhist)


def test_vector_training_matches_jax_in_distribution():
    """The port's fused independent learners, 4 cells on the reference's
    zoo (as ``share_models=True`` gives it) from ``cell_generators``,
    against the same reference run: the port's mean over its 4 cells of
    each cell's mean over its last 5 episodes lies within the band above,
    for mean_reward and hit_ratio."""
    cfg_t = _cfg(tt2, "d3pg", "ddqn")
    jts, jhist = _jax_run("d3pg", "ddqn")
    zoo = models_from_numpy(jax.tree.map(lambda x: np.asarray(x)[0],
                                         jts["models"]), device="cpu")
    gens = tt2.cell_generators(1, 4, "cpu")
    ts = {**tt2.t2drl_init_batch(gens, cfg_t),
          "models": tenv.stack_models([zoo] * 4)}
    ts, hist = tt2.run_training(ts, cfg_t, gens, EPISODES)
    assert np.asarray(hist["mean_reward"]).shape == (EPISODES, 4)
    for k in ("mean_reward", "hit_ratio"):
        got = np.asarray(hist[k])[-LAST:].mean(axis=0)            # (4,)
        _in_band(k, float(got.mean()), jhist)
