"""Telemetry of the port (``repro_torch.obs``, the updates' ``diag=True``)
against the JAX package's, on the CPU.

* One ``d3pg_update(diag=True)`` and one ``ddqn_update(diag=True)``,
  single and stacked (B = 2), from the same bridged state, minibatch and
  chain draws as the reference's: every diagnostic to 2e-5 of its leaf's
  largest magnitude (``denoise_mag`` comes from the target chain's
  record in the port, from the XLA step loop in the reference).  The
  actors' output layer is scaled by 0.05, as in ``test_torch_stacked.py``,
  and the minibatch caches nothing (``rho = rho1 = 0``): the untrained
  chain still drives x_0 past tanh's saturation (its coefficients
  multiply x by ~12 over the chain), and where every gated compute share
  is 0 in XLA and a rounding residue in torch the reference's amender is
  0/0 (ROADMAP C); with nothing cached both give compute shares of
  exactly 0 and the bandwidth shares stay well conditioned.  The DDQN
  update runs at the tuned rate 1e-3: ``target_div`` is the norm of the
  step the update took, which at the paper's 1e-6 is the difference of
  f32 weights a few ulps apart.
* ``reduce_update_diag``, ``combine_updates`` and ``broadcast_diag``
  against the reference's on the same arrays (1e-6 relative: sums in
  another order).
* A port JSONL run log (``train_t2drl(writer=)``, ``eval_t2drl(writer=)``)
  passes the JAX package's ``validate_jsonl``, and the port's own
  validator and CLI refuse a log without a manifest.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import d3pg as jd3
from repro.core import ddqn as jdq
from repro.core import env as jenv
from repro.core import t2drl as jt2
from repro.obs import taps as jtaps
from repro.obs import writer as jwriter
from repro_torch import obs as tobs
from repro_torch.bridge import train_state_from_numpy
from repro_torch.core import d3pg as td3
from repro_torch.core import ddqn as tdq
from repro_torch.core import env as tenv
from repro_torch.core import t2drl as tt2
from repro_torch.obs import validate as tvalidate

SMALL = dict(U=3, M=4)
REL = 2e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaf_close(t, j, rel, what):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    assert t.shape == j.shape, (what, t.shape, j.shape)
    assert np.abs(t - j).max() <= rel * max(np.abs(j).max(), 1e-30), \
        (what, t, j)


def _unsaturated(d3):
    d3 = dict(d3)
    for k in ("actor", "actor_t"):
        layers = [dict(l) for l in d3[k]["layers"]]
        layers[-1] = {n: 0.05 * v for n, v in layers[-1].items()}
        d3[k] = {"layers": layers}
    return d3


def _slot_batch(rng, lead, e):
    U, M, S = e.U, e.M, e.state_dim
    f = lambda *s: rng.standard_normal(lead + s).astype(np.float32)  # noqa
    raw = rng.uniform(0, 1, lead + (2 * U,)).astype(np.float32)
    return {"s": f(S), "a": raw / raw.sum(-1, keepdims=True), "r": f(),
            "s1": f(S),
            "req": rng.integers(0, M, lead + (U,)).astype(np.int32),
            "rho": rng.integers(0, 2, lead + (M,)).astype(np.float32),
            "req1": rng.integers(0, M, lead + (U,)).astype(np.int32),
            "rho1": rng.integers(0, 2, lead + (M,)).astype(np.float32)}


def _torch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                else v) for k, v in batch.items()}


def _draws(key, shape, L):
    kx, ke = jax.random.split(key)
    return (np.asarray(jax.random.normal(kx, shape)),
            np.asarray(jax.random.normal(ke, (L,) + shape)))


@pytest.mark.parametrize("B", [None, 2])
def test_d3pg_update_diagnostics_match_jax(B):
    cfg_j = jt2.T2DRLCfg(env=jenv.EnvCfg(**SMALL), L=3)
    cfg_t = tt2.T2DRLCfg(env=tenv.EnvCfg(**SMALL), L=3)
    d3j, d3t = cfg_j.d3pg_cfg(), cfg_t.d3pg_cfg()
    key = jax.random.PRNGKey(3)
    ts = _np(jt2.t2drl_init(key, cfg_j) if B is None
             else jt2.t2drl_init_batch(key, cfg_j, B))
    ts["d3pg"] = _unsaturated(ts["d3pg"])
    tts = train_state_from_numpy(ts, cfg_t, device="cpu")
    n, A = 8, cfg_j.env.action_dim
    lead = () if B is None else (B,)
    batch = _slot_batch(np.random.default_rng(4), lead + (n,), cfg_j.env)
    batch["rho"][:] = 0.0
    batch["rho1"][:] = 0.0
    sched_j, sched_t = jd3.make_actor_schedule(d3j), \
        td3.make_actor_schedule(d3t)
    if B is None:
        k = jax.random.PRNGKey(5)
        _, jm = jax.jit(lambda p, b, kk: jd3.d3pg_update(
            p, d3j, sched_j, b, kk, diag=True))(ts["d3pg"], batch, k)
        k_t, k_pi = jax.random.split(k)
        draws = {w: tuple(torch.from_numpy(x.copy())
                          for x in _draws(kk, (n, A), d3j.L))
                 for w, kk in (("target", k_t), ("policy", k_pi))}
        _, tm = td3.d3pg_update(tts["d3pg"], d3t, sched_t, _torch(batch),
                                draws=draws, diag=True)
    else:
        keys = jax.random.split(jax.random.PRNGKey(5), B)
        _, jm = jax.jit(lambda p, b, kk: jd3.d3pg_update_stacked(
            p, d3j, sched_j, b, kk, diag=True))(ts["d3pg"], batch, keys)
        kk = jax.vmap(jax.random.split)(keys)
        draws = {}
        for w, col in (("target", 0), ("policy", 1)):
            xs, ns = zip(*(_draws(kk[b, col], (n, A), d3j.L)
                           for b in range(B)))
            draws[w] = (torch.from_numpy(np.stack(xs)),
                        torch.from_numpy(np.stack(ns)))
        _, tm = td3.d3pg_update_stacked(tts["d3pg"], d3t, sched_t,
                                        _torch(batch), draws=draws,
                                        diag=True)
    assert set(tm) == set(jm) == set(jd3.d3pg_diag_zero(d3j))
    for k in jm:
        _leaf_close(tm[k].numpy(), jm[k], REL, k)
    assert tm["denoise_mag"].shape == lead + (d3j.L,)


@pytest.mark.parametrize("B", [None, 2])
def test_ddqn_update_diagnostics_match_jax(B):
    dqj, dqt = jdq.DDQNCfg(M=4, lr=1e-3), tdq.DDQNCfg(M=4, lr=1e-3)
    cfg_j = jt2.T2DRLCfg(env=jenv.EnvCfg(**SMALL))
    cfg_t = tt2.T2DRLCfg(env=tenv.EnvCfg(**SMALL))
    key = jax.random.PRNGKey(6)
    ts = _np(jt2.t2drl_init(key, cfg_j) if B is None
             else jt2.t2drl_init_batch(key, cfg_j, B))
    tts = train_state_from_numpy(ts, cfg_t, device="cpu")
    rng = np.random.default_rng(7)
    lead, n = (() if B is None else (B,)), 32
    batch = {"s": rng.integers(0, dqj.J, lead + (n,)).astype(np.int32),
             "a": rng.integers(0, dqj.n_actions, lead + (n,)).astype(
                 np.int32),
             "r": rng.standard_normal(lead + (n,)).astype(np.float32) * 10,
             "s1": rng.integers(0, dqj.J, lead + (n,)).astype(np.int32)}
    fj = jdq.ddqn_update if B is None else jdq.ddqn_update_stacked
    ft = tdq.ddqn_update if B is None else tdq.ddqn_update_stacked
    _, jm = jax.jit(lambda p, b: fj(p, dqj, b, diag=True))(ts["ddqn"],
                                                            batch)
    _, tm = ft(tts["ddqn"], dqt, _torch(batch), diag=True)
    assert set(tm) == set(jm) == set(jdq.ddqn_diag_zero(dqj))
    for k in jm:
        _leaf_close(tm[k].numpy(), jm[k], REL, k)


@pytest.mark.parametrize("shape,did", [
    ((4, 3), "some"), ((4, 3, 2), "some"), ((4, 3, 2), "none"),
    ((5,), "all")])
def test_reduce_update_diag_matches_the_reference(shape, did):
    rng = np.random.default_rng(len(shape))
    ms = {"loss": rng.standard_normal(shape).astype(np.float32),
          "td_abs_max": rng.standard_normal(shape).astype(np.float32),
          "denoise_mag": rng.random(shape + (3,)).astype(np.float32)}
    d = {"some": rng.integers(0, 2, shape[:2] if len(shape) > 1
                              else shape),
         "none": np.zeros(shape[:2]), "all": np.ones(shape)}[did]
    d = d.astype(np.float32)
    if len(shape) == 3:
        d = d[..., None].repeat(shape[2], -1) if did != "none" \
            else np.zeros(shape)
    j = jtaps.reduce_update_diag(jax.tree.map(jnp.asarray, ms),
                                 jnp.asarray(d), prefix="diag/x_")
    t = tobs.reduce_update_diag({k: torch.from_numpy(v)
                                 for k, v in ms.items()},
                                torch.from_numpy(d), prefix="diag/x_")
    assert set(t) == set(j)
    for k in j:
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    c = {k: v[:3] for k, v in ms.items()}
    jc = jtaps.combine_updates(jax.tree.map(jnp.asarray, c))
    tc = tobs.combine_updates([{k: torch.from_numpy(np.asarray(v[i]))
                                for k, v in c.items()} for i in range(3)])
    for k in jc:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=1e-6, err_msg=k)
    z = tobs.broadcast_diag({k: torch.zeros(np.shape(v)[len(shape):])
                             for k, v in ms.items()}, 4)
    jz = jtaps.broadcast_diag({k: jnp.zeros(np.shape(v)[len(shape):])
                               for k, v in ms.items()}, 4)
    assert {k: tuple(v.shape) for k, v in z.items()} == \
        {k: tuple(v.shape) for k, v in jz.items()}


def test_obs_cfg_and_schema_are_the_reference():
    import dataclasses
    assert [f.name for f in dataclasses.fields(tobs.ObsCfg)] == \
        [f.name for f in dataclasses.fields(jtaps.ObsCfg)]
    for kw in ({}, {"enabled": True}, {"enabled": True, "learner": False},
               {"enabled": True, "replay": False}):
        t, j = tobs.ObsCfg(**kw), jtaps.ObsCfg(**kw)
        assert (t.learner_on, t.replay_on) == (j.learner_on, j.replay_on)
    assert tobs.SCHEMA == jwriter.SCHEMA
    assert tobs.REQUIRED_FIELDS == jwriter.REQUIRED_FIELDS
    last = {"episode_reward": -12.3456, "hit_ratio": 0.25, "utility": 7.5}
    assert tobs.progress_line(12, last) == jwriter.progress_line(12, last)


def test_port_run_log_validates_in_both_packages(tmp_path, capsys):
    path = str(tmp_path / "run.jsonl")
    cfg = tt2.T2DRLCfg(env=tenv.EnvCfg(U=2, M=3, T=2, K=2), L=2, warmup=2,
                       obs=tobs.ObsCfg(enabled=True))
    with tobs.MetricWriter(path) as w:
        ts, hist = tt2.train_t2drl(cfg, episodes=3, device="cpu", writer=w,
                                   log_every=2)
        tt2.eval_t2drl(tt2.export_policy(ts, cfg), ts["models"], cfg,
                       episodes=1, device="cpu", writer=w)
        with tobs.stage("probe", writer=w) as info:
            info["n"] = 1
    assert jwriter.validate_jsonl(path) == tobs.validate_jsonl(path) == 5
    recs = [json.loads(l) for l in open(path)]
    assert [r["kind"] for r in recs] == ["manifest", "train_chunk",
                                         "train_chunk", "eval", "profile"]
    man = recs[0]
    assert man["jax"] is None and man["torch"] == torch.__version__
    assert man["backend"] == "cpu" and man["cfg_hash"] == tobs.cfg_hash(cfg)
    chunk = recs[1]["stats"]
    assert recs[1]["episode"] == 2 and recs[2]["episode"] == 3
    assert len(chunk["diag/denoise_mag"]) == cfg.L
    assert chunk["diag/updates"] == np.mean(hist["diag/updates"][:2])
    assert "ep    2 reward" in capsys.readouterr().out
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps(recs[1]) + "\n")
    assert tvalidate.main([str(bad)]) == 1
    assert tvalidate.main([path]) == 0
    with pytest.raises(ValueError, match="manifest"):
        tobs.validate_jsonl(str(bad))
