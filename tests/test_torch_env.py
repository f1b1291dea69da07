"""Environment parity: the port's env (CPU) against ``repro.core.env``.

Deterministic functions take JAX-drawn states through the bridge and must
agree to f32 rounding (2e-5 relative).  Random draws cannot share streams
(``jax.random`` and ``torch.Generator`` differ), so they are held
distributionally: each side's sample moments and frequencies against the
exact distribution, within stated bounds (>= 5 standard errors).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import env as jenv
from repro.core import quality as jq
from repro_torch.bridge import env_state_from_numpy, models_from_numpy
from repro_torch.core import env as tenv
from repro_torch.core import quality as tq

REL = dict(rtol=2e-5, atol=0)
CFG_J = jenv.EnvCfg(U=6, M=5)
CFG_T = tenv.EnvCfg(U=6, M=5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_envcfg_fields_match_jax():
    import dataclasses
    assert [f.name for f in dataclasses.fields(tenv.EnvCfg)] == \
        [f.name for f in dataclasses.fields(jenv.EnvCfg)]
    assert tenv.EnvCfg() == tenv.EnvCfg(**dataclasses.asdict(jenv.EnvCfg()))
    for p in ("p_user", "p_bs", "n0", "state_dim", "action_dim"):
        assert getattr(tenv.EnvCfg(), p) == getattr(jenv.EnvCfg(), p)


def _states(n=4, seed=0):
    """JAX-drawn (state, models) pairs with a random cache and the matching
    port objects."""
    out = []
    key = jax.random.PRNGKey(seed)
    models = jenv.make_models(jax.random.fold_in(key, 99), CFG_J)
    tmodels = models_from_numpy(_np(models), device="cpu")
    for i in range(n):
        k1, k2 = jax.random.split(jax.random.fold_in(key, i))
        st = jenv.env_reset(k1, CFG_J)
        rho = jax.random.bernoulli(k2, 0.5, (CFG_J.M,)).astype(jnp.float32)
        st = jenv.env_set_cache(st, rho)
        out.append((st, models, env_state_from_numpy(_np(st), _gen(i)),
                    tmodels))
    return out


def _alloc(seed):
    rng = np.random.default_rng(seed)
    b = rng.dirichlet(np.ones(CFG_J.U)).astype(np.float32)
    xi = rng.dirichlet(np.ones(CFG_J.U)).astype(np.float32)
    return b, xi


def test_radio_rates_match_jax():
    for st, _, ts, _ in _states():
        b, _ = _alloc(1)
        j = jenv.radio_rates(st.h, b, CFG_J)
        t = tenv.radio_rates(ts.h, torch.from_numpy(b), CFG_T)
        for a, c in zip(t, j):
            np.testing.assert_allclose(a.numpy(), np.asarray(c), **REL)


def test_slot_metrics_and_reward_match_jax():
    mask = np.array([1, 1, 0, 1, 0, 1], np.float32)
    for i, (st, models, ts, tm) in enumerate(_states()):
        b, xi = _alloc(i)
        jm = jenv.slot_metrics(st, CFG_J, models, b, xi)
        tm_ = tenv.slot_metrics(ts, CFG_T, tm, torch.from_numpy(b),
                                torch.from_numpy(xi))
        assert set(tm_) == set(jm)
        for k in jm:
            np.testing.assert_allclose(tm_[k].numpy(), np.asarray(jm[k]),
                                       err_msg=k, **REL)
        for m in (None, mask):
            jr = jenv.slot_reward(jm, CFG_J, m)
            tr = tenv.slot_reward(tm_, CFG_T,
                                  None if m is None else torch.from_numpy(m))
            np.testing.assert_allclose(tr.item(), float(jr), **REL)


def test_observe_matches_jax():
    mask = np.array([1, 0, 1, 1, 0, 1], np.float32)
    for st, models, ts, tm in _states():
        for m in (None, mask):
            j = jenv.observe(st, CFG_J, models, m)
            t = tenv.observe(ts, CFG_T, tm,
                             None if m is None else torch.from_numpy(m))
            assert t.shape == (CFG_T.state_dim,)
            np.testing.assert_allclose(t.numpy(), np.asarray(j), **REL)


def test_masked_mean_zipf_logits_and_user_masks_match_jax():
    x = np.random.default_rng(0).standard_normal(6).astype(np.float32)
    for m in (None, np.array([1, 0, 1, 0, 0, 0], np.float32),
              np.zeros(6, np.float32)):
        j = jenv.masked_mean(x, m)
        t = tenv.masked_mean(torch.from_numpy(x),
                             None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(t.item(), float(j), **REL)
    for g in range(3):
        np.testing.assert_allclose(
            tenv.zipf_logits(torch.tensor(g), CFG_T).numpy(),
            np.asarray(jenv.zipf_logits(g, CFG_J)), **REL)
    np.testing.assert_array_equal(
        tenv.make_user_masks(CFG_T, [6, 2, 0]).numpy(),
        np.asarray(jenv.make_user_masks(CFG_J, [6, 2, 0])))


def test_quality_curves_match_jax():
    steps = np.linspace(0, 400, 81).astype(np.float32)
    a = [np.float32(v) for v in (55.0, 120.0, 180.0, 20.0)]
    np.testing.assert_allclose(
        tq.tv_quality(torch.from_numpy(steps), *a).numpy(),
        np.asarray(jq.tv_quality(steps, *a)), **REL)
    np.testing.assert_allclose(tq.tv_quality(torch.from_numpy(steps)).numpy(),
                               np.asarray(jq.tv_quality(steps)), **REL)
    np.testing.assert_allclose(
        tq.gen_delay(torch.from_numpy(steps), 0.2, 3.0).numpy(),
        np.asarray(jq.gen_delay(steps, 0.2, 3.0)), **REL)
    assert tq.cloud_quality() == jq.cloud_quality()
    assert tq.cloud_delay() == pytest.approx(jq.cloud_delay())


# -- random draws, held distributionally -------------------------------------

N = 20_000


def _within(sample_mean, mean, std, n, k=5.0):
    return abs(sample_mean - mean) <= k * std / np.sqrt(n)


def test_make_models_ranges_and_means():
    cfg_t, cfg_j = tenv.EnvCfg(M=N), jenv.EnvCfg(M=N)
    t = tenv.make_models(_gen(0), cfg_t)
    j = jenv.make_models(jax.random.PRNGKey(0), cfg_j)
    ranges = {"a1": (50, 100), "a2": (100, 150), "a3": (150, 200),
              "a4": (1, 50), "b1": (0.05, 0.5), "b2": (1, 10), "c": (2, 10),
              "d_op": (5 * jenv.MB_BITS, 10 * jenv.MB_BITS)}
    for f, (lo, hi) in ranges.items():
        for v in (getattr(t, f).numpy(), np.asarray(getattr(j, f))):
            assert v.min() >= lo * (1 - 1e-6) and v.max() <= hi * (1 + 1e-6)
            assert _within(v.mean(), (lo + hi) / 2, (hi - lo) / np.sqrt(12),
                           N), f


@pytest.mark.parametrize("lam", [0, 1, 2])
def test_positions_follow_the_location_state(lam):
    cfg_t, cfg_j = tenv.EnvCfg(U=N), jenv.EnvCfg(U=N)
    t = tenv._sample_positions(_gen(lam), torch.tensor(lam), cfg_t).numpy()
    j = np.asarray(jenv._sample_positions(jax.random.PRNGKey(lam), lam,
                                          cfg_j))
    A = cfg_t.area

    def edge_dist(pos):
        return np.minimum.reduce([pos[:, 0], A - pos[:, 0],
                                  pos[:, 1], A - pos[:, 1]])

    for pos in (t, j):
        assert pos.shape == (N, 2) and pos.min() >= 0 and pos.max() <= A
        if lam == 0:        # uniform on the square
            assert _within(pos.mean(), A / 2, A / np.sqrt(12), 2 * N)
        elif lam == 1:      # N(A/2, 30^2) per coordinate (clipping is rare)
            assert _within(pos.mean(), A / 2, 30.0, 2 * N)
            assert abs(pos.std() - 30.0) < 1.0
        else:               # within 15 m of a side
            assert edge_dist(pos).max() <= 15.0 + 1e-4
    # the two samples agree: distance to the nearest side, two-sample test
    dt, dj = edge_dist(t), edge_dist(j)
    assert abs(dt.mean() - dj.mean()) <= 5 * np.sqrt(
        (dt.var() + dj.var()) / N)


def test_channel_gain_is_path_loss_times_exp1():
    cfg_t, cfg_j = tenv.EnvCfg(U=N), jenv.EnvCfg(U=N)
    pos = np.random.default_rng(0).uniform(0, 250, (N, 2)).astype(np.float32)
    pl = tenv.path_gain(torch.from_numpy(pos), cfg_t).numpy()
    ht = tenv._channel_gain(_gen(1), torch.from_numpy(pos), cfg_t).numpy()
    hj = np.asarray(jenv._channel_gain(jax.random.PRNGKey(1), pos, cfg_j))
    # the deterministic factor matches the JAX arithmetic: ratios of the
    # two samples to it are both Exp(1) (mean 1, std 1)
    for h in (ht, hj):
        ratio = h / pl
        assert ratio.min() >= 0 and _within(ratio.mean(), 1.0, 1.0, N)
        assert abs(np.mean(ratio > 1.0) - np.exp(-1.0)) < 5 * 0.5 / np.sqrt(N)


@pytest.mark.parametrize("gamma_idx", [0, 2])
def test_requests_follow_zipf(gamma_idx):
    cfg_t, cfg_j = tenv.EnvCfg(U=N), jenv.EnvCfg(U=N)
    logits = np.asarray(jenv.zipf_logits(gamma_idx, cfg_j), np.float64)
    p = np.exp(logits) / np.exp(logits).sum()
    t = tenv._sample_requests(_gen(gamma_idx), torch.tensor(gamma_idx),
                              cfg_t).numpy()
    j = np.asarray(jenv._sample_requests(jax.random.PRNGKey(gamma_idx),
                                         gamma_idx, cfg_j))
    for req in (t, j):
        freq = np.bincount(req, minlength=cfg_t.M) / N
        assert np.all(np.abs(freq - p) <= 5 * np.sqrt(p * (1 - p) / N))


@pytest.mark.parametrize("which", ["P_gamma", "P_lambda"])
def test_markov_transitions_follow_the_matrix(which):
    cfg = tenv.EnvCfg()
    P = np.asarray(getattr(cfg, which))
    J = P.shape[0]
    idx = np.repeat(np.arange(J), N // J)
    log_P = tenv._consts(cfg, torch.device("cpu"))["log_" + which]
    t = tenv._sample_markov(_gen(5), torch.from_numpy(idx), log_P).numpy()
    j = np.asarray(jenv._sample_markov(jax.random.PRNGKey(5),
                                       jnp.asarray(idx), P))
    n = N // J
    for nxt in (t, j):
        for i in range(J):
            freq = np.bincount(nxt[idx == i], minlength=J) / n
            assert np.all(np.abs(freq - P[i])
                          <= 5 * np.sqrt(P[i] * (1 - P[i]) / n))


def test_reset_and_step_shapes_and_chain_states():
    cfg = tenv.EnvCfg(U=5, M=4)
    st = tenv.env_reset(_gen(0), cfg)
    assert st.pos.shape == (5, 2) and st.req.dtype == torch.int64
    gammas, lams = set(), set()
    for t in range(30):
        st = tenv.env_new_frame(st, cfg, torch.ones(cfg.M))
        st, r, m = tenv.env_step_slot(st, cfg,
                                      tenv.make_models(_gen(1), cfg),
                                      torch.full((5,), 0.2),
                                      torch.full((5,), 0.2))
        gammas.add(int(st.gamma_idx))
        lams.add(int(st.lambda_idx))
        assert torch.isfinite(r) and torch.all(st.req < cfg.M)
        assert torch.all(m["cached"] == 1.0)
    assert gammas == {0, 1, 2} and lams == {0, 1, 2}
