"""Scenario schedules and the modulated env of the port against the JAX
package (CPU).

* Every built-in scenario builds the reference's ``ScenarioBuild``: the
  same transformed ``EnvCfg``, user counts and schedule, leaf by leaf
  exactly (the schedules are built in numpy by the same arithmetic), for
  one cell and for B = 4.
* The modulated env with its draws injected: the flash-crowd redirect
  against the reference's ``_apply_burst`` on the same uniforms; a
  modulated refresh or frame advance against the unmodulated one from
  the same seed, scaled and then redirected by the next (U,) uniforms,
  exactly; a ``P_gamma`` override against the same matrix configured.
* ``paper-default`` builds no schedule, and training under it is the
  unmodulated run bit for bit; every built-in trains and evaluates.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import scenarios as jsc
from repro.core import env as jenv
from repro_torch import scenarios as tsc
from repro_torch.core import env as tenv
from repro_torch.core import t2drl as tt2

BUILTINS = ("paper-default", "diurnal", "flash-crowd", "hetero-cells",
            "degraded-channel", "rush-hour")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tests run many small ops, which several
    threads only slow down when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_registry_lists_the_reference_scenarios():
    assert tsc.list_scenarios() == jsc.list_scenarios()
    assert set(BUILTINS) <= set(tsc.list_scenarios())
    assert [f.name for f in dataclasses.fields(tsc.ModSpec)] == \
        [f.name for f in dataclasses.fields(jsc.ModSpec)]
    with pytest.raises(KeyError, match="unknown scenario"):
        tsc.get_scenario("nope")
    with pytest.raises(ValueError, match="already registered"):
        tsc.register(tsc.Scenario(name="diurnal", summary=""))


@pytest.mark.parametrize("num_envs", [1, 4])
@pytest.mark.parametrize("name", BUILTINS)
def test_builtin_schedules_equal_the_reference(name, num_envs):
    base_j, base_t = jenv.EnvCfg(T=6, K=5), tenv.EnvCfg(T=6, K=5)
    j = jsc.build_scenario(name, base_j, num_envs)
    t = tsc.build_scenario(name, base_t, num_envs, device="cpu")
    assert dataclasses.asdict(t.env) == dataclasses.asdict(j.env)
    assert t.user_counts == j.user_counts
    assert (t.mods is None) == (j.mods is None)
    if j.mods is None:
        assert name in ("paper-default", "hetero-cells")
        return
    for f in jenv.ScenarioSchedule._fields:
        jv, tv = np.asarray(getattr(j.mods, f)), getattr(t.mods, f).numpy()
        assert tv.shape == jv.shape, f
        np.testing.assert_array_equal(tv, jv, err_msg=f)
    for g in (0, 7, 29, 500):
        jm = jenv.schedule_slot_mod(j.mods, g)
        tm = tenv.schedule_slot_mod(t.mods, g)
        for f in jenv.SlotMod._fields:
            np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                          np.asarray(getattr(jm, f)))
    np.testing.assert_array_equal(tenv.schedule_frame_P(t.mods, 3).numpy(),
                                  np.asarray(jenv.schedule_frame_P(j.mods, 3)))


def test_compose_stacks_like_the_reference():
    j = jsc.build_scenario(jsc.compose("x", "flash-crowd", "diurnal"),
                           jenv.EnvCfg(), 2)
    t = tsc.build_scenario(tsc.compose("x", "flash-crowd", "diurnal"),
                           tenv.EnvCfg(), 2, device="cpu")
    for f in jenv.ScenarioSchedule._fields:
        np.testing.assert_array_equal(getattr(t.mods, f).numpy(),
                                      np.asarray(getattr(j.mods, f)))


# -- the modulated env, draws injected -------------------------------------------

EC = dict(U=6, M=5)


def _mod(h=0.5, din=1.5, bp=0.6, bm=3, lead=()):
    f = lambda v: torch.full(lead, v, dtype=torch.float32)  # noqa: E731
    return tenv.SlotMod(f(h), f(din), f(bp),
                        torch.full(lead, bm, dtype=torch.int64))


def test_burst_redirect_matches_the_reference_on_the_same_draws():
    key = jax.random.PRNGKey(5)
    req = jax.random.randint(jax.random.PRNGKey(1), (EC["U"],), 0, EC["M"])
    jmod = jenv.SlotMod(jnp.float32(1.0), jnp.float32(1.0),
                        jnp.float32(0.6), jnp.int32(3))
    want = jenv._apply_burst(key, req, jmod)
    u = torch.from_numpy(np.array(jax.random.uniform(key, req.shape)))
    got = tenv.burst_redirect(torch.from_numpy(np.array(req)).long(), u,
                              _mod(1.0, 1.0, 0.6, 3))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("lead", [(), (3,)])
def test_modulated_draws_are_the_unmodulated_ones_then_the_redirect(lead):
    """A modulated reset, frame advance and slot step from a seed equal
    the unmodulated ones from the same seed with the gains and input sizes
    scaled and the requests redirected by the next (U,) uniforms of each
    cell's generator: the extra draw is the last of a refresh."""
    ec = tenv.EnvCfg(**EC)
    B = lead[0] if lead else 0
    mod = _mod(lead=lead)

    def gens(seed):
        return (tuple(_gen(seed + b) for b in range(B)) if B
                else _gen(seed))

    def next_u(g):
        if B:
            return torch.stack([torch.rand(ec.U, generator=x) for x in g])
        return torch.rand(ec.U, generator=g)

    def scaled(st, u):
        col = (lambda x: x[:, None]) if B else (lambda x: x)
        return (st.h * col(mod.h_scale), st.d_in * col(mod.din_scale),
                tenv.burst_redirect(st.req, u, mod))

    g_mod, g_ref = gens(0), gens(0)
    st = tenv.env_reset(g_mod, ec, mod)
    ref = tenv.env_reset(g_ref, ec)
    h, d_in, req = scaled(ref, next_u(g_ref))
    for a, b in ((st.h, h), (st.d_in, d_in), (st.req, req),
                 (st.pos, ref.pos), (st.lambda_idx, ref.lambda_idx)):
        assert torch.equal(a, b)
    ref = ref._replace(h=h, d_in=d_in, req=req)
    st = tenv.env_advance_frame(st, ec, None, mod)
    ref = tenv.env_advance_frame(ref, ec)
    req = tenv.burst_redirect(ref.req, next_u(g_ref), mod)
    assert torch.equal(st.gamma_idx, ref.gamma_idx) and torch.equal(st.req,
                                                                     req)
    ref = ref._replace(req=req)
    models = (tenv.make_models_batch([_gen(9)] * B, ec) if B
              else tenv.make_models(_gen(9), ec))
    b = torch.full(lead + (ec.U,), 1.0 / ec.U)
    st1, r, _ = tenv.env_step_slot(st, ec, models, b, b, None, mod)
    ref1, r_ref, _ = tenv.env_step_slot(ref, ec, models, b, b)
    assert torch.equal(r, r_ref)
    h, d_in, req = scaled(ref1, next_u(g_ref))
    assert torch.equal(st1.h, h) and torch.equal(st1.d_in, d_in) \
        and torch.equal(st1.req, req)


def test_frame_transition_override_equals_the_configured_matrix():
    P = ((0.1, 0.1, 0.8), (0.7, 0.2, 0.1), (0.3, 0.3, 0.4))
    ec, ec_P = tenv.EnvCfg(**EC), tenv.EnvCfg(**EC, P_gamma=P)
    a = tenv.env_reset(_gen(1), ec)
    b = tenv.env_reset(_gen(1), ec_P)
    for _ in range(20):
        a = tenv.env_advance_frame(a, ec, torch.tensor(P))
        b = tenv.env_advance_frame(b, ec_P)
        assert torch.equal(a.gamma_idx, b.gamma_idx) and torch.equal(a.req,
                                                                     b.req)
    # per-cell matrices: cell b's chain follows its own
    gens = tuple(_gen(s) for s in (1, 2))
    Ps = torch.stack([torch.tensor(P), torch.tensor(ec.P_gamma)])
    st = tenv.env_reset_batch(gens, ec)
    one = [tenv.env_reset(_gen(1), ec_P), tenv.env_reset(_gen(2), ec)]
    for _ in range(10):
        st = tenv.env_advance_frame(st, ec, Ps)
        one = [tenv.env_advance_frame(one[0], ec_P),
               tenv.env_advance_frame(one[1], ec)]
        assert [int(x) for x in st.gamma_idx] == [int(o.gamma_idx)
                                                  for o in one]


# -- training under scenarios ---------------------------------------------------------

SMALL = dict(U=3, M=4, T=3, K=3)


def test_paper_default_is_the_unmodulated_run_bit_for_bit():
    b = tsc.build_scenario("paper-default", tenv.EnvCfg(**SMALL),
                           device="cpu")
    assert b.mods is None and b.user_counts is None
    cfg = tt2.T2DRLCfg(env=b.env, L=2, warmup=4, cacher="lfu")
    ts1, h1 = tt2.train_t2drl(cfg, episodes=2, device="cpu", mods=b.mods)
    ts2, h2 = tt2.train_t2drl(cfg, episodes=2, device="cpu")
    assert h1 == h2
    for k in ts1["cache"]:
        assert torch.equal(ts1["cache"][k], ts2["cache"][k])
    for p, q in zip(ts1["d3pg"]["actor"].parameters(),
                    ts2["d3pg"]["actor"].parameters()):
        assert torch.equal(p, q)


@pytest.mark.parametrize("name", BUILTINS[1:])
def test_every_builtin_trains_and_evaluates(name):
    B = 4 if name in ("hetero-cells", "degraded-channel") else 1
    b = tsc.build_scenario(name, tenv.EnvCfg(**SMALL), B, device="cpu")
    cfg = tt2.T2DRLCfg(env=b.env, L=2, warmup=4, allocator="d3pg",
                       cacher="arc" if B == 1 else "ddqn")
    ts, hist = tt2.train_t2drl(cfg, episodes=1, num_envs=B, device="cpu",
                               mods=b.mods, user_counts=b.user_counts)
    assert all(np.isfinite(np.asarray(v)).all() for v in hist.values())
    if B == 1:
        pol = tt2.export_policy(ts, cfg)
        out = tt2.eval_t2drl(pol, ts["models"], cfg, episodes=1,
                             device="cpu", mods=b.mods)
    else:
        masks = (None if b.user_counts is None
                 else tenv.make_user_masks(b.env, b.user_counts))
        out = tt2.run_eval_batch(ts, cfg, episodes=1, mods=b.mods,
                                 device="cpu", masks=masks)
        out = {k: float(np.mean(v)) for k, v in out.items()}
    assert all(np.isfinite(v) for v in out.values())
    assert 0.0 <= out["hit_ratio"] <= 1.0
