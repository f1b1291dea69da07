"""The vector-env training modes of the port (CPU): B cells' environment,
the fused independent learners against the port's own loop over the
single-cell episode (the ``"vmap"`` reference, as ``tests/test_fused.py``
holds the reference's fused core against its vmap), cell 0 against the
single-cell run, the shared learner, populations, evaluation of batched
states, the bridge and the legacy shims.

Tolerances: environment draws and discrete decisions (caching actions,
requests, minibatch draws: the generators' states) exactly; float state
and stats to 2e-5 relative and absolute, the round-off between the fused
core's batched products (``torch.bmm``) and the single core's (``@``),
carried through one short episode's rewards and updates.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import t2drl as jt2
from repro.core import env as jenv
from repro_torch.agents import (d3pg_init_batch, d3pg_update_batch,
                                ddqn_init_batch, ddqn_update_batch)
from repro_torch.bridge import train_state_from_numpy
from repro_torch.core import env as tenv
from repro_torch.core import population as tpop
from repro_torch.core import t2drl as tt2
from repro_torch.core.buffers import buffer_init_batch

TOL = dict(rtol=2e-5, atol=2e-5)
TINY = dict(U=3, M=4, T=2, K=3)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tests run many small ops, which several
    threads only slow down when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    kw = {"env": TINY, "lr_actor": 1e-4, "lr_critic": 1e-3,
          "lr_ddqn": 1e-3, **kw}
    return tt2.T2DRLCfg(env=tenv.EnvCfg(**kw.pop("env")), L=2, warmup=3,
                        **kw)


def _gens(B, base=0):
    return [torch.Generator().manual_seed(base + b) for b in range(B)]


def _states(gens):
    return [g.get_state() for g in gens]


def _params(mod):
    return [p.detach().clone() for p in mod.parameters()]


# -- B cells' environment -----------------------------------------------------

def test_batched_env_is_each_cells_env():
    """Reset, frame and slot steps of 3 masked cells at once: cell b's
    draws and state are what the single-cell functions give on its
    generator, and its reward and observation too."""
    cfg = tenv.EnvCfg(**TINY)
    B = 3
    masks = tenv.make_user_masks(cfg, [3, 1, 2])
    env = tenv.env_reset_batch(_gens(B), cfg)
    ones = [tenv.env_reset(g, cfg) for g in _gens(B)]
    models = tenv.make_models_batch(_gens(B, 10), cfg)
    rng = torch.Generator().manual_seed(5)
    for _ in range(3):
        env = tenv.env_advance_frame(env, cfg)
        ones = [tenv.env_advance_frame(e, cfg) for e in ones]
        rho = (torch.rand(B, cfg.M, generator=rng) > 0.5).float()
        env = tenv.env_set_cache(env, rho)
        ones = [tenv.env_set_cache(e, rho[b]) for b, e in enumerate(ones)]
        b_ = torch.softmax(torch.randn(B, cfg.U, generator=rng), -1)
        xi = torch.softmax(torch.randn(B, cfg.U, generator=rng), -1)
        s = tenv.observe(env, cfg, models, masks)
        env, r, m = tenv.env_step_slot(env, cfg, models, b_, xi, masks)
        for b in range(B):
            mb = tenv.ModelParams(*(t[b] for t in models))
            s1 = tenv.observe(ones[b], cfg, mb, masks[b])
            ones[b], r1, m1 = tenv.env_step_slot(ones[b], cfg, mb, b_[b],
                                                 xi[b], masks[b])
            torch.testing.assert_close(s[b], s1, **TOL)
            torch.testing.assert_close(r[b], r1, **TOL)
            torch.testing.assert_close(m["G"][b], m1["G"], **TOL)
            for f in ("gamma_idx", "lambda_idx", "req"):
                assert torch.equal(getattr(env, f)[b], getattr(ones[b], f))
            for f in ("pos", "h", "d_in"):
                torch.testing.assert_close(getattr(env, f)[b],
                                           getattr(ones[b], f), **TOL)
    assert all(torch.equal(a, b) for a, b in zip(
        _states(env.generator), _states([e.generator for e in ones])))


# -- fused independent learners -----------------------------------------------

def _run(cfg, B, impl, user_counts=None, episodes=1):
    cfg = dataclasses.replace(cfg, independent_impl=impl)
    gens = tt2.cell_generators(cfg.seed, B, "cpu")
    ts = tt2.t2drl_init_batch(gens, cfg)
    init = {k: {n: _params(m) for n, m in ts[k].items()
                if isinstance(m, torch.nn.Module)} for k in ("d3pg", "ddqn")}
    masks = (None if user_counts is None
             else tenv.make_user_masks(cfg.env, user_counts))
    ts, hist = tt2.run_training(ts, cfg, gens, episodes, masks)
    return ts, hist, gens, init


# each optimiser state of a learner and the networks it steps
OPT_NETS = {"d3pg": (("opt_a", ("actor", "actor_t")),
                     ("opt_c", ("critic", "critic_t"))),
            "ddqn": (("opt", ("q", "q_target")),)}


def _learners_close(new: dict, ref: dict, kind: str):
    """Two states of ``kind``'s stacked learners: Adam's first moments (the
    gradients' running mean) to 2e-5 of each leaf's max, and the networks
    to 2e-5 where |mu| > 1e-3 max|mu| of the leaf.  A weight whose
    gradient sits at rounding noise is left out: Adam steps it by
    lr * g / (|g| + eps), so there the two may step apart by up to lr (a
    saturated actor's learner has such gradients, ~1e-9, throughout)."""
    for opt, nets in OPT_NETS[kind]:
        assert new[opt]["step"] == ref[opt]["step"]
        mus = ref[opt]["mu"]
        for i, (a, b) in enumerate(zip(new[opt]["mu"], mus)):
            assert (a - b).abs().max().item() <= 2e-5 * b.abs().max(), i
        for net in nets:
            for p, q, g in zip(new[net].parameters(), ref[net].parameters(),
                               mus):
                keep = g.abs() > 1e-3 * g.abs().max()
                torch.testing.assert_close(p[keep], q[keep], rtol=0,
                                           atol=2e-5)


@pytest.mark.parametrize("allocator,cacher,env", [
    ("d3pg", "ddqn", TINY), ("ddpg", "random", TINY),
    ("rcars", "ddqn", dict(U=3, M=4, T=35, K=1))])
def test_fused_matches_the_vmap_loop_after_one_episode(allocator, cacher,
                                                       env):
    """B = 3 masked cells, one episode: the fused core and the loop of the
    single-cell core over the cells draw the same (each generator ends in
    the same state, so every minibatch index was the same), make the same
    caching actions and requests, and agree on the stats, buffers and
    learners to round-off.  The d3pg case updates from its fourth slot;
    the T = 35 case runs the stacked DDQN update (its buffer then holds
    more than a batch).  At the tuned learning rates (1e-4, 1e-3), as
    ``_learners_close`` compares them; every learner with a gradient above
    rounding moved at least five times the parameters' tolerance, so a
    missing or wrong stacked update fails."""
    cfg = _cfg(allocator=allocator, cacher=cacher, env=env)
    tf, hf, gf, init = _run(cfg, 3, "fused", [3, 2, 1])
    tv, hv, gv, _ = _run(cfg, 3, "vmap", [3, 2, 1])
    for a, b in zip(_states(gf), _states(gv)):
        assert torch.equal(a, b)
    for k in ("a", "s", "s1"):
        assert torch.equal(tf["fbuf"]["data"][k], tv["fbuf"]["data"][k])
    assert torch.equal(tf["ebuf"]["data"]["req"], tv["ebuf"]["data"]["req"])
    assert tf["ebuf"]["size"] == tv["ebuf"]["size"]
    np.testing.assert_allclose(np.asarray(hf["mean_reward"]),
                               np.asarray(hv["mean_reward"]), **TOL)
    for k in hf:
        np.testing.assert_allclose(hf[k], hv[k], **TOL, err_msg=k)
    torch.testing.assert_close(tf["ebuf"]["data"]["a"],
                               tv["ebuf"]["data"]["a"], **TOL)
    for k in ("d3pg", "ddqn"):
        _learners_close(tf[k], tv[k], k)
    for k, net, opt in (("d3pg", "actor", "opt_a"), ("d3pg", "critic", "opt_c"),
                        ("ddqn", "q", "opt")):
        mus = tv[k][opt]["mu"]
        for b in range(3):
            if any(bool((g[b].abs() > 1e-3 * g.abs().max()).any())
                   for g in mus):
                moved = max((p[b] - p0[b]).abs().max().item() for p, p0 in
                            zip(tv[k][net].parameters(), init[k][net]))
                assert moved > 5 * TOL["atol"], (k, net, b, moved)
    if allocator == "d3pg":
        assert tf["d3pg"]["opt_a"]["step"] > 0
    if env["T"] > 2:
        assert tf["ddqn"]["opt"]["step"] > 0


def test_fused_core_of_one_cell_is_the_single_cell_core():
    cfg = _cfg()
    g1, g2 = _gens(1, 7), _gens(1, 7)
    ts1 = tt2.t2drl_init_batch(g1, cfg)
    ts2 = tt2.t2drl_init(g2[0], cfg)
    step = tt2._training_steps(cfg, 1)[0]
    ts1, st1 = tt2._episode_core_fused(ts1, cfg, g1, step)
    ts2, st2 = tt2._episode_core(ts2, cfg, g2[0], step)
    assert torch.equal(g1[0].get_state(), g2[0].get_state())
    for k in st2:
        torch.testing.assert_close(st1[k][0], st2[k], **TOL)
    for p, q in zip(ts1["d3pg"]["actor"].parameters(),
                    ts2["d3pg"]["actor"].parameters()):
        torch.testing.assert_close(p[0], q, **TOL)


def test_cell_zero_replays_the_single_cell_run():
    """``train_t2drl(num_envs=2)``'s cell 0 is ``num_envs=1``'s cell: the
    same initial state (the same generator seed) and, for one episode,
    the same stats and learned parameters."""
    cfg = _cfg()
    ts1, h1 = tt2.train_t2drl(cfg, episodes=1, device="cpu")
    ts2, h2 = tt2.train_t2drl(cfg, episodes=1, num_envs=2, device="cpu")
    for k in h1:
        np.testing.assert_allclose(h2[k][0][0], h1[k][0], **TOL, err_msg=k)
    for net in ("actor", "critic"):
        for p, q in zip(ts2["d3pg"][net].parameters(),
                        ts1["d3pg"][net].parameters()):
            torch.testing.assert_close(p[0], q, **TOL)
    for f in ts1["models"]._fields:
        assert torch.equal(getattr(ts2["models"], f)[0],
                           getattr(ts1["models"], f))
    assert ts2["ebuf"]["size"] == [ts1["ebuf"]["size"]] * 2


def test_shared_learner_pools_every_cells_replay():
    """One learner for 3 masked cells: per-cell buffers fill in lockstep,
    the learner takes one update a slot past warmup (not one per cell),
    and the stats are per cell."""
    cfg = _cfg(policy="shared")
    ts, hist = tt2.train_t2drl(cfg, episodes=2, num_envs=3,
                               user_counts=[3, 2, 1], device="cpu")
    assert np.asarray(hist["hit_ratio"]).shape == (2, 3)
    assert ts["ebuf"]["size"] == [2 * cfg.env.T * cfg.env.K] * 3
    assert ts["d3pg"]["actor"].net.w[0].dim() == 2        # one learner
    # slots past warmup, counted over all cells' stored transitions
    T, K = cfg.env.T, cfg.env.K
    gates = sum(1 for e in range(2) for t in range(T) for k in range(K)
                if 3 * (e * T * K + t * K + k + 1) > cfg.warmup
                and e * T * K + t * K > 0)
    assert ts["d3pg"]["opt_a"]["step"] == gates


# -- populations --------------------------------------------------------------

FUSED = _cfg()


def test_validate_pop_refusals_and_fill():
    with pytest.raises(ValueError, match="unknown population keys"):
        tt2._validate_pop({"momentum": [0.0, 0.0]}, FUSED, 2, 3)
    with pytest.raises(ValueError, match="independent_impl='fused'"):
        tt2._validate_pop({"eps": [0.0, 0.0]},
                          dataclasses.replace(FUSED, independent_impl="vmap"),
                          2, 3)
    with pytest.raises(ValueError, match="policy='independent'"):
        tt2._validate_pop({"eps": [0.0, 0.0]},
                          dataclasses.replace(FUSED, policy="shared"), 2, 3)
    with pytest.raises(ValueError, match="must be"):
        tt2._validate_pop({"eps": np.zeros((4, 2))}, FUSED, 2, 3)
    pop = tt2._validate_pop({"lr_actor": [1e-4, 2e-4]}, FUSED, 2, 3)
    assert np.asarray(pop["lr_actor"]).shape == (3, 2)
    np.testing.assert_allclose(pop["lr_critic"],
                               np.full((3, 2), FUSED.lr_critic))


def test_population_member_with_zero_lr_stays_at_init():
    """lr = 0 for member 0 leaves its actor and critic at their init while
    member 1 trains: the per-member rate reaches every stacked update."""
    cfg = dataclasses.replace(FUSED, warmup=2)
    gens = tt2.cell_generators(0, 2, "cpu")
    ts = tt2.t2drl_init_batch(gens, cfg)
    init = {k: _params(ts["d3pg"][k]) for k in ("actor", "critic")}
    pop = {"lr_actor": [0.0, 1e-4], "lr_critic": [0.0, 1e-4],
           "lr_ddqn": [0.0, 1e-3], "eps": [0.0, 0.5],
           "shape_hit": [0.0, 0.5]}
    ts, _ = tt2.run_training(ts, cfg, gens, 2, pop=pop)
    assert ts["d3pg"]["opt_a"]["step"] > 0
    for k in ("actor", "critic"):
        now = _params(ts["d3pg"][k])
        assert all(torch.equal(a[0], b[0]) for a, b in zip(now, init[k]))
        assert any(not torch.equal(a[1], b[1]) for a, b in zip(now,
                                                                 init[k]))


def test_train_population_trains_and_ranks():
    members = [tpop.PopMember(lr_actor=1e-4, name="a"),
               tpop.PopMember(eps_end=0.5, shape_hit=0.5, name="b"),
               tpop.PopMember(updates_per_slot=2, name="c")]
    res, groups = tpop.train_population(_cfg(), members, episodes=2,
                                        eval_episodes=1, device="cpu")
    assert [r["label"] for r in res] == ["a", "b", "c"]
    assert [g["updates_per_slot"] for g in groups] == [1, 2]
    assert all(len(r["history"]["utility"]) == 2 for r in res)
    ranked = tpop.rank_population(res)
    assert [r["eval"]["utility"] for r in ranked] == sorted(
        (r["eval"]["utility"] for r in res), reverse=True)
    sched = tpop.population_schedules(_cfg(), members[:1], 3)
    plain = tt2._training_steps(_cfg(), 3)
    np.testing.assert_allclose(sched["eps"][:, 0].numpy(),
                               [s["eps"] for s in plain])
    assert len(tpop.default_grid()) == 16


# -- evaluation, export, bridge, shims ----------------------------------------

def test_batched_eval_and_export_leave_the_state_alone():
    cfg = _cfg()
    ts, _ = tt2.train_t2drl(cfg, episodes=1, num_envs=2, device="cpu")
    before = _params(ts["d3pg"]["actor"])
    sizes = list(ts["ebuf"]["size"])
    ev = tt2.run_eval_batch(ts, cfg, episodes=2, device="cpu",
                            masks=tenv.make_user_masks(cfg.env, [2, 3]))
    assert np.asarray(ev["utility"]).shape == (2, 2)
    assert ts["ebuf"]["size"] == sizes
    assert all(torch.equal(a, b) for a, b in zip(
        _params(ts["d3pg"]["actor"]), before))
    pol = tt2.export_policy(ts, cfg, cell=1)
    assert torch.equal(pol["actor"].net.w[0], ts["d3pg"]["actor"].net.w[0][1])
    zoo = tenv.ModelParams(*(t[1] for t in ts["models"]))
    out = tt2.eval_t2drl(pol, zoo, cfg, episodes=1, device="cpu",
                         user_counts=[2])
    assert set(out) == set(tt2.STAT_KEYS)
    with pytest.raises(ValueError):
        tt2.eval_t2drl(pol, zoo, cfg, episodes=1, device="cpu",
                       user_counts=[1, 2])


@pytest.mark.parametrize("policy", ["independent", "shared"])
def test_bridged_batched_train_state_has_the_port_layout(policy):
    cj = jt2.T2DRLCfg(env=jenv.EnvCfg(**TINY), L=2, policy=policy)
    ct = _cfg(policy=policy)
    ts = jax.tree.map(np.asarray, jt2.t2drl_init_batch(
        jax.random.PRNGKey(0), cj, 3))
    got = tt2.t2drl_init_batch(_gens(3), ct)
    bridged = train_state_from_numpy(ts, ct, device="cpu")

    def shapes(x):
        if isinstance(x, torch.nn.Module):
            return [tuple(p.shape) for p in x.parameters()]
        if isinstance(x, dict):
            return {k: shapes(v) for k, v in x.items()}
        if isinstance(x, list):
            return [shapes(v) for v in x]
        return (tuple(x.shape), x.dtype) if torch.is_tensor(x) else x

    for k in ("d3pg", "ddqn", "ebuf", "fbuf"):
        assert shapes(bridged[k]) == shapes(got[k]), k
    np.testing.assert_array_equal(bridged["models"].c.numpy(),
                                  ts["models"].c)


def test_legacy_batch_shims_step_every_learner():
    cfg = _cfg()
    d3, dq = cfg.d3pg_cfg(), cfg.ddqn_cfg()
    B, n = 2, 4
    params = d3pg_init_batch(_gens(B), d3)
    g = torch.Generator().manual_seed(3)
    E = cfg.env
    batch = {"s": torch.randn(B, n, E.state_dim, generator=g),
             "a": torch.rand(B, n, E.action_dim, generator=g),
             "r": torch.randn(B, n, generator=g),
             "s1": torch.randn(B, n, E.state_dim, generator=g),
             "req": torch.randint(0, E.M, (B, n, E.U), generator=g),
             "rho": torch.ones(B, n, E.M), "req1": torch.zeros(
                 B, n, E.U, dtype=torch.int64), "rho1": torch.ones(B, n, E.M)}
    from repro_torch.core.d3pg import make_actor_schedule
    params, m = d3pg_update_batch(params, d3, make_actor_schedule(d3), batch,
                                  _gens(B, 5), lr_a=[1e-4, 0.0])
    assert m["critic_loss"].shape == (B,) and params["opt_a"]["step"] == 1
    q = ddqn_init_batch(_gens(B), dq)
    q, loss = ddqn_update_batch(q, dq, {
        "s": torch.zeros(B, n, dtype=torch.int64),
        "a": torch.zeros(B, n, dtype=torch.int64), "r": torch.ones(B, n),
        "s1": torch.ones(B, n, dtype=torch.int64)})
    assert loss.shape == (B,) and q["opt"]["step"] == 1
    buf = buffer_init_batch(B, 5, {"x": torch.zeros(2)})
    assert buf["data"]["x"].shape == (B, 5, 2) and buf["ptr"] == [0, 0]


@pytest.mark.parametrize("allocator", ["d3pg", "ddpg"])
def test_vmap_agent_fused_closures_match_the_loop(allocator):
    """``vmap_agent(agent, "fused")``'s act and update against ``"vmap"``'s
    loop of the single-learner closures on views of the stack: the same
    draws (generator states), actions and new learners (as
    ``_learners_close`` compares them), with per-cell masks and
    per-learner sigma and learning rates (the tuned 1e-4 and 1e-3)."""
    from repro_torch.agents import make_allocator, make_cacher, vmap_agent
    from repro_torch.agents.base import FrameObs, SlotObs
    from repro_torch.core.buffers import (buffer_add_many_stacked,
                                          buffer_sample_stacked)
    cfg = _cfg(allocator=allocator)
    B = 3
    alloc = make_allocator(allocator, cfg.env, cfg.d3pg_cfg())
    cacher = make_cacher("ddqn", cfg.ddqn_cfg(), cfg.env)
    masks = tenv.make_user_masks(cfg.env, [3, 2, 1])
    out = {}
    for impl in ("fused", "vmap"):
        a, c = vmap_agent(alloc, impl), vmap_agent(cacher, impl)
        state, cstate = a.init(_gens(B)), c.init(_gens(B, 3))
        gens = _gens(B, 10)
        env = tenv.env_reset_batch(_gens(B, 20), cfg.env)
        models = tenv.make_models_batch(_gens(B, 30), cfg.env)
        step = {"eps": [0.0, 0.5, 1.0], "sigma": [0.1, 0.0, 0.3]}
        a_int, rho = c.act(cstate, FrameObs(env.gamma_idx, models), gens,
                           step)
        s = tenv.observe(env, cfg.env, models, masks)
        b_, xi = a.act(state, SlotObs(s, env, models, masks), gens, step)
        ts = tt2.t2drl_init_batch(_gens(B, 40), cfg)
        items = {"s": s[:, None].expand(B, 4, -1),
                 "a": torch.cat([b_, xi], -1)[:, None].expand(B, 4, -1),
                 "r": torch.ones(B, 4), "s1": s[:, None].expand(B, 4, -1),
                 "req": env.req[:, None].expand(B, 4, -1),
                 "rho": env.rho[:, None].expand(B, 4, -1),
                 "req1": env.req[:, None].expand(B, 4, -1),
                 "rho1": env.rho[:, None].expand(B, 4, -1)}
        buffer_add_many_stacked(ts["ebuf"], items)
        batch = buffer_sample_stacked(ts["ebuf"], gens, 8)
        state, m = a.update(state, {**batch, "mask": masks,
                                    "lr_actor": torch.tensor([1e-4, 0.0,
                                                              2e-4]),
                                    "lr_critic": 1e-3}, gens)
        out[impl] = (a_int, rho, b_, xi, m, state, _states(gens))
    f, v = out["fused"], out["vmap"]
    assert torch.equal(f[0], v[0]) and torch.equal(f[1], v[1])
    for x, y in zip(f[2:4], v[2:4]):
        torch.testing.assert_close(x, y, **TOL)
    for k in f[4]:
        torch.testing.assert_close(f[4][k], v[4][k], **TOL)
    _learners_close(f[5], v[5], "d3pg")
    assert f[5]["opt_a"]["step"] == v[5]["opt_a"]["step"] == 1
    assert all(torch.equal(x, y) for x, y in zip(f[6], v[6]))


def test_vmap_agent_refuses_an_agent_without_fused_closures():
    """``"fused"`` never falls back to the loop: an agent that learns
    without ``update_stacked``, or has no ``act_stacked``, is refused; a
    non-learned agent keeps its ``no_update``."""
    from repro_torch.agents import make_allocator, no_update, vmap_agent
    cfg = _cfg()
    alloc = make_allocator("d3pg", cfg.env, cfg.d3pg_cfg())
    for cut in ({"update_stacked": None}, {"act_stacked": None}):
        with pytest.raises(ValueError, match="no fused closures"):
            vmap_agent(alloc._replace(**cut), "fused")
    assert vmap_agent(alloc._replace(update_stacked=None), "vmap").update
    rcars = make_allocator("rcars", cfg.env, cfg.d3pg_cfg())
    assert vmap_agent(rcars, "fused").update is no_update
