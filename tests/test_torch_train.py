"""The training slice (CPU) against the JAX package: the gradient of the
sampler (the step loop and the fused chain), one ``d3pg_update`` (its
policy chain through either) and one ``ddqn_update`` from the same state,
batch and draws, and the training loop's episode semantics.

Tolerances, each with its reason:

* sampler gradients against ``jax.grad`` of the XLA sampler: 1e-4 of each
  leaf's largest magnitude (f32 through L = 5 steps of a 4-layer MLP and
  its backward, summed in other orders);
* updates: losses to 1e-4 relative; gradients, read from Adam's first
  moment after one step (mu = 0.1 g in both), to 1e-4 of each leaf's
  largest magnitude; the new parameters, targets and moments at the
  paper's lr 1e-6 to 2e-5.  At the tuned lr a first Adam step moves each
  weight by about lr * sign(g), and where |g| sits at rounding noise the
  two frameworks may step in opposite directions, so there the new
  parameters are compared only where |g| > 1e-3 max|g| of their leaf;
* episode semantics: the methods, the vector-env modes, scenario
  schedules and telemetry train end to end (the update gates and the
  frame reward's sign are held against the JAX package in
  ``test_torch_train_gates.py``; the telemetry's values in
  ``test_torch_obs.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import d3pg as jd3
from repro.core import ddqn as jdq
from repro.core import env as jenv
from repro.core import t2drl as jt2
from repro.diffusion import denoiser as jden
from repro.diffusion import make_schedule as jmake_schedule
from repro.diffusion import reverse_sample as jreverse_sample
from repro_torch.bridge import denoiser_from_numpy, train_state_from_numpy
from repro_torch.core import d3pg as td3
from repro_torch.core import ddqn as tdq
from repro_torch.core import env as tenv
from repro_torch.core import t2drl as tt2
from repro_torch.diffusion import make_schedule, reverse_sample


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tests run many small ops, which several
    threads only slow down when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close_to_leaf_max(t, j, rel, what=""):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    err, scale = np.abs(t - j).max(), np.abs(j).max()
    assert err <= rel * scale, (what, err, scale)


def _draws(key, n, A, L):
    """A chain's x_L and noises as repro.diffusion.sampler draws them."""
    kx, ke = jax.random.split(key)
    return (torch.tensor(np.asarray(jax.random.normal(kx, (n, A)))),
            torch.tensor(np.asarray(jax.random.normal(ke, (L, n, A)))))


# -- the sampler's gradient ------------------------------------------------------

@pytest.mark.parametrize("impl", ["step", "chain"])
def test_reverse_sample_step_gradient_matches_jax_grad(impl):
    """Both samplers' gradients against ``jax.grad`` of the XLA sampler:
    the step loop (autograd through the eager denoiser and ``DdpmStep``)
    and the fused chain (``DdpmChain``'s plain forward with its record and
    plain backward)."""
    S, A, L, R = 10, 6, 5, 8
    params = jden.denoiser_init(jax.random.PRNGKey(0), S, A, hidden=32)
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
        params)                                  # non-zero biases too
    state = rng.standard_normal((R, S)).astype(np.float32)
    w = rng.standard_normal((R, A)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    sched = jmake_schedule(L)

    def loss(p):
        return jnp.sum(w * jreverse_sample(p, sched, state, key, A))

    j_loss, j_grads = jax.value_and_grad(loss)(params)
    p = denoiser_from_numpy(_np(params), device="cpu")
    x_L, noises = _draws(key, R, A, L)
    x0 = reverse_sample(p, make_schedule(L), torch.from_numpy(state), A,
                        x_L=x_L, noises=noises, impl=impl)
    t_loss = torch.sum(torch.from_numpy(w) * x0)
    t_grads = torch.autograd.grad(t_loss, list(p.parameters()))
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=1e-4)
    want = denoiser_from_numpy(_np(j_grads), device="cpu").parameters()
    for i, (t, j) in enumerate(zip(t_grads, want)):
        _close_to_leaf_max(t.numpy(), j.detach().numpy(), 1e-4, i)


# -- one D3PG / DDQN update -------------------------------------------------------

SMALL = dict(U=3, M=4)


def _cfgs(allocator, **kw):
    return (jt2.T2DRLCfg(env=jenv.EnvCfg(**SMALL), allocator=allocator,
                         L=3, **kw),
            tt2.T2DRLCfg(env=tenv.EnvCfg(**SMALL), allocator=allocator,
                         L=3, **kw))


def _slot_batch(rng, n, cfg):
    e = cfg.env
    U, M, S = e.U, e.M, e.state_dim
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    raw = rng.uniform(0, 1, (n, 2 * U)).astype(np.float32)
    return {"s": f(n, S), "a": raw / raw.sum(-1, keepdims=True),
            "r": f(n), "s1": f(n, S),
            "req": rng.integers(0, M, (n, U)).astype(np.int32),
            "rho": rng.integers(0, 2, (n, M)).astype(np.float32),
            "req1": rng.integers(0, M, (n, U)).astype(np.int32),
            "rho1": rng.integers(0, 2, (n, M)).astype(np.float32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                else v) for k, v in batch.items()}


def _compare_learner(tnew, jnew, jold_mu_scale, paper_lr, nets, opts):
    """Gradients through Adam's first moment, then the new parameters."""
    for opt, net in zip(opts, nets):
        grads = [m.numpy() / jold_mu_scale for m in jnew[opt]["mu"]]
        for i, (t, j) in enumerate(zip(tnew[opt]["mu"], jnew[opt]["mu"])):
            _close_to_leaf_max(t.numpy(), j.numpy(), 1e-4, (opt, i))
        for name in (net, net + "_t") if net != "q" else (net, "q_target"):
            for i, (t, j, g) in enumerate(zip(tnew[name].parameters(),
                                              jnew[name].parameters(),
                                              grads)):
                t, j = t.detach().numpy(), j.detach().numpy()
                if not paper_lr:
                    keep = np.abs(g) > 1e-3 * np.abs(g).max()
                    t, j = t[keep], j[keep]
                np.testing.assert_allclose(t, j, rtol=0, atol=2e-5,
                                           err_msg=f"{name} {i}")


@pytest.mark.parametrize("allocator,mask,paper_lr,impl", [
    (alloc, mask, paper_lr, impl)
    for alloc, mask, paper_lr in (("d3pg", None, True), ("d3pg", None, False),
                                  ("d3pg", "rows", True))
    for impl in ("chain", "step")] + [
    ("ddpg", None, False, "chain"), ("ddpg", "shared", False, "chain"),
    ("ddpg", "rows", True, "chain")])
def test_d3pg_update_matches_jax(allocator, mask, paper_lr, impl):
    """The diffusion actor's update with its policy chain through either
    ``impl`` (the DDPG actor has no chain), against the reference's XLA
    update."""
    lrs = {} if paper_lr else dict(lr_actor=1e-4, lr_critic=1e-3)
    cfg_j, cfg_t = _cfgs(allocator, **lrs)
    d3j, d3t = cfg_j.d3pg_cfg(), cfg_t.d3pg_cfg()
    ts = _np(jt2.t2drl_init(jax.random.PRNGKey(3), cfg_j))
    tts = train_state_from_numpy(ts, cfg_t, device="cpu")
    rng = np.random.default_rng(4)
    n, U, A = 16, cfg_j.env.U, cfg_j.env.action_dim
    batch = _slot_batch(rng, n, cfg_j)
    m = {None: None, "shared": np.array([1, 0, 1], np.float32),
         "rows": rng.integers(0, 2, (n, U)).astype(np.float32)}[mask]
    key = jax.random.PRNGKey(5)
    # eager: the op-by-op caches carry over between the cases, where a jit
    # of each case would compile the whole update anew
    jnew, jm = jd3.d3pg_update(ts["d3pg"], d3j, jd3.make_actor_schedule(d3j),
                               jax.tree.map(jnp.asarray, batch), key,
                               mask=None if m is None else jnp.asarray(m))
    draws = None
    if allocator == "d3pg":
        k_t, k_pi = jax.random.split(key)
        draws = {"target": _draws(k_t, n, A, cfg_j.L),
                 "policy": _draws(k_pi, n, A, cfg_j.L)}
    tnew, tm = td3.d3pg_update(
        tts["d3pg"], d3t, td3.make_actor_schedule(d3t), _torch_batch(batch),
        mask=None if m is None else torch.from_numpy(m), draws=draws,
        impl=impl)
    for k in ("critic_loss", "actor_loss"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    jnew = train_state_from_numpy({**ts, "d3pg": _np(jnew)}, cfg_t,
                                  device="cpu")["d3pg"]
    assert tnew["opt_a"]["step"] == tnew["opt_c"]["step"] == 1
    _compare_learner(tnew, jnew, 0.1, paper_lr, ("critic", "actor"),
                     ("opt_c", "opt_a"))


@pytest.mark.parametrize("paper_lr", [True, False])
def test_ddqn_update_matches_jax(paper_lr):
    cfg_j, cfg_t = _cfgs("d3pg", **({} if paper_lr else {"lr_ddqn": 1e-3}))
    dqj, dqt = cfg_j.ddqn_cfg(), cfg_t.ddqn_cfg()
    ts = _np(jt2.t2drl_init(jax.random.PRNGKey(6), cfg_j))
    tts = train_state_from_numpy(ts, cfg_t, device="cpu")
    rng = np.random.default_rng(7)
    n = 32
    batch = {"s": rng.integers(0, dqj.J, n).astype(np.int32),
             "a": rng.integers(0, dqj.n_actions, n).astype(np.int32),
             "r": rng.standard_normal(n).astype(np.float32) * 10,
             "s1": rng.integers(0, dqj.J, n).astype(np.int32)}
    jnew, jloss = jdq.ddqn_update(ts["ddqn"], dqj,
                                  jax.tree.map(jnp.asarray, batch))
    tnew, tloss = tdq.ddqn_update(tts["ddqn"], dqt, _torch_batch(batch))
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-4)
    jnew = train_state_from_numpy({**ts, "ddqn": _np(jnew)}, cfg_t,
                                  device="cpu")["ddqn"]
    assert tnew["opt"]["step"] == 1
    _compare_learner(tnew, jnew, 0.1, paper_lr, ("q",), ("opt",))


def test_amender_is_rounding_noise_where_the_actor_saturates():
    """Where every gated raw xi share is ~0, the reference's amender
    divides ~0 by ~0 + 1e-9, so xi follows the last ulp of the actor's
    tanh.  XLA's f32 tanh is exactly +-1 from |x| = 7.9988, torch's from
    |x| = 9.0108; in between the raw action is 0 in JAX and 3e-8..1.2e-7
    in the port, and the gated shares jump from 0 to ~1 in all.  An untrained
    diffusion actor (|x_0| ~ 12 sigma) lands there often: this is why
    ``test_d3pg_update_matches_jax`` runs the shared-mask case with the
    DDPG actor, whose outputs stay O(1)."""
    x = np.array([-8.5, -8.5, -8.5], np.float32)
    jraw = 0.5 * (np.asarray(jnp.tanh(x)) + 1.0)
    traw = 0.5 * (torch.tanh(torch.from_numpy(x)) + 1.0)
    assert np.all(jraw == 0.0) and torch.all(traw > 0)
    b_raw = np.full(3, 0.5, np.float32)
    req, rho = np.array([0, 1, 2]), np.array([1.0, 0.0, 1.0], np.float32)
    _, jxi = jd3.amend_actions(np.concatenate([b_raw, jraw]), req, rho, 3)
    _, txi = td3.amend_actions(torch.cat([torch.from_numpy(b_raw), traw]),
                               torch.from_numpy(req), torch.from_numpy(rho),
                               3)
    np.testing.assert_array_equal(np.asarray(jxi), 0.0)
    # the port shares the compute between the two gated users
    assert txi[1].item() == 0.0 and txi[0].item() + txi[2].item() > 0.9
    # the same raw action gives the same shares in both frameworks
    _, jsame = jd3.amend_actions(np.concatenate([b_raw, traw.numpy()]), req,
                                 rho, 3)
    np.testing.assert_allclose(txi.numpy(), np.asarray(jsame), rtol=1e-6)


def test_update_telemetry_gives_the_reference_key_sets():
    """``diag=True`` on the single and the stacked updates returns the key
    sets of the reference's ``d3pg_diag_zero`` / ``ddqn_diag_zero`` (the
    values are held against JAX in ``test_torch_obs.py``), per learner for
    the stacked ones; the port's own ``*_diag_zero`` have the same keys
    and shapes."""
    cfg = tt2.T2DRLCfg(env=tenv.EnvCfg(**SMALL), warmup=2, L=2)
    d3, dq = cfg.d3pg_cfg(), cfg.ddqn_cfg()
    g = torch.Generator().manual_seed(0)
    ts = tt2.t2drl_init(g, cfg)
    ts, _ = tt2._episode_core(ts, cfg, g, {"eps": 1.0, "sigma": 0.1})
    sched = td3.make_actor_schedule(d3)
    from repro_torch.core.buffers import buffer_sample, stack_buffers
    _, m = td3.d3pg_update(ts["d3pg"], d3, sched,
                           buffer_sample(ts["ebuf"], g, 8), g, diag=True)
    jzero = jd3.d3pg_diag_zero(jd3.D3PGCfg(**{
        k: getattr(d3, k) for k in ("state_dim", "action_dim", "L")}))
    assert set(m) == set(jzero) == set(td3.d3pg_diag_zero(d3))
    for k, v in m.items():
        assert v.shape == tuple(np.shape(jzero[k])), k
    _, m = tdq.ddqn_update(ts["ddqn"], dq, {
        "s": torch.tensor([0, 1]), "a": torch.tensor([3, 5]),
        "r": torch.tensor([0.5, -1.0]), "s1": torch.tensor([1, 2])},
        diag=True)
    assert set(m) == set(jdq.ddqn_diag_zero(jdq.DDQNCfg())) \
        == set(tdq.ddqn_diag_zero(dq))
    B = 2
    stack = {"d3pg": td3.stack_d3pg([ts["d3pg"]] * B),
             "ddqn": tdq.stack_ddqn([ts["ddqn"]] * B)}
    gens = [torch.Generator().manual_seed(b) for b in range(B)]
    ebuf = stack_buffers([ts["ebuf"]] * B)
    from repro_torch.core.buffers import buffer_sample_stacked
    _, m = td3.d3pg_update_stacked(stack["d3pg"], d3, sched,
                                   buffer_sample_stacked(ebuf, gens, 8),
                                   gens, diag=True)
    assert set(m) == set(jzero)
    assert m["denoise_mag"].shape == (B, d3.L) and m["q_mean"].shape == (B,)
    _, m = tdq.ddqn_update_stacked(stack["ddqn"], dq, {
        "s": torch.tensor([[0, 1]] * B), "a": torch.tensor([[3, 5]] * B),
        "r": torch.tensor([[0.5, -1.0]] * B),
        "s1": torch.tensor([[1, 2]] * B)}, diag=True)
    assert set(m) == set(tdq.ddqn_diag_zero(dq))
    assert all(v.shape == (B,) for v in m.values())


def test_bridged_train_state_has_the_port_layout():
    cfg_j, cfg_t = _cfgs("d3pg")
    ts = _np(jt2.t2drl_init(jax.random.PRNGKey(0), cfg_j))
    tts = train_state_from_numpy(ts, cfg_t, device="cpu")
    fresh = tt2.t2drl_init(torch.Generator().manual_seed(0), cfg_t)
    assert set(tts) == set(fresh) == set(ts)

    def shapes(x):
        if isinstance(x, torch.nn.Module):
            return [tuple(p.shape) for p in x.parameters()]
        if isinstance(x, dict):
            return {k: shapes(v) for k, v in x.items()}
        if isinstance(x, list):
            return [shapes(v) for v in x]
        return (tuple(x.shape), x.dtype) if torch.is_tensor(x) else x

    for k in ("d3pg", "ddqn", "ebuf", "fbuf"):
        assert shapes(tts[k]) == shapes(fresh[k]), k
    assert not any(p.requires_grad
                   for p in tts["d3pg"]["actor_t"].parameters())


# -- episode semantics ----------------------------------------------------------

@pytest.mark.parametrize("allocator,cacher", [("ddpg", "random"),
                                              ("rcars", "ddqn"),
                                              ("rcars", "static")])
def test_train_t2drl_covers_the_ported_methods(allocator, cacher):
    cfg = tt2.T2DRLCfg(env=tenv.EnvCfg(U=2, M=3, T=3, K=2),
                       allocator=allocator, cacher=cacher, warmup=2)
    ts, hist = tt2.train_t2drl(cfg, episodes=2, device="cpu")
    learns = allocator != "rcars"
    assert (ts["d3pg"]["opt_a"]["step"] > 0) == learns
    assert (ts["ebuf"]["size"] > 0) == learns
    assert ts["fbuf"]["size"] == (2 * 2 if cacher == "ddqn" else 0)
    assert all(np.isfinite(v) for vs in hist.values() for v in vs)


@pytest.mark.parametrize("mode", ["mods", "writer"])
def test_scenario_and_telemetry_training_modes_run(mode, tmp_path):
    """The modes that raised until the scenario and telemetry slice: a
    scenario schedule (``mods=``), a ``writer=`` and ``ObsCfg(enabled=
    True)`` train; with a writer the log validates, with telemetry the
    history has the ``diag/`` keys, with a classical cacher the cache
    state advanced."""
    from repro_torch.obs import MetricWriter, validate_jsonl
    from repro_torch.scenarios import build_scenario
    env = tenv.EnvCfg(U=2, M=3, T=2, K=2)
    cfg = tt2.T2DRLCfg(env=env, L=2, warmup=2, cacher="lru",
                       obs=tt2.ObsCfg(enabled=True))
    kw = {}
    if mode == "mods":
        kw["mods"] = build_scenario("flash-crowd", env, device="cpu").mods
    else:
        kw["writer"] = MetricWriter(str(tmp_path / "run.jsonl"))
    ts, hist = tt2.train_t2drl(cfg, episodes=2, device="cpu", **kw)
    assert hist["diag/updates"][-1] > 0 and len(hist["diag/denoise_mag"][0]) \
        == cfg.L
    assert ts["cache"]["time"].item() == 2 * env.T * env.K * env.U
    if mode == "writer":
        kw["writer"].close()
        assert validate_jsonl(str(tmp_path / "run.jsonl")) == 2


@pytest.mark.parametrize("kw,cfg_kw", [
    (dict(num_envs=2), {}), (dict(user_counts=[1]), {}),
    (dict(num_envs=2), dict(policy="shared")),
    ({}, dict(policy="shared")),
    (dict(num_envs=2), dict(allocator="schrs", cacher="static")),
    ({}, dict(allocator="schrs"))])
def test_ported_training_modes_run(kw, cfg_kw):
    """The modes that raised until the vector-env slice (ROADMAP A.5, A.6)
    train: B cells give (episodes, B) histories, one cell the single-cell
    layout."""
    cfg = tt2.T2DRLCfg(env=tenv.EnvCfg(U=2, M=3, T=2, K=2), warmup=2, L=2,
                       ga=tt2.GACfg(pop=6, gens=3), **cfg_kw)
    ts, hist = tt2.train_t2drl(cfg, episodes=2, device="cpu", **kw)
    B = kw.get("num_envs", 1)
    shape = np.asarray(hist["mean_reward"]).shape
    assert shape == ((2, B) if B > 1 else (2,))
    assert all(np.isfinite(np.asarray(v)).all() for v in hist.values())
    assert (ts["models"].a1.dim() == 2) == (B > 1)


@pytest.mark.parametrize("schedule", ["linear", "cosine"])
def test_episode_schedules_match_jax(schedule):
    """Same f32 arithmetic in the same order: equal, but for the one-ulp
    difference of the two frameworks' cos (two ulps allowed there)."""
    kw = dict(eps_schedule=schedule, eps_decay_episodes=7,
              lr_schedule=schedule, lr_warmdown_episodes=9,
              lr_end_scale=0.2)
    e = np.arange(12, dtype=np.float32)
    for alloc in ("d3pg", "rcars"):
        cj = jt2.T2DRLCfg(allocator=alloc, **kw)
        ct = tt2.T2DRLCfg(allocator=alloc, **kw)
        for name in ("episode_epsilon", "episode_sigma", "episode_lr_scale"):
            j = np.asarray(getattr(jt2, name)(cj, jnp.asarray(e)))
            t = getattr(tt2, name)(ct, torch.from_numpy(e)).numpy()
            assert t.dtype == np.float32
            if schedule == "linear":
                np.testing.assert_array_equal(t, j, err_msg=name)
            else:
                np.testing.assert_allclose(t, j, rtol=2.4e-7, atol=2.4e-7,
                                           err_msg=name)
    with pytest.raises(ValueError):
        tt2.episode_epsilon(tt2.T2DRLCfg(eps_schedule="step"), 1)
