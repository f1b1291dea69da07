"""The B-learner (stacked) primitives of the vector-env slice against the
JAX package's ``*_stacked`` functions on shared inputs (CPU): the stacked
MLP, denoiser and reverse sampler, the B-cell replay buffers, one stacked
D3PG and DDQN update, and the stacked chain's plain versions, refusals
and C struct.

Tolerances, as ``test_torch_train.py`` holds the single-learner forms:
forward values to 2e-5 (rtol = atol); buffers exactly; an update's
losses to 1e-4 relative, its gradients (read from Adam's first moment
after one step) to 1e-4 of each leaf's largest magnitude and its new
parameters at the paper's learning rates to 2e-5.  The diffusion actor's
update is compared without a mask: where an untrained actor saturates
tanh the reference's amender is 0/0 (``test_torch_train.py``).
"""
import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import buffers as jbuf
from repro.core import d3pg as jd3
from repro.core import ddqn as jdq
from repro.core import env as jenv
from repro.core import networks as jnet
from repro.core import t2drl as jt2
from repro.diffusion import denoiser as jden
from repro.diffusion import make_schedule as jmake_schedule
from repro.diffusion import sampler as jsampler
from repro_torch.bridge import (denoiser_from_numpy, mlp_from_numpy,
                                train_state_from_numpy)
from repro_torch.core import buffers as tbuf
from repro_torch.core import d3pg as td3
from repro_torch.core import ddqn as tdq
from repro_torch.core import env as tenv
from repro_torch.core import t2drl as tt2
from repro_torch.core.networks import mlp_init, stack_mlps
from repro_torch.diffusion import (make_schedule, reverse_sample_stacked)
from repro_torch.diffusion.sampler import chain_tables
from repro_torch.kernels import ops, ref

TOL = dict(rtol=2e-5, atol=2e-5)
SMALL = dict(U=3, M=4)


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


def _keys(B, seed):
    return jax.random.split(jax.random.PRNGKey(seed), B)


def _chain_draws(keys, shape, L):
    """Each learner's x_L and noises as ``reverse_sample_stacked`` of the
    reference draws them from its key: (B,) + shape, (B, L) + shape."""
    xs, ns = [], []
    for k in keys:
        kx, ke = jax.random.split(k)
        xs.append(np.asarray(jax.random.normal(kx, shape)))
        ns.append(np.asarray(jax.random.normal(ke, (L,) + shape)))
    return torch.from_numpy(np.stack(xs)), torch.from_numpy(np.stack(ns))


# -- networks and the sampler -------------------------------------------------

def test_mlp_apply_stacked_matches_jax():
    B, dims = 3, [7, 16, 16, 5]
    layers = _np(jnet.mlp_init_stacked(_keys(B, 0), dims))
    rng = np.random.default_rng(0)
    layers = jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
        layers)
    x = rng.standard_normal((B, 4, 2, dims[0])).astype(np.float32)
    want = jnet.mlp_apply_stacked(layers, x, final_act=jnp.tanh)
    got = mlp_from_numpy(layers, device="cpu")(torch.from_numpy(x),
                                               final_act=torch.tanh)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL)


def test_denoiser_apply_stacked_matches_jax():
    B, S, A = 3, 6, 4
    p = _np(jax.vmap(lambda k: jden.denoiser_init(k, S, A, hidden=16))(
        _keys(B, 1)))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, 5, A)).astype(np.float32)
    state = rng.standard_normal((B, 5, S)).astype(np.float32)
    want = jden.denoiser_apply_stacked(p, x, 3.0, state)
    got = denoiser_from_numpy(p, device="cpu")(torch.from_numpy(x), 3.0,
                                               torch.from_numpy(state))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL)


@pytest.mark.parametrize("impl", ["chain", "step"])
def test_reverse_sample_stacked_matches_jax(impl):
    """Both samplers of the stacked actor, with every learner's draws
    rebuilt from its key as the reference's stacked sampler draws them."""
    B, S, A, L, n = 3, 6, 4, 3, 5
    p = _np(jax.vmap(lambda k: jden.denoiser_init(k, S, A, hidden=16))(
        _keys(B, 2)))
    state = np.random.default_rng(2).standard_normal(
        (B, n, S)).astype(np.float32)
    keys = _keys(B, 3)
    want = jsampler.reverse_sample_stacked(p, jmake_schedule(L), state, keys,
                                           A)
    x_L, noises = _chain_draws(keys, (n, A), L)
    with torch.no_grad():
        got = reverse_sample_stacked(denoiser_from_numpy(p, device="cpu"),
                                     make_schedule(L),
                                     torch.from_numpy(state), A, x_L=x_L,
                                     noises=noises, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_reverse_sample_stacked_draws_as_single_learners_do():
    """Learner b draws from its generator what ``reverse_sample`` draws
    from that generator: each slice equals the single-learner chain."""
    from repro_torch.diffusion import (denoiser_init, reverse_sample,
                                       stack_denoisers)
    B, S, A, L = 3, 5, 4, 2
    nets = [denoiser_init(S, A, torch.Generator().manual_seed(b), hidden=8)
            for b in range(B)]
    state = torch.randn(B, 2, S, generator=torch.Generator().manual_seed(9))
    sched = make_schedule(L)
    gens = [torch.Generator().manual_seed(20 + b) for b in range(B)]
    with torch.no_grad():
        got = reverse_sample_stacked(stack_denoisers(nets), sched, state, A,
                                     generators=gens)
        for b in range(B):
            g1 = torch.Generator().manual_seed(20 + b)
            one = reverse_sample(nets[b], sched, state[b], A, generator=g1)
            torch.testing.assert_close(got[b], one, **TOL)
            assert torch.equal(gens[b].get_state(), g1.get_state())


# -- the B-cell replay buffers ------------------------------------------------

def _slot_items(rng, lead):
    f = lambda *s: rng.standard_normal(lead + s).astype(np.float32)  # noqa
    return {"s": f(5), "r": f(), "req": rng.integers(0, 4, lead + (3,),
                                                     dtype=np.int32)}


def _same(jb, tb):
    assert list(np.asarray(jb["ptr"])) == tb["ptr"]
    assert list(np.asarray(jb["size"])) == tb["size"]
    for k, d in tb["data"].items():
        np.testing.assert_array_equal(d.numpy(), np.asarray(jb["data"][k]))


def test_batched_and_stacked_buffers_match_jax():
    """B = 3 cells of capacity 7: per-cell adds, the frame's many-item
    write (``*_batch`` and ``*_stacked``, wrapping) and both samplers on
    the reference's per-cell indices, exactly."""
    B, cap = 3, 7
    rng = np.random.default_rng(4)
    ex = {k: v[0] for k, v in _slot_items(rng, (1,)).items()}
    jb = jbuf.buffer_init_batch(B, cap, jax.tree.map(jnp.asarray, ex))
    tex = {k: torch.as_tensor(np.asarray(v, np.int64 if v.dtype == np.int32
                                         else np.float32))
           for k, v in ex.items()}
    tb_batch = tbuf.buffer_init_batch(B, cap, tex)
    tb_stack = tbuf.buffer_init_batch(B, cap, tex)

    def t(items):
        return {k: torch.from_numpy(v.astype(np.int64)
                                    if v.dtype == np.int32 else v)
                for k, v in items.items()}

    item = _slot_items(rng, (B,))
    jb = jbuf.buffer_add_batch(jb, jax.tree.map(jnp.asarray, item))
    for tb in (tb_batch, tb_stack):
        tbuf.buffer_add_batch(tb, t(item))
    for _ in range(3):                  # 1 + 3 * 3 > cap: wraps
        items = _slot_items(rng, (B, 3))
        jb = jbuf.buffer_add_many_stacked(jb,
                                          jax.tree.map(jnp.asarray, items))
        tbuf.buffer_add_many_batch(tb_batch, t(items))
        tbuf.buffer_add_many_stacked(tb_stack, t(items))
        _same(jb, tb_batch)
        _same(jb, tb_stack)
    keys = _keys(B, 5)
    want = jbuf.buffer_sample_stacked(jb, keys, 6)
    idx = torch.from_numpy(np.stack([np.asarray(jax.random.randint(
        k, (6,), 0, max(int(s), 1))) for k, s in zip(keys, jb["size"])]))
    for fn in (tbuf.buffer_sample_batch, tbuf.buffer_sample_stacked):
        got = fn(tb_stack, batch=6, idx=idx.long())
        for k, v in got.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]))
    gens = [torch.Generator().manual_seed(b) for b in range(B)]
    drawn = tbuf.buffer_sample_stacked(tb_stack, gens, 50)
    assert drawn["s"].shape == (B, 50, 5)


# -- one stacked update -------------------------------------------------------

def _slot_batch(rng, lead, cfg):
    e = cfg.env
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


def _leaf_close(t, j, rel, what):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    assert np.abs(t - j).max() <= rel * np.abs(j).max(), what


def _compare_stacked(tnew, jnew, nets, opts):
    """Gradients through Adam's first moment (mu = 0.1 g after one step),
    then the new parameters and targets to 2e-5."""
    for opt in opts:
        for i, (t, j) in enumerate(zip(tnew[opt]["mu"], jnew[opt]["mu"])):
            _leaf_close(t.numpy(), j.numpy(), 1e-4, (opt, i))
    for net in nets:
        for i, (t, j) in enumerate(zip(tnew[net].parameters(),
                                       jnew[net].parameters())):
            np.testing.assert_allclose(t.detach().numpy(),
                                       j.detach().numpy(), rtol=0,
                                       atol=2e-5, err_msg=f"{net} {i}")


def _unsaturated(d3):
    """The D3PG state with its actors' output layer scaled by 0.05, so the
    untrained chain's x_0 stays O(1) and tanh does not saturate: there the
    reference's amender is 0/0 and its update follows the last ulp of
    XLA's tanh (``test_torch_train.py::
    test_amender_is_rounding_noise_where_the_actor_saturates`` pins that
    case; ``test_d3pg_update_stacked_is_each_learners_update`` runs the
    saturated actor against the port's single-learner update)."""
    d3 = dict(d3)
    for k in ("actor", "actor_t"):
        layers = [dict(l) for l in d3[k]["layers"]]
        layers[-1] = {n: 0.05 * v for n, v in layers[-1].items()}
        d3[k] = {"layers": layers}
    return d3


@pytest.mark.parametrize("allocator,B,mask,lr", [
    ("d3pg", 1, False, "cfg"), ("d3pg", 4, False, "per_learner"),
    ("ddpg", 4, True, "per_learner"), ("ddpg", 1, True, "cfg")])
def test_d3pg_update_stacked_matches_jax(allocator, B, mask, lr):
    """One fused update of B learners from a bridged
    ``t2drl_init_batch`` state, each on its own minibatch, against the
    reference's ``d3pg_update_stacked`` with every learner's chain draws
    rebuilt from its key; per-learner learning rates at the paper's
    scale."""
    cfg_j = jt2.T2DRLCfg(env=jenv.EnvCfg(**SMALL), allocator=allocator, L=3)
    cfg_t = tt2.T2DRLCfg(env=tenv.EnvCfg(**SMALL), allocator=allocator, L=3)
    d3j, d3t = cfg_j.d3pg_cfg(), cfg_t.d3pg_cfg()
    ts = _np(jt2.t2drl_init_batch(jax.random.PRNGKey(3), cfg_j, B))
    if allocator == "d3pg":
        ts["d3pg"] = _unsaturated(ts["d3pg"])
    tts = train_state_from_numpy(ts, cfg_t, device="cpu")
    rng = np.random.default_rng(4)
    n, U, A = 8, cfg_j.env.U, cfg_j.env.action_dim
    batch = _slot_batch(rng, (B, n), cfg_j)
    # 2 to U active users: with one, both simplexes are constant and the
    # actor's gradient is identically 0 (rounding noise in both)
    m = (np.asarray(tenv.make_user_masks(cfg_t.env, rng.integers(
        2, U + 1, B))) if mask else None)
    lrs = ({} if lr == "cfg" else
           {"lr_a": np.linspace(1e-6, 3e-6, B).astype(np.float32),
            "lr_c": np.linspace(2e-6, 1e-6, B).astype(np.float32)})
    keys = _keys(B, 5)
    jnew, jm = jd3.d3pg_update_stacked(
        ts["d3pg"], d3j, jd3.make_actor_schedule(d3j),
        jax.tree.map(jnp.asarray, batch), keys,
        mask=None if m is None else jnp.asarray(m),
        **{k: jnp.asarray(v) for k, v in lrs.items()})
    draws = None
    if allocator == "d3pg":
        kk = jax.vmap(jax.random.split)(keys)
        draws = {"target": _chain_draws(kk[:, 0], (n, A), cfg_j.L),
                 "policy": _chain_draws(kk[:, 1], (n, A), cfg_j.L)}
    tnew, tm = td3.d3pg_update_stacked(
        tts["d3pg"], d3t, td3.make_actor_schedule(d3t), _torch(batch),
        mask=None if m is None else torch.from_numpy(m), draws=draws,
        **{k: torch.from_numpy(v) for k, v in lrs.items()})
    for k in ("critic_loss", "actor_loss"):
        assert tm[k].shape == (B,)
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   rtol=1e-4, err_msg=k)
    jnew = train_state_from_numpy({**ts, "d3pg": _np(jnew)}, cfg_t,
                                  device="cpu")["d3pg"]
    assert tnew["opt_a"]["step"] == tnew["opt_c"]["step"] == 1
    _compare_stacked(tnew, jnew, ("critic", "critic_t", "actor", "actor_t"),
                     ("opt_c", "opt_a"))


@pytest.mark.parametrize("allocator,impl", [("d3pg", "chain"),
                                           ("d3pg", "step"),
                                           ("ddpg", "chain")])
def test_d3pg_update_stacked_is_each_learners_update(allocator, impl):
    """The fused update of B = 3 untrained (saturating) learners with
    per-cell masks and per-learner rates (at the paper's scale) gives each
    learner what the port's single-learner ``d3pg_update`` gives it on the
    same minibatch and draws (losses and new parameters to 2e-5,
    gradients to 1e-4 of each leaf's max), and draws in ``d3pg_update``'s
    order from each learner's generator."""
    B = 3
    cfg = tt2.T2DRLCfg(env=tenv.EnvCfg(**SMALL), allocator=allocator, L=3)
    d3 = cfg.d3pg_cfg()
    sched = td3.make_actor_schedule(d3)
    gens = [torch.Generator().manual_seed(b) for b in range(B)]
    singles = [td3.d3pg_init(d3, g) for g in gens]
    stacked = td3.stack_d3pg(singles)
    rng = np.random.default_rng(8)
    batch = _torch(_slot_batch(rng, (B, 8), cfg))
    mask = tenv.make_user_masks(cfg.env, [3, 1, 2])
    lr_a, lr_c = torch.tensor([1e-6, 0.0, 3e-6]), torch.tensor([2e-6,
                                                                1e-6, 0.0])
    draw_gens = [torch.Generator().manual_seed(10 + b) for b in range(B)]
    new, m = td3.d3pg_update_stacked(stacked, d3, sched, batch, draw_gens,
                                     lr_a=lr_a, lr_c=lr_c, mask=mask,
                                     impl=impl)
    for b in range(B):
        g1 = torch.Generator().manual_seed(10 + b)
        one, m1 = td3.d3pg_update(singles[b], d3, sched,
                                  {k: v[b] for k, v in batch.items()}, g1,
                                  lr_a=lr_a[b].item(), lr_c=lr_c[b].item(),
                                  mask=mask[b], impl=impl)
        assert torch.equal(g1.get_state(), draw_gens[b].get_state())
        for k in m:
            torch.testing.assert_close(m[k][b], m1[k], **TOL)
        for k in ("opt_a", "opt_c"):
            for i, (mu, mu1) in enumerate(zip(new[k]["mu"], one[k]["mu"])):
                _leaf_close(mu[b].numpy(), mu1.numpy(), 1e-4, (k, i))
        for k in ("actor", "actor_t", "critic", "critic_t"):
            for p, q in zip(new[k].parameters(), one[k].parameters()):
                torch.testing.assert_close(p[b], q, rtol=0, atol=2e-5)


@pytest.mark.parametrize("B", [1, 4])
def test_ddqn_stacked_update_and_act_match_jax(B):
    cfg_j = jt2.T2DRLCfg(env=jenv.EnvCfg(**SMALL), lr_ddqn=1e-6)
    cfg_t = tt2.T2DRLCfg(env=tenv.EnvCfg(**SMALL), lr_ddqn=1e-6)
    dqj, dqt = cfg_j.ddqn_cfg(), cfg_t.ddqn_cfg()
    ts = _np(jt2.t2drl_init_batch(jax.random.PRNGKey(6), cfg_j, B))
    tts = train_state_from_numpy(ts, cfg_t, device="cpu")
    rng = np.random.default_rng(7)
    n = 16
    batch = {"s": rng.integers(0, dqj.J, (B, n)).astype(np.int32),
             "a": rng.integers(0, dqj.n_actions, (B, n)).astype(np.int32),
             "r": rng.standard_normal((B, n)).astype(np.float32) * 10,
             "s1": rng.integers(0, dqj.J, (B, n)).astype(np.int32)}
    gamma = rng.integers(0, dqj.J, B).astype(np.int32)
    ja = jdq.ddqn_act_stacked(ts["ddqn"], dqj, jnp.asarray(gamma),
                              _keys(B, 8), 0.0)
    gens = [torch.Generator().manual_seed(b) for b in range(B)]
    ta = tdq.ddqn_act_stacked(tts["ddqn"], dqt,
                              torch.from_numpy(gamma).long(), gens, 0.0)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    explore = tdq.ddqn_act_stacked(tts["ddqn"], dqt,
                                   torch.from_numpy(gamma).long(), gens,
                                   [0.0] + [1.0] * (B - 1))
    assert explore[0] == ta[0] and explore.shape == (B,)
    lr = np.linspace(1e-6, 2e-6, B).astype(np.float32)
    jnew, jloss = jdq.ddqn_update_stacked(
        ts["ddqn"], dqj, jax.tree.map(jnp.asarray, batch), lr=jnp.asarray(lr))
    tnew, tloss = tdq.ddqn_update_stacked(tts["ddqn"], dqt, _torch(batch),
                                          lr=torch.from_numpy(lr))
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=1e-4)
    jnew = train_state_from_numpy({**ts, "ddqn": _np(jnew)}, cfg_t,
                                  device="cpu")["ddqn"]
    _compare_stacked(tnew, jnew, ("q", "q_target"), ("opt",))


# -- the stacked chain: plain versions, refusals, the C struct ----------------

def _stacked_chain(B, dims, S, R, L, seed):
    g = torch.Generator().manual_seed(seed)
    nets = [mlp_init(list(dims), g) for _ in range(B)]
    for net in nets:
        with torch.no_grad():
            for b in net.b:
                b.copy_(0.1 * torch.randn(b.shape, generator=g))
    A, T = dims[-1], dims[0] - dims[-1] - S
    coef, te = chain_tables(make_schedule(L), T, torch.device("cpu"))
    x_L, state = torch.randn(B, R, A, generator=g), \
        torch.randn(B, R, S, generator=g)
    noises = torch.randn(B, L, R, A, generator=g)
    return nets, x_L, state, noises, coef, te


def test_stacked_chain_plain_versions_are_each_learners_chain():
    """The plain stacked forward (and its record) and backward give each
    learner what the single-learner plain versions give on its weights
    (2e-5); ``DdpmChain`` on stacked weights gives the plain stacked
    backward's gradients."""
    B, dims, S, R, L = 3, (13, 9, 9, 4), 3, 5, 3
    nets, x_L, state, noises, coef, te = _stacked_chain(B, dims, S, R, L, 0)
    net = stack_mlps(nets)
    x0, rec = ref.ddpm_chain_stacked_ref(net, x_L, state, noises, coef, te,
                                         record=True)
    g = torch.randn(B, R, dims[-1], generator=torch.Generator().manual_seed(1))
    dws, dbs = ref.ddpm_chain_bwd_stacked_ref(net, rec, state, coef, te, g)
    for b in range(B):
        x1, rec1 = ref.ddpm_chain_ref(nets[b], x_L[b], state[b], noises[b],
                                      coef, te, record=True)
        torch.testing.assert_close(x0[b], x1, **TOL)
        torch.testing.assert_close(rec[b], rec1, **TOL)
        w1, b1 = ref.ddpm_chain_bwd_ref(nets[b], rec1, state[b], coef, te,
                                        g[b])
        for a, o in zip(dws + dbs, w1 + b1):
            torch.testing.assert_close(a[b], o, **TOL)
    leaves = list(net.parameters())
    out = ops.ddpm_chain(net, x_L, state, noises, coef, te)
    grads = torch.autograd.grad(torch.sum(g * out), leaves)
    for a, o in zip(grads, dws + dbs):
        torch.testing.assert_close(a, o, rtol=0, atol=0)


def test_stacked_chain_passes_gradcheck_in_f64():
    B, dims, S, R, L = 2, (9, 5, 3), 2, 3, 2
    nets, x_L, state, noises, coef, te = _stacked_chain(B, dims, S, R, L, 2)
    net = stack_mlps(nets).double()
    args = [t.double() for t in (x_L, state, noises, coef, te)]
    leaves = [p.detach().requires_grad_(True) for p in net.parameters()]
    n = len(leaves) // 2

    def f(*params):
        return ops.DdpmChain.apply(*args, None, *params)

    assert torch.autograd.gradcheck(f, tuple(leaves))
    assert n == 2


def test_stacked_chain_refuses_what_it_cannot_read():
    B, dims, S, R, L = 2, (9, 5, 3), 2, 3, 2
    nets, x_L, state, noises, coef, te = _stacked_chain(B, dims, S, R, L, 3)
    net = stack_mlps(nets).requires_grad_(False)
    ws, bs = list(net.w), list(net.b)
    check = lambda ws, bs, *a: ops._check_chain(ws, bs, *a)  # noqa: E731
    args = (x_L, state, noises, coef, te)
    assert check(ws, bs, *args) == dims
    with pytest.raises(ValueError, match="contiguous"):     # a strided stack
        check([ws[0].transpose(1, 2).contiguous().transpose(1, 2)] + ws[1:],
              bs, *args)
    with pytest.raises(ValueError, match="contiguous"):     # an expanded one
        check([ws[0][:1].expand(B, -1, -1)] + ws[1:], bs, *args)
    with pytest.raises(ValueError):          # layers of both forms
        check([ws[0], nets[0].w[1].detach()], bs, *args)
    with pytest.raises(ValueError):          # layers of different B
        check([ws[0], ws[1][:1].contiguous()], bs, *args)
    with pytest.raises(ValueError):          # rows of another B
        check(ws, bs, x_L[:1], state[:1], noises[:1], coef, te)
    with pytest.raises(ValueError):          # unstacked rows, stacked net
        check(ws, bs, x_L[0], state[0], noises[0], coef, te)


def test_chain_net_struct_matches_the_cuda_source():
    """``ops._ChainNet`` has the fields of ``struct ChainNet`` in
    ddpm_chain.cu, in order, with the same C types and array lengths, so
    ctypes lays it out as nvcc does."""
    src = (Path(ops.__file__).parent / "csrc" / "ddpm_chain.cu").read_text()
    body = re.search(r"struct ChainNet \{(.*?)\};", src, re.S).group(1)
    ctype = {"int": ctypes.c_int, "int64_t": ctypes.c_int64,
             "const float*": ctypes.c_void_p}
    n = {"CHAIN_MAX_LAYERS": ops.CHAIN_MAX_LAYERS,
         "CHAIN_MAX_LAYERS + 1": ops.CHAIN_MAX_LAYERS + 1}
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line:
            continue
        m = re.fullmatch(r"(const float\*|int64_t|int) (\w+)(?:\[(.+)\])?;",
                         line)
        assert m, line
        t = ctype[m.group(1)]
        fields.append((m.group(2), t * n[m.group(3)] if m.group(3) else t))
    got = [(name, t) for name, t in ops._ChainNet._fields_]
    assert [f[0] for f in got] == [f[0] for f in fields]
    for (_, a), (_, b) in zip(got, fields):
        assert ctypes.sizeof(a) == ctypes.sizeof(b)
        assert getattr(a, "_type_", a) == getattr(b, "_type_", b)
    net = ops._chain_net((1,), (2,), (4, 3), 5)
    assert net.learners == 5 and net.w_lstride[0] == 12 \
        and net.b_lstride[0] == 3
