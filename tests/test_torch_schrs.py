"""SCHRS' genetic allocator (CPU) against ``repro.core.baselines``: the
SBX and polynomial mutation on injected uniforms, and ``ga_allocate`` with
every draw rebuilt from the reference's key as it splits it; the elitist
guarantee; the agent's single, lockstep and per-cell forms.

Tolerances: the operators and the amended (b, xi) to 2e-5, B cells in
lockstep against each cell alone likewise (batched sums round in another
order); a tournament with other winners would make another population,
and another (b, xi), so the winners are held exactly through it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jb
from repro.core import env as jenv
from repro_torch.agents import make_allocator
from repro_torch.agents.base import SlotObs, cell_of
from repro_torch.bridge import env_state_from_numpy, models_from_numpy
from repro_torch.core import baselines as tb
from repro_torch.core import env as tenv

TOL = dict(rtol=2e-5, atol=2e-5)
ENV = dict(U=3, M=4)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tests run many small ops, which several
    threads only slow down when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_draws(key, ga, U):
    """The draws of ``repro.core.baselines.ga_allocate`` for ``key``, as it
    splits it (lines 97-145), in ``tb.ga_draws``' layout."""
    P, G = ga.pop, ga.gens
    k0, key = jax.random.split(key)
    out = {"pop": [np.asarray(jax.random.uniform(k0, (P, 2 * U)))]}
    for k in jax.random.split(key, G):
        k1, k2, k3, k4 = jax.random.split(k, 4)
        km, kx = jax.random.split(k4)
        for name, v in (
                ("idx", jax.random.randint(k1, (2, P), 0, P)),
                ("sbx", jax.random.uniform(k2, (P // 2, 2 * U))),
                ("cx", jax.random.uniform(k3, (P // 2, 1))),
                ("mut", jax.random.uniform(km, (P, 2 * U))),
                ("mutate", jax.random.uniform(kx, (P, 2 * U)) < ga.pm)):
            out.setdefault(name, []).append(np.asarray(v))
    d = {k: torch.from_numpy(np.stack(v)) for k, v in out.items()}
    d["pop"] = d["pop"][0]
    d["idx"] = d["idx"].long()
    return d


def _cell(seed, rho=None):
    kc = jax.random.split(jax.random.PRNGKey(seed), 3)
    cfg = jenv.EnvCfg(**ENV)
    models = jenv.make_models(kc[0], cfg)
    st = jenv.env_reset(kc[1], cfg)
    if rho is not None:
        st = st._replace(rho=jnp.asarray(rho, jnp.float32))
    g = torch.Generator().manual_seed(seed)
    return (st, models, kc[2],
            env_state_from_numpy(jax.tree.map(np.asarray, st), g),
            models_from_numpy(jax.tree.map(np.asarray, models), "cpu"))


def test_sbx_and_poly_mutation_match_jax_on_injected_uniforms():
    """The reference's operators draw from a key; the port's take the
    uniforms, rebuilt from that key."""
    rng = np.random.default_rng(0)
    p1, p2, x = (rng.uniform(0, 1, (6, 8)).astype(np.float32)
                 for _ in range(3))
    key = jax.random.PRNGKey(1)
    jc1, jc2 = jb._sbx(key, p1, p2, 15.0)
    u = torch.from_numpy(np.array(jax.random.uniform(key, p1.shape)))
    tc1, tc2 = tb._sbx(u, torch.from_numpy(p1), torch.from_numpy(p2), 15.0)
    np.testing.assert_allclose(tc1.numpy(), np.asarray(jc1), **TOL)
    np.testing.assert_allclose(tc2.numpy(), np.asarray(jc2), **TOL)
    jm = jb._poly_mutation(key, x, 20.0, 0.5)
    k1, k2 = jax.random.split(key)
    tm = tb._poly_mutation(
        torch.from_numpy(np.asarray(jax.random.uniform(k1, x.shape))),
        torch.from_numpy(np.asarray(jax.random.uniform(k2, x.shape) < 0.5)),
        torch.from_numpy(x), 20.0)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **TOL)


@pytest.mark.parametrize("seed,rho", [(0, None), (1, [1, 0, 1, 1]),
                                      (2, [1, 1, 1, 1])])
def test_ga_allocate_matches_jax(seed, rho):
    ga_j, ga_t = jb.GACfg(pop=10, gens=6), tb.GACfg(pop=10, gens=6)
    st, models, key, tst, tm = _cell(seed, rho)
    jb_, jxi = jb.ga_allocate(key, st, jenv.EnvCfg(**ENV), models, ga_j)
    draws = _jax_draws(key, ga_j, ENV["U"])
    b, xi = tb.ga_allocate(None, tst, tenv.EnvCfg(**ENV), tm, ga_t,
                           draws=draws)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb_), **TOL)
    np.testing.assert_allclose(xi.numpy(), np.asarray(jxi), **TOL)
    # B cells in lockstep: each cell's result is its own GA's
    B = 2
    bst = tst._replace(generator=(None,) * B, **{
        f: torch.stack([getattr(tst, f)] * B)
        for f in ("gamma_idx", "lambda_idx", "pos", "h", "req", "d_in",
                  "rho")})
    bm = tenv.stack_models([tm] * B)
    bb, bxi = tb.ga_allocate(None, bst, tenv.EnvCfg(**ENV), bm, ga_t,
                             draws={k: torch.stack([v] * B)
                                    for k, v in draws.items()})
    for c in range(B):
        torch.testing.assert_close(bb[c], b, **TOL)
        torch.testing.assert_close(bxi[c], xi, **TOL)


def _fitness(st, cfg, models, b, xi):
    m = tenv.slot_metrics(st, cfg, models, b, xi)
    viol = (m["d_tl"] > cfg.tau).to(torch.float32)
    return torch.mean(m["G"] + viol * cfg.chi).item()


@pytest.mark.parametrize("seed", range(6))
def test_ga_result_is_never_less_fit_than_the_warm_start(seed):
    """Elitism keeps the best so far, and the all-0.5 warm start is in the
    first population: the result's fitness is at most the warm start's."""
    cfg = tenv.EnvCfg(**ENV)
    st, models, _, tst, tm = _cell(10 + seed)
    ga = tb.GACfg(pop=8, gens=4)
    b, xi = tb.ga_allocate(torch.Generator().manual_seed(seed), tst, cfg, tm,
                           ga)
    from repro_torch.core.d3pg import amend_actions
    wb, wxi = amend_actions(torch.full((2 * cfg.U,), 0.5), tst.req, tst.rho,
                            cfg.U)
    assert _fitness(tst, cfg, tm, b, xi) <= _fitness(tst, cfg, tm, wb, wxi)
    assert abs(b.sum().item() - 1.0) < 1e-5


def test_schrs_agent_acts_alone_in_lockstep_and_per_cell():
    """``act`` on one cell; ``batch_act`` on B cells from one generator;
    ``act_stacked`` on B cells, cell b's draws from its own generator as
    ``act`` draws them (so cell b's result is ``act``'s)."""
    cfg = tenv.EnvCfg(**ENV)
    ga = tb.GACfg(pop=8, gens=3)
    agent = make_allocator("schrs", cfg, None, ga)
    B = 3
    gens = [torch.Generator().manual_seed(b) for b in range(B)]
    env = tenv.env_reset_batch(gens, cfg)
    models = tenv.make_models_batch(
        [torch.Generator().manual_seed(9 + b) for b in range(B)], cfg)
    obs = SlotObs(None, env, models)
    bb, bxi = agent.batch_act({}, obs, torch.Generator().manual_seed(5), {})
    assert bb.shape == bxi.shape == (B, cfg.U)
    sb, sxi = agent.act_stacked({}, obs, [torch.Generator().manual_seed(
        20 + b) for b in range(B)], {})
    for c in range(B):
        one = agent.act({}, cell_of(obs, c),
                        torch.Generator().manual_seed(20 + c), {})
        torch.testing.assert_close(sb[c], one[0], **TOL)
        torch.testing.assert_close(sxi[c], one[1], **TOL)
    g = agent.greedy({}, cell_of(obs, 0), torch.Generator().manual_seed(1))
    assert g[0].shape == (cfg.U,)
