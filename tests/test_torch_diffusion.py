"""Diffusion actor parity: schedules, time embedding, denoiser and the
reverse chain of the port (CPU) against the JAX package, on shared inputs.
The port's chain runs through either ``impl``: ``"chain"`` (the plain
version of the one-launch ``ddpm_chain``) and ``"step"`` (the denoiser
and one ``ddpm_step`` a step), against both JAX ``impl``s.

The chain's draws (x_L and the L noises) are rebuilt from the JAX key the
way ``repro.diffusion.sampler`` draws them and injected into the port.
f32 tolerance 2e-5 throughout (the whole chain agrees to a few 1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.diffusion import denoiser as jden
from repro.diffusion import make_schedule as jmake_schedule
from repro.diffusion import reverse_sample as jreverse_sample
from repro.diffusion import reverse_sample_actions as jreverse_actions
from repro_torch.bridge import denoiser_from_numpy
from repro_torch.diffusion import (denoiser_apply, denoiser_init,
                                   make_schedule, reverse_sample,
                                   reverse_sample_actions, time_embedding)

TOL = dict(rtol=2e-5, atol=2e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def chain_draws(key, batch_shape, action_dim, L):
    """x_L and noises exactly as repro.diffusion.sampler draws them."""
    kx, ke = jax.random.split(key)
    x_L = jax.random.normal(kx, batch_shape + (action_dim,))
    noises = jax.random.normal(ke, (L,) + batch_shape + (action_dim,))
    return torch.tensor(np.asarray(x_L)), torch.tensor(np.asarray(noises))


@pytest.mark.parametrize("kind,L", [("paper", 5), ("paper", 10),
                                    ("linear", 7), ("linear", 1000),
                                    ("cosine", 12)])
def test_schedule_matches_jax(kind, L):
    j = jmake_schedule(L, kind=kind)
    t = make_schedule(L, kind=kind)
    assert t.L == L
    for name in ("betas", "alphas", "alpha_bars", "beta_tildes"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)),
                                   rtol=2e-5, atol=1e-7, err_msg=name)
    assert t.alphas_host == tuple(t.alphas.tolist())
    assert t.beta_tildes_host[0] == pytest.approx(0.0, abs=1e-12)


def test_time_embedding_matches_jax():
    ls = np.arange(0, 1001, 37).astype(np.float32)
    np.testing.assert_allclose(time_embedding(torch.from_numpy(ls)).numpy(),
                               np.asarray(jden.time_embedding(ls)), **TOL)
    assert time_embedding(3.0).shape == (16,)


def test_denoiser_init_distribution_and_layout():
    p = denoiser_init(50, 20, torch.Generator().manual_seed(0))
    dims = [86, 128, 128, 128, 20]
    assert [tuple(w.shape) for w in p.net.w] == list(zip(dims[:-1],
                                                         dims[1:]))
    for w, b, i in zip(p.net.w, p.net.b, dims[:-1]):
        assert torch.all(b == 0)
        # std 1/sqrt(in) within 10% over >= 2560 draws
        assert abs(w.std().item() * np.sqrt(i) - 1.0) < 0.1


@pytest.mark.parametrize("batch", [(), (3,)])
def test_denoiser_apply_matches_jax(batch):
    key = jax.random.PRNGKey(1)
    jp = jden.denoiser_init(key, 12, 6)
    tp = denoiser_from_numpy(_np(jp), device="cpu")
    rng = np.random.default_rng(0)
    x = rng.standard_normal(batch + (6,)).astype(np.float32)
    s = rng.standard_normal(batch + (12,)).astype(np.float32)
    for l in (1.0, 4.0):
        j = jden.denoiser_apply(jp, x, jnp.float32(l), s)
        t = denoiser_apply(tp, torch.from_numpy(x), l, torch.from_numpy(s))
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("timpl", ["chain", "step"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("batch,S,A,L", [((), 50, 20, 5), ((1,), 50, 20, 5),
                                         ((3,), 50, 20, 5), ((4,), 8, 4, 4),
                                         ((64,), 50, 20, 5)])
def test_reverse_sample_actions_matches_jax(timpl, impl, batch, S, A, L):
    from repro.core import D3PGCfg, make_actor_schedule
    key = jax.random.PRNGKey(7)
    jsched = make_actor_schedule(D3PGCfg(state_dim=S, action_dim=A, L=L))
    jp = jden.denoiser_init(jax.random.PRNGKey(2), S, A)
    s = np.random.default_rng(3).standard_normal(batch + (S,)).astype(
        np.float32)
    j = jreverse_actions(jp, jsched, s, key, A, impl=impl)
    x_L, noises = chain_draws(key, batch, A, L)
    t = reverse_sample_actions(denoiser_from_numpy(_np(jp), device="cpu"),
                               make_schedule(L), torch.from_numpy(s), A,
                               x_L=x_L, noises=noises, impl=timpl)
    assert t.shape == batch + (A,)
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("timpl", ["chain", "step"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_reverse_sample_gateway_chain_matches_jax(timpl, impl):
    """The gateway's unconditional image chain: linear schedule, state
    (1,) of zeros, 40 steps."""
    key = jax.random.PRNGKey(5)
    jp = jden.denoiser_init(jax.random.PRNGKey(9), 1, 32)
    j = jreverse_sample(jp, jmake_schedule(40, kind="linear"),
                        jnp.zeros((1,)), key, 32, impl=impl)
    x_L, noises = chain_draws(key, (), 32, 40)
    t = reverse_sample(denoiser_from_numpy(_np(jp), device="cpu"),
                       make_schedule(40, kind="linear"), torch.zeros(1), 32,
                       x_L=x_L, noises=noises, impl=timpl)
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("batch,S,A,L,kind", [((3,), 50, 20, 5, "paper"),
                                              ((), 1, 32, 40, "linear")])
def test_chain_plain_version_matches_jax_scan(batch, S, A, L, kind):
    """``ref.ddpm_chain_ref`` itself, called with the sampler's cached
    tables, against the JAX scan (its x_0 before the tanh)."""
    from repro_torch.diffusion.sampler import chain_tables
    from repro_torch.kernels import ref
    key = jax.random.PRNGKey(11)
    jp = jden.denoiser_init(jax.random.PRNGKey(3), S, A)
    s = np.random.default_rng(4).standard_normal(batch + (S,)).astype(
        np.float32)
    j = jreverse_sample(jp, jmake_schedule(L, kind=kind), s, key, A)
    x_L, noises = chain_draws(key, batch, A, L)
    p = denoiser_from_numpy(_np(jp), device="cpu")
    sched = make_schedule(L, kind=kind)
    coef, te = chain_tables(sched, p.time_dim, torch.device("cpu"))
    R = int(np.prod(batch))
    with torch.no_grad():
        x0 = ref.ddpm_chain_ref(p.net, x_L.reshape(R, A),
                                torch.from_numpy(s).reshape(R, S),
                                noises.reshape(L, R, A), coef, te)
    np.testing.assert_allclose(torch.tanh(x0).reshape(batch + (A,)).numpy(),
                               np.asarray(j), **TOL)
    assert chain_tables(sched, p.time_dim, torch.device("cpu"))[0] is coef


def test_chain_and_step_agree_and_draw_alike():
    """From one generator seed both impls draw the same x_L and noises and
    give the same chain, each with a graph to the denoiser (its parameters
    require a gradient); a bad impl is refused."""
    p = denoiser_init(50, 20, torch.Generator().manual_seed(0))
    s = torch.randn(3, 50, generator=torch.Generator().manual_seed(1))
    out = {impl: reverse_sample(p, make_schedule(5), s, 20, impl=impl,
                                generator=torch.Generator().manual_seed(2))
           for impl in ("chain", "step")}
    assert out["chain"].requires_grad and out["step"].requires_grad
    np.testing.assert_allclose(out["chain"].detach().numpy(),
                               out["step"].detach().numpy(), **TOL)
    with pytest.raises(ValueError, match="impl"):
        reverse_sample(p, make_schedule(5), s, 20, impl="scan")


def test_reverse_sample_draws_from_generator():
    p = denoiser_init(8, 4, torch.Generator().manual_seed(0))
    s = torch.zeros(2, 8)
    a1 = reverse_sample_actions(p, make_schedule(3), s, 4,
                                generator=torch.Generator().manual_seed(1))
    a2 = reverse_sample_actions(p, make_schedule(3), s, 4,
                                generator=torch.Generator().manual_seed(1))
    assert torch.equal(a1, a2) and a1.shape == (2, 4)
    assert float(a1.min()) >= 0.0 and float(a1.max()) <= 1.0
