"""Reverse-process sampling (Eqs. 17-20), the D3PG action generator and
the gateway's image chain (port of ``repro.diffusion.sampler``).

Starting from x_L ~ N(0, I), iterate

    x_{l-1} = c1_l x_l - c2_l eps_hat(x_l, l, s) + sigma_l eps,   eps ~ N(0, I)

with sigma_1 = 0.  ``impl="chain"`` (the default, as the JAX sampler's
one ``lax.scan``) runs the whole chain in one ``kernels.ops.ddpm_chain``
launch: denoiser MLP and update fused over all L steps.  ``impl="step"``
runs the denoiser eagerly and one ``kernels.ops.ddpm_step`` a step.
``reverse_sample_stacked`` runs B learners' chains (a ``StackedDenoiser``)
the same way: one stacked ``ddpm_chain`` launch for all of them, or one
``ddpm_step`` a step for all of them.

Both are differentiable in the denoiser's parameters, as ``jax.grad``
differentiates the reference's sampler: when grad mode is on and the
net's parameters require a gradient, ``impl="chain"`` goes through
``ops.DdpmChain`` (the forward with its record, then one
``ddpm_chain_bwd`` launch in the backward); otherwise it runs under
``torch.no_grad``.  ``impl="step"`` carries autograd's graph through the
eager denoiser and the L ``ddpm_step`` updates (``ddpm_step_bwd`` in the
backward), and to ``state`` too.  On the CPU both run their kernels'
plain versions.

The telemetry variants (``reverse_sample_actions_stats`` and its stacked
form) run the chain in one ``ddpm_chain`` launch with its record and read
each step's denoising magnitude mean |eps_hat| from it: eps_hat is the
net's last layer applied to the last hidden output that the record holds
for the step.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import ops as kops
from repro_torch.obs import profiling

from .denoiser import Denoiser, StackedDenoiser, time_embedding
from .schedule import DiffusionSchedule

IMPLS = ("chain", "step")


@functools.lru_cache(maxsize=64)
def chain_tables(sched: DiffusionSchedule, time_dim: int,
                 device: torch.device):
    """What ``ddpm_chain`` reads of a schedule on ``device``, built once
    and cached: [c1, c2, sigma] per step (L, 3) f32, from
    ``ddpm_coefficients`` (sigma exactly 0 at l_rev = 0), and the time
    embedding of steps 1..L (L, time_dim)."""
    coef = torch.tensor(
        [kops.ddpm_coefficients(sched.alphas_host[l], sched.alpha_bars_host[l],
                                sched.beta_tildes_host[l], l)
         for l in range(sched.L)], dtype=torch.float32, device=device)
    te = time_embedding(torch.arange(1, sched.L + 1, device=device), time_dim)
    return coef, te


def reverse_sample(p: Denoiser, sched: DiffusionSchedule, state,
                   action_dim: int, *, generator=None, x_L=None,
                   noises=None, impl: str = "chain"):
    """One reverse chain.  state: (..., S) -> x0: (..., A) in [-1, 1].

    ``x_L`` (shape ``(..., A)``) and ``noises`` (``(L, ..., A)``, consumed
    in chain order, ``noises[0]`` at the first step) may be injected;
    otherwise they are drawn from ``generator`` on ``state``'s device, the
    same draws for either ``impl``.  When grad mode is on, the result
    carries the graph to ``p``'s parameters (with ``impl="step"`` to
    ``state`` as well; ``impl="chain"`` refuses a ``state`` that requires
    a gradient)."""
    if profiling.ON:
        with profiling.span("sampler.reverse_sample"):
            return _reverse_sample(p, sched, state, action_dim, generator,
                                   x_L, noises, impl)
    return _reverse_sample(p, sched, state, action_dim, generator, x_L,
                           noises, impl)


def _reverse_sample(p, sched, state, action_dim, generator, x_L, noises,
                    impl):
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} is not one of {IMPLS}")
    L = sched.L
    shape = state.shape[:-1] + (action_dim,)
    dev = state.device
    if profiling.ON:
        with profiling.span("sampler.draws"):
            x_L, noises = _draw(shape, L, generator, dev, x_L, noises)
    else:
        x_L, noises = _draw(shape, L, generator, dev, x_L, noises)
    if impl == "chain":
        R = math.prod(shape[:-1])
        coef, te = chain_tables(sched, p.time_dim, dev)
        args = (p.net, x_L.reshape(R, action_dim).contiguous(),
                state.reshape(R, state.shape[-1]).contiguous(),
                noises.reshape(L, R, action_dim).contiguous(), coef, te)
        if torch.is_grad_enabled() and any(q.requires_grad
                                           for q in p.net.parameters()):
            x0 = kops.ddpm_chain(*args)          # DdpmChain: differentiable
        else:
            with torch.no_grad():
                x0 = kops.ddpm_chain(*args)
        return torch.tanh(x0.reshape(shape))
    _, te = chain_tables(sched, p.time_dim, dev)
    x = x_L
    for i in range(L):
        l_rev = L - 1 - i          # 0-based step index, L-1 .. 0
        eps_hat = p(x, None, state, te=te[l_rev])
        x = kops.ddpm_step(x, eps_hat, noises[i], sched.alphas_host[l_rev],
                           sched.alpha_bars_host[l_rev],
                           sched.beta_tildes_host[l_rev], l_rev)
    return torch.tanh(x)


def reverse_sample_actions(p: Denoiser, sched: DiffusionSchedule, state,
                           action_dim: int, *, generator=None, x_L=None,
                           noises=None, impl: str = "chain"):
    """Action in [0, 1]^A (the paper's raw action range)."""
    x0 = reverse_sample(p, sched, state, action_dim, generator=generator,
                        x_L=x_L, noises=noises, impl=impl)
    return 0.5 * (x0 + 1.0)


def _draw_stacked(generators, shape, L, device):
    """Each learner's x_L then its noises from its own generator, as
    ``reverse_sample`` draws them: (B,) + shape and (B, L) + shape."""
    x_L = torch.stack([torch.randn(shape, generator=g, device=device)
                       for g in generators])
    noises = torch.stack([torch.randn((L,) + shape, generator=g,
                                      device=device) for g in generators])
    return x_L, noises


def reverse_sample_stacked(p: StackedDenoiser, sched: DiffusionSchedule,
                           state, action_dim: int, *, generators=None,
                           x_L=None, noises=None, impl: str = "chain"):
    """B learners' reverse chains.  state: (B, ..., S) -> x0: (B, ..., A) in
    [-1, 1], learner b's rows denoised by learner b's net.

    ``x_L`` ((B, ..., A)) and ``noises`` ((B, L, ..., A): each learner's
    own (L, ..., A) draws, consumed in chain order) may be injected;
    otherwise learner b's are drawn from ``generators[b]`` exactly as
    ``reverse_sample`` draws them from one generator, so learner b sees
    the draws a single-learner run on that generator sees.  ``impl``:
    ``"chain"`` one stacked ``ddpm_chain`` launch (differentiable in every
    learner's weights through ``DdpmChain``), ``"step"`` the stacked eager
    denoiser and one ``ddpm_step`` a step."""
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} is not one of {IMPLS}")
    L, B = sched.L, state.shape[0]
    shape = state.shape[1:-1] + (action_dim,)
    dev = state.device
    if (x_L is None) != (noises is None):
        raise ValueError("inject both x_L and noises, or neither")
    if x_L is None:
        if len(generators) != B:
            raise ValueError(f"{len(generators)} generators for {B} "
                             "learners")
        x_L, noises = _draw_stacked(generators, shape, L, dev)
    if impl == "chain":
        R = math.prod(shape[:-1])
        coef, te = chain_tables(sched, p.time_dim, dev)
        args = (p.net, x_L.reshape(B, R, action_dim).contiguous(),
                state.reshape(B, R, state.shape[-1]).contiguous(),
                noises.reshape(B, L, R, action_dim).contiguous(), coef, te)
        if torch.is_grad_enabled() and any(q.requires_grad
                                           for q in p.net.parameters()):
            x0 = kops.ddpm_chain(*args)          # DdpmChain: differentiable
        else:
            with torch.no_grad():
                x0 = kops.ddpm_chain(*args)
        return torch.tanh(x0.reshape((B,) + shape))
    _, te = chain_tables(sched, p.time_dim, dev)
    steps = noises.movedim(1, 0).contiguous()      # (L, B, ..., A)
    x = x_L
    for i in range(L):
        l_rev = L - 1 - i
        eps_hat = p(x, None, state, te=te[l_rev])
        x = kops.ddpm_step(x, eps_hat, steps[i], sched.alphas_host[l_rev],
                           sched.alpha_bars_host[l_rev],
                           sched.beta_tildes_host[l_rev], l_rev)
    return torch.tanh(x)


def reverse_sample_actions_stacked(p: StackedDenoiser,
                                   sched: DiffusionSchedule, state,
                                   action_dim: int, *, generators=None,
                                   x_L=None, noises=None,
                                   impl: str = "chain"):
    """Stacked actions in [0, 1]^A; see ``reverse_sample_stacked``."""
    x0 = reverse_sample_stacked(p, sched, state, action_dim,
                                generators=generators, x_L=x_L,
                                noises=noises, impl=impl)
    return 0.5 * (x0 + 1.0)


def _draw(shape, L, generator, device, x_L, noises):
    if x_L is None:
        x_L = torch.randn(shape, generator=generator, device=device)
    if noises is None:
        noises = torch.randn((L,) + shape, generator=generator,
                             device=device)
    return x_L, noises


def _denoise_mag(net, rec, lead: tuple):
    """Per-step mean |eps_hat| from a chain's record ((B,) L, R, W): the
    last layer on each step's last hidden output, then the mean over the
    rows and the action axis -> ((B,) L)."""
    w, b = net.w[-1], net.b[-1]
    h = rec[..., -w.shape[-2]:]
    if lead:
        B = lead[0]
        eps = torch.bmm(h.reshape(B, -1, h.shape[-1]), w).reshape(
            h.shape[:-1] + (w.shape[-1],)) + b[:, None, None, :]
    else:
        eps = h @ w + b
    return torch.mean(torch.abs(eps), dim=(-2, -1))


@torch.no_grad()
def reverse_sample_actions_stats(p: Denoiser, sched: DiffusionSchedule,
                                 state, action_dim: int, *, generator=None,
                                 x_L=None, noises=None):
    """``reverse_sample_actions`` with the chain's telemetry, no gradient:
    ``(actions, {"denoise_mag": (L,)})``, the mean |eps_hat| of each
    reverse step in chain order (l = L .. 1, noisiest first), from one
    ``ddpm_chain`` launch with its record.  The same draws as the plain
    sampler."""
    L = sched.L
    shape = state.shape[:-1] + (action_dim,)
    x_L, noises = _draw(shape, L, generator, state.device, x_L, noises)
    R = math.prod(shape[:-1])
    coef, te = chain_tables(sched, p.time_dim, state.device)
    x0, rec = kops.ddpm_chain(
        p.net, x_L.reshape(R, action_dim).contiguous(),
        state.reshape(R, state.shape[-1]).contiguous(),
        noises.reshape(L, R, action_dim).contiguous(), coef, te,
        record=True)
    acts = 0.5 * (torch.tanh(x0.reshape(shape)) + 1.0)
    return acts, {"denoise_mag": _denoise_mag(p.net, rec, ())}


@torch.no_grad()
def reverse_sample_actions_stacked_stats(p: StackedDenoiser,
                                         sched: DiffusionSchedule, state,
                                         action_dim: int, *,
                                         generators=None, x_L=None,
                                         noises=None):
    """The stacked telemetry variant: ``(actions (B, ..., A),
    {"denoise_mag": (B, L)})`` from one stacked ``ddpm_chain`` launch with
    its record; learner b's draws as ``reverse_sample_stacked`` makes
    them."""
    L, B = sched.L, state.shape[0]
    shape = state.shape[1:-1] + (action_dim,)
    dev = state.device
    if (x_L is None) != (noises is None):
        raise ValueError("inject both x_L and noises, or neither")
    if x_L is None:
        x_L, noises = _draw_stacked(generators, shape, L, dev)
    R = math.prod(shape[:-1])
    coef, te = chain_tables(sched, p.time_dim, dev)
    x0, rec = kops.ddpm_chain(
        p.net, x_L.reshape(B, R, action_dim).contiguous(),
        state.reshape(B, R, state.shape[-1]).contiguous(),
        noises.reshape(B, L, R, action_dim).contiguous(), coef, te,
        record=True)
    acts = 0.5 * (torch.tanh(x0.reshape((B,) + shape)) + 1.0)
    return acts, {"denoise_mag": _denoise_mag(p.net, rec, (B,))}
