"""D3PG — diffusion-based deep deterministic policy gradient (paper Sec. 6.2),
port of ``repro.core.d3pg``.

The actor is a conditional DDPM reverse chain (``repro_torch.diffusion``):
action = L denoising steps from N(0, I), conditioned on the slot state.
The critic is the paper's 2x256 MLP.  ``actor_kind="mlp"`` recovers the
DDPG baseline's tanh MLP actor.

Acting (``actor_act``) runs the whole chain in one ``ddpm_chain`` launch
under ``torch.no_grad``; the actor's loss in ``d3pg_update`` goes through
``actor_forward``, the grad-enabled chain: with ``impl="chain"`` (the
default) one ``ddpm_chain`` launch with its record and one
``ddpm_chain_bwd`` launch in the backward, with ``impl="step"`` the eager
denoiser around L ``ddpm_step`` and L ``ddpm_step_bwd`` launches.  The
telemetry variant (``diag=True``, DESIGN.md §15) adds Q and TD statistics,
gradient norms and, for the diffusion actor, the target chain's per-step
denoising magnitudes, read from the record of that chain's one
``ddpm_chain`` launch: the same launches as without it.

B independent learners (the fused vector-env path, DESIGN.md §13) keep one
stacked state (``d3pg_init_stacked``: every network a ``StackedMLP`` or
``StackedDenoiser``, every Adam moment B-leading): ``actor_act_stacked``
acts for all B in one stacked ``ddpm_chain`` launch, and
``d3pg_update_stacked`` updates all B with the launches of one update
(two ``ddpm_chain``, one ``ddpm_chain_bwd``), each learner on its own
minibatch, draws and learning rates.
"""
from __future__ import annotations

import copy
import dataclasses

import torch

from repro_torch.diffusion import (Denoiser, denoiser_init, make_schedule,
                                   reverse_sample_actions,
                                   reverse_sample_actions_stacked,
                                   reverse_sample_actions_stacked_stats,
                                   reverse_sample_actions_stats,
                                   stack_denoisers)
from repro_torch.obs import profiling
from repro_torch.optim import (adam_init, adam_learner, adam_update,
                               adam_update_stacked, global_norm,
                               global_norm_stacked, learner_values,
                               stack_adam)
from .networks import (mlp_apply, mlp_apply_stacked, mlp_init,
                       soft_update, stack_mlps)


@dataclasses.dataclass(frozen=True)
class D3PGCfg:
    state_dim: int
    action_dim: int
    L: int = 5                       # denoising steps (paper Fig. 6a -> 5)
    actor_kind: str = "diffusion"    # "diffusion" (D3PG) | "mlp" (DDPG)
    actor_hidden: int = 128          # paper: 3 FC layers of 128 (denoiser)
    actor_layers: int = 3
    critic_hidden: int = 256         # paper: 2 FC layers of 256
    critic_layers: int = 2
    lr_actor: float = 1e-6
    lr_critic: float = 1e-6
    omega: float = 0.95              # discount
    eps_target: float = 0.005        # target update rate (28)-(29)
    batch: int = 64
    buffer: int = 10000
    beta_min: float = 0.1
    beta_max: float = 10.0
    explore_sigma: float = 0.1       # Gaussian exploration on raw actions


def make_actor_schedule(cfg: D3PGCfg):
    return make_schedule(cfg.L, beta_min=cfg.beta_min, beta_max=cfg.beta_max,
                         kind="paper")


def actor_init(cfg: D3PGCfg, generator: torch.Generator):
    """A fresh actor on the generator's device: the denoiser
    (S + A + 16 -> 128x3 -> A) or, for ``actor_kind="mlp"``, the DDPG MLP
    (S -> 128x3 -> A); same init distribution as the JAX ``d3pg_init``."""
    if cfg.actor_kind == "diffusion":
        return denoiser_init(cfg.state_dim, cfg.action_dim, generator,
                             hidden=cfg.actor_hidden,
                             n_layers=cfg.actor_layers)
    dims = ([cfg.state_dim] + [cfg.actor_hidden] * cfg.actor_layers
            + [cfg.action_dim])
    return mlp_init(dims, generator)


def _frozen(module):
    """A copy that never takes a gradient (the target networks)."""
    return copy.deepcopy(module).requires_grad_(False)


def d3pg_init(cfg: D3PGCfg, generator: torch.Generator) -> dict:
    """Fresh D3PG state on the generator's device: ``actor`` (denoiser or
    MLP), ``critic`` (S + A -> 256x2 -> 1), their targets ``actor_t`` and
    ``critic_t`` (copies, no gradient) and Adam states ``opt_a``,
    ``opt_c``; the init distribution of the JAX ``d3pg_init``."""
    actor = actor_init(cfg, generator)
    critic = mlp_init([cfg.state_dim + cfg.action_dim]
                      + [cfg.critic_hidden] * cfg.critic_layers + [1],
                      generator)
    return {"actor": actor, "actor_t": _frozen(actor),
            "critic": critic, "critic_t": _frozen(critic),
            "opt_a": adam_init(actor), "opt_c": adam_init(critic)}


def actor_forward(actor, cfg: D3PGCfg, sched, state, generator=None, *,
                  x_L=None, noises=None, impl: str = "chain"):
    """Raw action in [0,1]^A with the graph to the actor's parameters: the
    diffusion actor through ``reverse_sample(impl=impl)`` (``"chain"``:
    ``DdpmChain``; ``"step"``: the eager step loop), the DDPG actor through
    its tanh MLP.  What the actor's loss differentiates."""
    if cfg.actor_kind == "diffusion":
        return reverse_sample_actions(actor, sched, state, cfg.action_dim,
                                      generator=generator, x_L=x_L,
                                      noises=noises, impl=impl)
    x = mlp_apply(actor, state, final_act=torch.tanh)
    return 0.5 * (x + 1.0)


@torch.no_grad()
def actor_act(actor, cfg: D3PGCfg, sched, state, generator=None, *,
              x_L=None, noises=None, impl: str = "chain"):
    """Raw action in [0,1]^A, no gradient.  state: (..., S).
    ``x_L``/``noises`` inject the diffusion chain's draws, ``impl`` picks
    its kernels (see ``reverse_sample``)."""
    if cfg.actor_kind == "diffusion":
        return reverse_sample_actions(actor, sched, state, cfg.action_dim,
                                      generator=generator, x_L=x_L,
                                      noises=noises, impl=impl)
    return actor_forward(actor, cfg, sched, state)


def critic_q(critic, state, action):
    """Q(s, a): the critic on ``[s, a]``, (...,)."""
    return mlp_apply(critic, torch.cat([state, action], dim=-1))[..., 0]


def amend_actions(raw, req, rho, U: int, *, b_floor: float = 0.01,
                  mask=None):
    """The paper's action amender: project raw [0,1]^{2U} onto the
    bandwidth simplex (11e) and the cache-gated compute simplex
    (11f)-(11g).  ``b_floor`` is a pseudo-count that keeps every share
    positive; ``mask`` restricts both simplexes to active users.  See
    ``repro.core.d3pg.amend_actions``."""
    if profiling.ON:
        with profiling.span("d3pg.amend_actions"):
            return _amend_actions(raw, req, rho, U, b_floor, mask)
    return _amend_actions(raw, req, rho, U, b_floor, mask)


def _amend_actions(raw, req, rho, U, b_floor, mask):
    b_t, xi_t = raw[..., :U], raw[..., U:]
    b_t = b_t + b_floor
    if mask is not None:
        b_t = b_t * mask
    b = b_t / (torch.sum(b_t, dim=-1, keepdim=True) + 1e-9)
    gate = rho[req] if rho.ndim == 1 else torch.gather(rho, -1, req)
    if mask is not None:
        gate = gate * mask
    xi = xi_t * gate / (torch.sum(gate * xi_t, dim=-1, keepdim=True) + 1e-9)
    return b, xi


def d3pg_diag_zero(cfg: D3PGCfg, device=None) -> dict:
    """Zero diagnostics of ``d3pg_update(diag=True)`` (a skipped update's
    tap), the keys of the reference's ``d3pg_diag_zero``: 0-dim f32, and
    ``denoise_mag`` (L,) for the diffusion actor only."""
    z = lambda *s: torch.zeros(s, device=device)  # noqa: E731
    out = {k: z() for k in ("critic_loss", "actor_loss", "q_mean",
                            "td_abs_mean", "td_abs_max", "actor_grad_norm",
                            "critic_grad_norm")}
    if cfg.actor_kind == "diffusion":
        out["denoise_mag"] = z(cfg.L)
    return out


def _target_action(actor_t, cfg: D3PGCfg, sched, s1, generator, x_L,
                   noises, diag: bool, stacked: bool):
    """The target actor's raw action for ``s1`` (no gradient) and, with
    ``diag`` and the diffusion actor, ``{"denoise_mag"}`` from its chain's
    record (the same one ``ddpm_chain`` launch)."""
    if diag and cfg.actor_kind == "diffusion":
        if stacked:
            return reverse_sample_actions_stacked_stats(
                actor_t, sched, s1, cfg.action_dim, generators=generator,
                x_L=x_L, noises=noises)
        return reverse_sample_actions_stats(
            actor_t, sched, s1, cfg.action_dim, generator=generator,
            x_L=x_L, noises=noises)
    act = actor_act_stacked if stacked else actor_act
    return act(actor_t, cfg, sched, s1, generator, x_L=x_L,
               noises=noises), {}


def _update_diag(y_hat, y, a_grads, c_grads, chain, stacked: bool) -> dict:
    """The update's diagnostics beyond the losses (per learner, over the
    minibatch axis, for ``stacked``): Q mean, |TD| mean and max, the
    actor's and critic's gradient norms, and the target chain's
    ``denoise_mag``."""
    td = torch.abs(y_hat - y.detach())
    axis = dict(dim=-1) if stacked else {}
    norm = global_norm_stacked if stacked else global_norm
    return {"q_mean": torch.mean(y.detach(), **axis),
            "td_abs_mean": torch.mean(td, **axis),
            "td_abs_max": torch.amax(td, **axis) if stacked
            else torch.amax(td),
            "actor_grad_norm": norm(a_grads),
            "critic_grad_norm": norm(c_grads), **chain}


def d3pg_update(params: dict, cfg: D3PGCfg, sched, batch: dict,
                generator: torch.Generator = None, *, lr_a=None, lr_c=None,
                mask=None, diag: bool = False, draws=None,
                impl: str = "chain"):
    """One minibatch step of Eqs. (24)-(29), in the reference's order:

    1. the target action for ``s1``: ``actor_t``'s chain under no-grad
       (one ``ddpm_chain`` launch for the whole minibatch), re-amended
       with ``req1``/``rho1``;
    2. ``y_hat = r + omega Q_t(s1, a1)``, detached;
    3. the critic's loss ``mean(0.5 (y_hat - Q(s, a))^2)`` and its Adam
       step;
    4. the actor's loss ``-mean Q(s, amend(pi(s)))`` against the
       **updated** critic, through ``actor_forward(impl=impl)``: with
       ``"chain"`` one ``ddpm_chain`` launch with its record and one
       ``ddpm_chain_bwd`` launch for the whole minibatch, with ``"step"``
       L ``ddpm_step`` and L ``ddpm_step_bwd`` launches around the eager
       denoiser;
    5. the actor's Adam step;
    6. the soft updates of both targets at ``eps_target``.

    batch: {s, a, r, s1, req, rho, req1, rho1}; ``a`` is the amended action
    that was executed.  ``mask`` is a (U,) or per-row (batch, U)
    active-user mask.  ``draws`` injects the chains' draws as
    ``{"target": (x_L, noises), "policy": (x_L, noises)}``; otherwise the
    target's then the policy's are drawn from ``generator``.  ``impl``
    picks the policy chain's kernels, as the reference's ``impl`` does; the
    target chain runs through ``ddpm_chain`` either way.  Parameters,
    targets and Adam states are updated in place and returned in a new
    dict, with ``{"critic_loss", "actor_loss"}`` (0-dim tensors).
    ``diag=True`` adds the reference's diagnostics (``d3pg_diag_zero``'s
    keys): ``q_mean``, ``td_abs_mean``, ``td_abs_max``, the actor's and
    critic's gradient norms and, for the diffusion actor, ``denoise_mag``
    (L,), the target chain's per-step mean |eps_hat| from the record of its
    ``ddpm_chain`` launch; the launches are the same."""
    lr_a = cfg.lr_actor if lr_a is None else lr_a
    lr_c = cfg.lr_critic if lr_c is None else lr_c
    U = cfg.action_dim // 2
    draws = draws or {}
    x_t, n_t = draws.get("target", (None, None))
    x_pi, n_pi = draws.get("policy", (None, None))

    def amend(raw, req, rho):
        return torch.cat(amend_actions(raw, req, rho, U, mask=mask), dim=-1)

    # --- critic (24) ---------------------------------------------------------
    with torch.no_grad():
        raw1, chain = _target_action(params["actor_t"], cfg, sched,
                                     batch["s1"], generator, x_t, n_t, diag,
                                     stacked=False)
        a1 = amend(raw1, batch["req1"], batch["rho1"])
        y_hat = batch["r"] + cfg.omega * critic_q(params["critic_t"],
                                                  batch["s1"], a1)
    critic = params["critic"]
    y = critic_q(critic, batch["s"], batch["a"])
    c_loss = torch.mean(0.5 * (y_hat - y) ** 2)
    c_grads = torch.autograd.grad(c_loss, list(critic.parameters()))
    _, opt_c, _ = adam_update(c_grads, params["opt_c"], critic, lr=lr_c)

    # --- actor (26)-(27): maximise Q(s, amend(pi(s))) ------------------------
    actor = params["actor"]
    raw = actor_forward(actor, cfg, sched, batch["s"], generator, x_L=x_pi,
                        noises=n_pi, impl=impl)
    act = amend(raw, batch["req"], batch["rho"])
    a_loss = -torch.mean(critic_q(critic, batch["s"], act))
    a_grads = torch.autograd.grad(a_loss, list(actor.parameters()))
    _, opt_a, _ = adam_update(a_grads, params["opt_a"], actor, lr=lr_a)

    new = {"actor": actor,
           "actor_t": soft_update(params["actor_t"], actor, cfg.eps_target),
           "critic": critic,
           "critic_t": soft_update(params["critic_t"], critic,
                                   cfg.eps_target),
           "opt_a": opt_a, "opt_c": opt_c}
    metrics = {"critic_loss": c_loss.detach(), "actor_loss": a_loss.detach()}
    if diag:
        metrics.update(_update_diag(y_hat, y, a_grads, c_grads, chain,
                                    stacked=False))
    return new, metrics


# -- B stacked learners (DESIGN.md §13) ---------------------------------------

def _stack_net(nets):
    nets = list(nets)
    return (stack_denoisers(nets) if isinstance(nets[0], Denoiser)
            else stack_mlps(nets))


def stack_d3pg(states) -> dict:
    """B learners' D3PG states (``d3pg_init``) -> one stacked state."""
    states = list(states)
    out = {k: _stack_net(st[k] for st in states)
           for k in ("actor", "actor_t", "critic", "critic_t")}
    for k in ("actor_t", "critic_t"):
        out[k].requires_grad_(False)
    out.update({k: stack_adam(st[k] for st in states)
                for k in ("opt_a", "opt_c")})
    return out


def d3pg_init_stacked(cfg: D3PGCfg, generators) -> dict:
    """B learners, learner b's state ``d3pg_init`` of ``generators[b]``."""
    return stack_d3pg(d3pg_init(cfg, g) for g in generators)


def d3pg_learner(params: dict, b: int) -> dict:
    """Learner b's D3PG state: modules and moments that are views of the
    stack's (what ``d3pg_update`` writes in place lands in the stack)."""
    out = {k: params[k].learner(b)
           for k in ("actor", "actor_t", "critic", "critic_t")}
    out.update({k: adam_learner(params[k], b) for k in ("opt_a", "opt_c")})
    return out


def actor_forward_stacked(actor, cfg: D3PGCfg, sched, state,
                          generators=None, *, x_L=None, noises=None,
                          impl: str = "chain"):
    """``actor_forward`` for B stacked learners: state (B, ..., S) ->
    raw (B, ..., A) with the graph to every learner's parameters."""
    if cfg.actor_kind == "diffusion":
        return reverse_sample_actions_stacked(
            actor, sched, state, cfg.action_dim, generators=generators,
            x_L=x_L, noises=noises, impl=impl)
    x = mlp_apply_stacked(actor, state, final_act=torch.tanh)
    return 0.5 * (x + 1.0)


@torch.no_grad()
def actor_act_stacked(actor, cfg: D3PGCfg, sched, state, generators=None, *,
                      x_L=None, noises=None, impl: str = "chain"):
    """``actor_act`` for B stacked learners, no gradient: state
    (B, ..., S); learner b's chain draws from ``generators[b]`` as
    ``actor_act`` draws from one (or ``x_L`` (B, ..., A) / ``noises``
    (B, L, ..., A) are injected).  One stacked ``ddpm_chain`` launch."""
    return actor_forward_stacked(actor, cfg, sched, state, generators,
                                 x_L=x_L, noises=noises, impl=impl)


def critic_q_stacked(critic, state, action):
    """Q(s, a) of B stacked critics: (B, ..., S), (B, ..., A) -> (B, ...)."""
    return mlp_apply_stacked(critic, torch.cat([state, action],
                                               dim=-1))[..., 0]


def d3pg_update_stacked(params: dict, cfg: D3PGCfg, sched, batch: dict,
                        generators=None, *, lr_a=None, lr_c=None, mask=None,
                        diag: bool = False, draws=None,
                        impl: str = "chain"):
    """``d3pg_update`` for B stacked learners in one pass, in the same order
    (target chain, critic step, policy chain against the updated critic,
    actor step, soft updates), each learner on its own minibatch.

    batch leaves are (B, n, ...); ``mask`` an optional (B, U) per-cell
    mask; ``lr_a``/``lr_c`` numbers or per-learner sequences/(B,)
    tensors (the population lever).  ``draws`` injects the chains' draws
    as ``{"target": (x_L, noises), "policy": (x_L, noises)}`` with x_L
    (B, n, A) and noises (B, L, n, A); otherwise learner b draws the
    target's then the policy's from ``generators[b]``, as ``d3pg_update``
    draws them from one.  The losses are summed over learners, so each
    learner's gradient is its own loss's.  The diffusion actor's chains:
    one stacked ``ddpm_chain`` launch each (the policy chain with its
    record) and one stacked ``ddpm_chain_bwd``, whatever B.  Returns the
    state (updated in place) and ``{"critic_loss": (B,), "actor_loss":
    (B,)}``; ``diag=True`` adds ``d3pg_update``'s diagnostics per learner,
    (B,) and ``denoise_mag`` (B, L), from the same launches."""
    if profiling.ON:
        with profiling.span("d3pg.update_stacked"):
            return _d3pg_update_stacked(params, cfg, sched, batch,
                                        generators, lr_a, lr_c, mask, diag,
                                        draws, impl)
    return _d3pg_update_stacked(params, cfg, sched, batch, generators, lr_a,
                                lr_c, mask, diag, draws, impl)


def _d3pg_update_stacked(params, cfg, sched, batch, generators, lr_a, lr_c,
                         mask, diag, draws, impl):
    B, dev = batch["s"].shape[0], batch["s"].device
    lr_a = learner_values(cfg.lr_actor if lr_a is None else lr_a, B, dev)
    lr_c = learner_values(cfg.lr_critic if lr_c is None else lr_c, B, dev)
    U = cfg.action_dim // 2
    draws = draws or {}
    x_t, n_t = draws.get("target", (None, None))
    x_pi, n_pi = draws.get("policy", (None, None))
    m = None if mask is None else mask[:, None, :]

    def amend(raw, req, rho):
        return torch.cat(amend_actions(raw, req, rho, U, mask=m), dim=-1)

    with torch.no_grad():
        raw1, chain = _target_action(params["actor_t"], cfg, sched,
                                     batch["s1"], generators, x_t, n_t, diag,
                                     stacked=True)
        a1 = amend(raw1, batch["req1"], batch["rho1"])
        y_hat = batch["r"] + cfg.omega * critic_q_stacked(
            params["critic_t"], batch["s1"], a1)
    critic = params["critic"]
    y = critic_q_stacked(critic, batch["s"], batch["a"])
    c_loss = torch.mean(0.5 * (y_hat - y) ** 2, dim=-1)          # (B,)
    c_grads = torch.autograd.grad(c_loss.sum(), list(critic.parameters()))
    _, opt_c, _ = adam_update_stacked(c_grads, params["opt_c"], critic,
                                      lr=lr_c)

    actor = params["actor"]
    raw = actor_forward_stacked(actor, cfg, sched, batch["s"], generators,
                                x_L=x_pi, noises=n_pi, impl=impl)
    act = amend(raw, batch["req"], batch["rho"])
    a_loss = -torch.mean(critic_q_stacked(critic, batch["s"], act), dim=-1)
    a_grads = torch.autograd.grad(a_loss.sum(), list(actor.parameters()))
    _, opt_a, _ = adam_update_stacked(a_grads, params["opt_a"], actor,
                                      lr=lr_a)
    new = {"actor": actor,
           "actor_t": soft_update(params["actor_t"], actor, cfg.eps_target),
           "critic": critic,
           "critic_t": soft_update(params["critic_t"], critic,
                                   cfg.eps_target),
           "opt_a": opt_a, "opt_c": opt_c}
    metrics = {"critic_loss": c_loss.detach(), "actor_loss": a_loss.detach()}
    if diag:
        metrics.update(_update_diag(y_hat, y, a_grads, c_grads, chain,
                                    stacked=True))
    return new, metrics
