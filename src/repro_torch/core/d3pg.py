"""D3PG actor for inference (paper Sec. 6.2), port of the acting half of
``repro.core.d3pg``.

The actor is a conditional DDPM reverse chain (``repro_torch.diffusion``):
action = L denoising steps from N(0, I), conditioned on the slot state.
``actor_kind="mlp"`` recovers the DDPG baseline's tanh MLP actor.  The
critic and ``d3pg_update`` arrive with the training slice (ROADMAP A).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.diffusion import (denoiser_init, make_schedule,
                                   reverse_sample_actions)
from .networks import mlp_apply, mlp_init


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


@torch.no_grad()
def actor_act(actor, cfg: D3PGCfg, sched, state, generator=None, *,
              x_L=None, noises=None, impl: str = "chain"):
    """Raw action in [0,1]^A.  state: (..., S).  ``x_L``/``noises`` inject
    the diffusion chain's draws, ``impl`` picks its kernels (see
    ``reverse_sample``)."""
    if cfg.actor_kind == "diffusion":
        return reverse_sample_actions(actor, sched, state, cfg.action_dim,
                                      generator=generator, x_L=x_L,
                                      noises=noises, impl=impl)
    x = mlp_apply(actor, state, final_act=torch.tanh)
    return 0.5 * (x + 1.0)


def amend_actions(raw, req, rho, U: int, *, b_floor: float = 0.01,
                  mask=None):
    """The paper's action amender: project raw [0,1]^{2U} onto the
    bandwidth simplex (11e) and the cache-gated compute simplex
    (11f)-(11g).  ``b_floor`` is a pseudo-count that keeps every share
    positive; ``mask`` restricts both simplexes to active users.  See
    ``repro.core.d3pg.amend_actions``."""
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
