"""DDQN cacher for inference (paper Sec. 6.3), port of the acting half of
``repro.core.ddqn``.

State: the popularity state gamma(t) (one-hot over J).  Action: an integer
in [0, 2^M) decoded to the caching vector rho by the paper's floor/mod
amender; ``feasible_amender`` additionally evicts the largest cached model
until the storage constraint (11d) holds.  ``ddqn_update`` arrives with the
training slice (ROADMAP A).
"""
from __future__ import annotations

import dataclasses

import torch

from .networks import mlp_apply, mlp_init


@dataclasses.dataclass(frozen=True)
class DDQNCfg:
    M: int = 10                  # GenAI model types -> 2^M actions
    J: int = 3                   # popularity states
    hidden: int = 128            # paper: 2 FC layers of 128
    n_hidden: int = 2
    lr: float = 1e-6             # paper's Adam lr
    rho: float = 0.9             # discount (frame-level)
    kappa: float = 0.005         # target update rate (35)
    batch: int = 32
    buffer: int = 2048
    feasible_amender: bool = False   # beyond-paper (off by default)

    @property
    def n_actions(self) -> int:
        return 2 ** self.M


def qnet_init(cfg: DDQNCfg, generator: torch.Generator) -> dict:
    """``{"q": MLP}`` (J -> 128x2 -> 2^M), the inference slice of the JAX
    ``ddqn_init`` (its target net and optimizer state wait for training)."""
    dims = [cfg.J] + [cfg.hidden] * cfg.n_hidden + [cfg.n_actions]
    return {"q": mlp_init(dims, generator)}


@torch.no_grad()
def ddqn_act(params, cfg: DDQNCfg, gamma_idx, generator=None,
             eps: float = 0.0):
    """epsilon-greedy over the 2^M caching actions; ``gamma_idx`` may carry
    leading batch axes.  ``eps == 0`` is greedy and draws nothing."""
    obs = torch.nn.functional.one_hot(gamma_idx, cfg.J).to(torch.float32)
    greedy = torch.argmax(mlp_apply(params["q"], obs), dim=-1)
    if eps <= 0.0:
        return greedy
    dev = greedy.device
    rand = torch.randint(0, cfg.n_actions, greedy.shape, generator=generator,
                         device=dev)
    explore = torch.rand(greedy.shape, generator=generator, device=dev) < eps
    return torch.where(explore, rand, greedy)


def amend_caching(a_int, cfg: DDQNCfg, c=None, C: float = 0.0):
    """Paper's amender: rho_m = floor(a / 2^(M-m)) mod 2, over leading axes
    of ``a_int``.  With ``cfg.feasible_amender`` (single env) the largest
    cached model is evicted while the storage constraint (11d) fails."""
    a = torch.as_tensor(a_int)
    m = torch.arange(1, cfg.M + 1, device=a.device)
    rho = torch.div(a[..., None], 2 ** (cfg.M - m),
                    rounding_mode="floor") % 2
    rho = rho.to(torch.float32)
    if cfg.feasible_amender and c is not None:
        for _ in range(cfg.M):
            over = (torch.sum(rho * c) > C).to(torch.float32)
            largest = torch.nn.functional.one_hot(
                torch.argmax(rho * c), cfg.M).to(torch.float32)
            rho = rho * (1.0 - over * largest)
    return rho
