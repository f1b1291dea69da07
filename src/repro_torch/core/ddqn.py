"""DDQN for the long-timescale model-caching subproblem P3 (paper Sec. 6.3),
port of ``repro.core.ddqn``.

State: the popularity state gamma(t) (one-hot over J).  Action: an integer
in [0, 2^M) decoded to the caching vector rho by the paper's floor/mod
amender; ``feasible_amender`` additionally evicts the largest cached model
until the storage constraint (11d) holds.  ``ddqn_update(diag=True)``
(telemetry, DESIGN.md §15) returns the reference's per-update
diagnostics in place of the loss.  B stacked learners
(``ddqn_init_stacked``: the Q-nets as ``StackedMLP``) act and update in one
pass (``ddqn_act_stacked``, ``ddqn_update_stacked``).
"""
from __future__ import annotations

import copy
import dataclasses

import torch

from repro_torch.obs import profiling
from repro_torch.optim import (adam_init, adam_learner, adam_update,
                               adam_update_stacked, global_norm,
                               global_norm_stacked, learner_values,
                               stack_adam)
from .networks import (mlp_apply, mlp_apply_stacked, mlp_init, soft_update,
                       stack_mlps)


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
    """``{"q": MLP}`` (J -> 128x2 -> 2^M), the inference slice of
    ``ddqn_init`` (what ``export_policy`` keeps)."""
    dims = [cfg.J] + [cfg.hidden] * cfg.n_hidden + [cfg.n_actions]
    return {"q": mlp_init(dims, generator)}


def ddqn_init(cfg: DDQNCfg, generator: torch.Generator) -> dict:
    """Fresh DDQN state on the generator's device: ``q``, its target
    ``q_target`` (a copy, no gradient) and the Adam state ``opt``."""
    q = qnet_init(cfg, generator)["q"]
    return {"q": q, "q_target": copy.deepcopy(q).requires_grad_(False),
            "opt": adam_init(q)}


def _obs(gamma_idx, cfg: DDQNCfg):
    return torch.nn.functional.one_hot(gamma_idx, cfg.J).to(torch.float32)


def ddqn_act(params, cfg: DDQNCfg, gamma_idx, generator=None,
             eps: float = 0.0):
    """epsilon-greedy over the 2^M caching actions; ``gamma_idx`` may carry
    leading batch axes.  ``eps == 0`` is greedy and draws nothing."""
    if profiling.ON:
        with profiling.span("ddqn.act"):
            return _ddqn_act(params, cfg, gamma_idx, generator, eps)
    return _ddqn_act(params, cfg, gamma_idx, generator, eps)


@torch.no_grad()
def _ddqn_act(params, cfg, gamma_idx, generator, eps):
    greedy = torch.argmax(mlp_apply(params["q"], _obs(gamma_idx, cfg)),
                          dim=-1)
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
    if profiling.ON:
        with profiling.span("ddqn.amend_caching"):
            return _amend_caching(a_int, cfg, c, C)
    return _amend_caching(a_int, cfg, c, C)


def _amend_caching(a_int, cfg, c, C):
    a = torch.as_tensor(a_int)
    m = torch.arange(1, cfg.M + 1, device=a.device)
    rho = torch.div(a[..., None], 2 ** (cfg.M - m),
                    rounding_mode="floor") % 2
    rho = rho.to(torch.float32)
    if cfg.feasible_amender and c is not None:
        for _ in range(cfg.M):           # per cell over leading axes
            over = (torch.sum(rho * c, dim=-1, keepdim=True)
                    > C).to(torch.float32)
            largest = torch.nn.functional.one_hot(
                torch.argmax(rho * c, dim=-1), cfg.M).to(torch.float32)
            rho = rho * (1.0 - over * largest)
    return rho


def ddqn_diag_zero(cfg: DDQNCfg, device=None) -> dict:
    """Zero diagnostics of ``ddqn_update(diag=True)`` (a skipped update's
    tap), the keys of the reference's ``ddqn_diag_zero``."""
    return {k: torch.zeros((), device=device)
            for k in ("loss", "td_abs_mean", "td_abs_max", "q_mean",
                      "q_max", "target_div", "grad_norm")}


def _diff_norm(a, b, stacked: bool):
    """||a - b|| over two modules' parameters (per learner if stacked)."""
    diffs = [x.detach() - y.detach()
             for x, y in zip(a.parameters(), b.parameters())]
    return global_norm_stacked(diffs) if stacked else global_norm(diffs)


def _ddqn_diag(loss, y_hat, y, qv, grads, params, stacked: bool) -> dict:
    """The reference's DDQN diagnostics after the step (per learner for
    ``stacked``): |TD| mean and max, Q mean and max over the minibatch's
    Q values, the online/target divergence and the gradient norm."""
    td = torch.abs(y_hat - y.detach())
    qv = qv.detach()
    if stacked:
        flat = qv.reshape(qv.shape[0], -1)
        q = {"td_abs_mean": torch.mean(td, dim=-1),
             "td_abs_max": torch.amax(td, dim=-1),
             "q_mean": torch.mean(flat, dim=-1),
             "q_max": torch.amax(flat, dim=-1),
             "grad_norm": global_norm_stacked(grads)}
    else:
        q = {"td_abs_mean": torch.mean(td), "td_abs_max": torch.amax(td),
             "q_mean": torch.mean(qv), "q_max": torch.amax(qv),
             "grad_norm": global_norm(grads)}
    return {"loss": loss.detach(), **q,
            "target_div": _diff_norm(params["q"], params["q_target"],
                                     stacked)}


def ddqn_update(params: dict, cfg: DDQNCfg, batch: dict, *, lr=None,
                diag: bool = False):
    """One minibatch step of Eq. (33); batch: {s, a, r, s1}, with s/s1
    the gamma indices and a the integer actions.  The online net selects
    the next action and the target net evaluates it (33a); ``y_hat`` is
    detached; then Adam and the soft update of the target at ``kappa``,
    in place.  Returns ``(params, loss)``, or with ``diag=True``
    ``(params, metrics)``, the keys of ``ddqn_diag_zero``."""
    lr = cfg.lr if lr is None else lr
    q = params["q"]
    s, s1 = _obs(batch["s"], cfg), _obs(batch["s1"], cfg)
    qv = mlp_apply(q, s)
    y = torch.gather(qv, 1, batch["a"][:, None])[:, 0]
    with torch.no_grad():
        a1 = torch.argmax(mlp_apply(q, s1), dim=1)
        q1 = mlp_apply(params["q_target"], s1)
        y_hat = batch["r"] + cfg.rho * torch.gather(q1, 1, a1[:, None])[:, 0]
    loss = torch.mean(0.5 * (y_hat - y) ** 2)
    grads = torch.autograd.grad(loss, list(q.parameters()))
    _, opt, _ = adam_update(grads, params["opt"], q, lr=lr)
    new = {"q": q, "q_target": soft_update(params["q_target"], q,
                                           cfg.kappa), "opt": opt}
    if diag:
        return new, _ddqn_diag(loss, y_hat, y, qv, grads, new, False)
    return new, loss.detach()



# -- B stacked learners (DESIGN.md §13) ---------------------------------------

def stack_ddqn(states) -> dict:
    """B learners' DDQN states (``ddqn_init``) -> one stacked state."""
    states = list(states)
    return {"q": stack_mlps(st["q"] for st in states),
            "q_target": stack_mlps(st["q_target"]
                                   for st in states).requires_grad_(False),
            "opt": stack_adam(st["opt"] for st in states)}


def ddqn_init_stacked(cfg: DDQNCfg, generators) -> dict:
    """B learners, learner b's state ``ddqn_init`` of ``generators[b]``."""
    return stack_ddqn(ddqn_init(cfg, g) for g in generators)


def ddqn_learner(params: dict, b: int) -> dict:
    """Learner b's DDQN state: views of the stack's."""
    return {"q": params["q"].learner(b),
            "q_target": params["q_target"].learner(b),
            "opt": adam_learner(params["opt"], b)}


@torch.no_grad()
def ddqn_act_stacked(params, cfg: DDQNCfg, gamma_idx, generators,
                     eps=0.0):
    """epsilon-greedy for B stacked learners: gamma_idx (B,), each
    learner's own state; ``eps`` one number or B of them.  Learner b's
    exploration draws come from ``generators[b]`` as ``ddqn_act``'s from
    one (none where its eps is 0).  Returns (B,) actions."""
    B = gamma_idx.shape[0]
    qv = mlp_apply_stacked(params["q"], _obs(gamma_idx, cfg)[:, None, :])
    greedy = torch.argmax(qv[:, 0], dim=-1)
    eps = list(eps) if isinstance(eps, (list, tuple)) else [eps] * B
    if all(e <= 0.0 for e in eps):
        return greedy
    dev = greedy.device
    rand, explore = [], []
    for g, e in zip(generators, eps):
        if e <= 0.0:
            rand.append(torch.zeros((), dtype=torch.int64, device=dev))
            explore.append(torch.zeros((), dtype=torch.bool, device=dev))
            continue
        rand.append(torch.randint(0, cfg.n_actions, (), generator=g,
                                  device=dev))
        explore.append(torch.rand((), generator=g, device=dev) < e)
    return torch.where(torch.stack(explore), torch.stack(rand), greedy)


def ddqn_update_stacked(params: dict, cfg: DDQNCfg, batch: dict, *, lr=None,
                        diag: bool = False):
    """``ddqn_update`` for B stacked learners in one pass: batch leaves
    (B, n); ``lr`` a number or per-learner sequence/(B,) tensor.  Returns
    the state (updated in place) and the per-learner losses (B,); with
    ``diag=True`` the per-learner (B,) diagnostics instead."""
    q = params["q"]
    B = batch["s"].shape[0]
    lr = learner_values(cfg.lr if lr is None else lr, B, batch["r"].device)
    s, s1 = _obs(batch["s"], cfg), _obs(batch["s1"], cfg)
    qv = mlp_apply_stacked(q, s)
    y = torch.gather(qv, -1, batch["a"][..., None])[..., 0]
    with torch.no_grad():
        a1 = torch.argmax(mlp_apply_stacked(q, s1), dim=-1)
        q1 = mlp_apply_stacked(params["q_target"], s1)
        y_hat = batch["r"] + cfg.rho * torch.gather(q1, -1,
                                                    a1[..., None])[..., 0]
    loss = torch.mean(0.5 * (y_hat - y) ** 2, dim=-1)             # (B,)
    grads = torch.autograd.grad(loss.sum(), list(q.parameters()))
    _, opt, _ = adam_update_stacked(grads, params["opt"], q, lr=lr)
    new = {"q": q, "q_target": soft_update(params["q_target"], q,
                                           cfg.kappa), "opt": opt}
    if diag:
        return new, _ddqn_diag(loss, y_hat, y, qv, grads, new, True)
    return new, loss.detach()
