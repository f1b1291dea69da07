"""The T2DRL learners' steps and the controller's decisions, plain.

Everything here works on plain tensors and the configuration file's
groups (``env``, ``t2drl``, ``d3pg``, ``ddqn``).  A network is a pair of
lists ``(ws, bs)``; stacked learners carry a leading (B,) axis on every
leaf.  ``mm`` is the matrix product (``nets.tf32_matmul`` for the
control).  Draws are made again from ``torch.Generator`` states: a
generator restored to the state it had when the program reached a draw
site draws what the program drew there (``generator_at``).
"""
from __future__ import annotations

import torch

from . import env as renv
from . import nets

TIME_DIM = 16


def generator_at(state: torch.Tensor, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.set_state(state)
    return g


class Hyper:
    """What the steps read of a configuration file."""

    def __init__(self, cfg: dict, device):
        env, t, d3, dq = cfg["env"], cfg["t2drl"], cfg["d3pg"], cfg["ddqn"]
        self.env, self.U, self.M = env, env["U"], env["M"]
        self.S, self.A, self.J = 4 * env["U"] + env["M"], 2 * env["U"], \
            len(env["gammas"])
        self.L = t["L"]
        self.sched = nets.paper_schedule(self.L, d3["beta_min"],
                                         d3["beta_max"])
        self.te = nets.time_embedding(
            torch.arange(1, self.L + 1, device=device), TIME_DIM)
        self.omega, self.tau = d3["omega"], d3["eps_target"]
        self.lr_a, self.lr_c = t["lr_actor"], t["lr_critic"]
        self.lr_q, self.rho, self.kappa = t["lr_ddqn"], dq["rho"], dq["kappa"]
        self.actor_dims = ((self.A + self.S + TIME_DIM,)
                           + (d3["actor_hidden"],) * d3["actor_layers"]
                           + (self.A,))
        self.critic_dims = ((self.S + self.A,)
                            + (d3["critic_hidden"],) * d3["critic_layers"]
                            + (1,))
        self.q_dims = ((self.J,) + (dq["hidden"],) * dq["n_hidden"]
                       + (2 ** self.M,))
        self.device = device


# -- the start --------------------------------------------------------------

def init_cell(g: torch.Generator, h: Hyper) -> dict:
    """One cell's fresh state as the program documents its draws: the
    model zoo, then the Q-net, then the denoiser and the critic."""
    models = renv.make_models(g, h.env)
    q = renv.mlp_init(g, h.q_dims)
    actor = renv.mlp_init(g, h.actor_dims)
    critic = renv.mlp_init(g, h.critic_dims)
    return {"models": models, "q": q, "actor": actor, "critic": critic}


def init_cells(gens, h: Hyper) -> dict:
    """``init_cell`` of every cell's generator, stacked."""
    cells = [init_cell(g, h) for g in gens]
    out = {"models": {k: torch.stack([c["models"][k] for c in cells])
                      for k in cells[0]["models"]}}
    for net in ("q", "actor", "critic"):
        out[net] = tuple([torch.stack([c[net][j][i] for c in cells])
                          for i in range(len(cells[0][net][j]))]
                         for j in (0, 1))
    return out


# -- acting and the env's slot step -----------------------------------------

def draw_chain(gens, shape, L: int, device):
    """Each learner's x_L then its L noises, from its own generator."""
    x_L = torch.stack([torch.randn(shape, generator=g, device=device)
                       for g in gens])
    noises = torch.stack([torch.randn((L,) + shape, generator=g,
                                      device=device) for g in gens])
    return x_L, noises


def act(actor, s, gen_states, sigma: float, req, rho, h: Hyper, mm):
    """B learners' exploring actions for one slot: each learner's chain
    over its cell's observation s (B, S), plus sigma times N(0, 1),
    clipped to [0, 1] and amended.  Returns (b, xi)."""
    gens = [generator_at(st, h.device) for st in gen_states]
    x_L, noises = draw_chain(gens, (h.A,), h.L, h.device)
    raw = nets.actions_from_chain(nets.reverse_chain(
        actor[0], actor[1], h.sched, s, x_L, noises, h.te, mm))
    noise = torch.stack([torch.randn((h.A,), generator=g, device=h.device)
                         for g in gens])
    raw = torch.clamp(raw + sigma * noise, 0.0, 1.0)
    return renv.amend_actions(raw, req, rho, h.U)


def env_step(st: dict, models: dict, b, xi, gen_states, h: Hyper):
    """The slot's reward for (b, xi) and the next slot's draws of every
    cell: ``(r (C,), next {lambda_idx, pos, h, req, d_in})``."""
    m = renv.slot_metrics(st, h.env, models, b, xi)
    r = renv.slot_reward(m, h.env)
    k = renv.consts(h.env, h.device)
    nxt = [renv.refresh_slot(generator_at(gs, h.device), h.env, k,
                             st["gamma_idx"][c], st["lambda_idx"][c])
           for c, gs in enumerate(gen_states)]
    return r, {f: torch.stack([n[f] for n in nxt]) for f in nxt[0]}


def sample(data: dict, sizes, gen_states, n: int, device) -> dict:
    """Each cell's minibatch of n rows of its buffer, indices drawn
    uniformly below its size from its own generator."""
    idx = torch.stack([torch.randint(0, max(int(sz), 1), (n,),
                                     generator=generator_at(gs, device),
                                     device=device)
                       for gs, sz in zip(gen_states, sizes)])
    rows = torch.arange(idx.shape[0], device=device)[:, None]
    return {k: d[rows, idx] for k, d in data.items()}


# -- the learners' updates --------------------------------------------------

def _leaves(net):
    return list(net[0]) + list(net[1])


def _net(leaves, n: int):
    return (leaves[:n], leaves[n:])


def _grad_of(loss, leaves):
    return list(torch.autograd.grad(loss, leaves))


def d3pg_step(p: dict, opt: dict, step: int, batch: dict, gen_states,
              h: Hyper, mm):
    """One D3PG update of B stacked learners, Eqs. (24)-(29): the target
    chain for s1 (draws: each learner's x_L then noises), the critic's
    loss and Adam step, the policy chain (the next x_L and noises)
    against the updated critic, the actor's Adam step, both soft
    updates.  ``p``: actor, actor_t, critic, critic_t as (ws, bs);
    ``opt``: {"actor"/"critic": (mu, nu)} leaf lists.  Returns
    ``(p, opt, {"critic_loss", "actor_loss"} (B,), {"actor", "critic"}
    gradient leaf lists)``."""
    gens = [generator_at(st, h.device) for st in gen_states]
    n = batch["s"].shape[1]
    amend = lambda raw, req, rho: torch.cat(  # noqa: E731
        renv.amend_actions(raw, req, rho, h.U), dim=-1)
    with torch.no_grad():
        x_L, noises = draw_chain(gens, (n, h.A), h.L, h.device)
        raw1 = nets.actions_from_chain(nets.reverse_chain(
            *p["actor_t"], h.sched, batch["s1"], x_L, noises, h.te, mm))
        a1 = amend(raw1, batch["req1"], batch["rho1"])
        y_hat = batch["r"] + h.omega * nets.mlp(
            *p["critic_t"], torch.cat([batch["s1"], a1], dim=-1), mm)[..., 0]
    nc = len(p["critic"][0])
    cl = [t.detach().requires_grad_(True) for t in _leaves(p["critic"])]
    y = nets.mlp(*_net(cl, nc), torch.cat([batch["s"], batch["a"]], dim=-1),
                 mm)[..., 0]
    c_loss = torch.mean(0.5 * (y_hat - y) ** 2, dim=-1)
    gc = _grad_of(c_loss.sum(), cl)
    c_new, c_mu, c_nu = nets.adam_step([t.detach() for t in cl], gc,
                                       *opt["critic"], step + 1, h.lr_c)
    na = len(p["actor"][0])
    al = [t.detach().requires_grad_(True) for t in _leaves(p["actor"])]
    x_L, noises = draw_chain(gens, (n, h.A), h.L, h.device)
    raw = nets.actions_from_chain(nets.reverse_chain(
        *_net(al, na), h.sched, batch["s"], x_L, noises, h.te, mm))
    q = nets.mlp(*_net(c_new, nc), torch.cat(
        [batch["s"], amend(raw, batch["req"], batch["rho"])], dim=-1),
        mm)[..., 0]
    a_loss = -torch.mean(q, dim=-1)
    ga = _grad_of(a_loss.sum(), al)
    a_new, a_mu, a_nu = nets.adam_step([t.detach() for t in al], ga,
                                       *opt["actor"], step + 1, h.lr_a)
    new = {"actor": _net(a_new, na), "critic": _net(c_new, nc),
           "actor_t": _net(nets.soft_update(_leaves(p["actor_t"]), a_new,
                                            h.tau), na),
           "critic_t": _net(nets.soft_update(_leaves(p["critic_t"]), c_new,
                                             h.tau), nc)}
    losses = {"critic_loss": c_loss.detach(), "actor_loss": a_loss.detach()}
    return (new, {"actor": (a_mu, a_nu), "critic": (c_mu, c_nu)}, losses,
            {"actor": ga, "critic": gc})


def ddqn_step(p: dict, opt: tuple, step: int, batch: dict, h: Hyper, mm):
    """One DDQN update of B stacked learners, Eq. (33): the online net
    picks s1's action, the target net values it; then Adam and the soft
    update.  ``p``: q, q_target as (ws, bs).  Returns ``(p, opt, loss
    (B,), gradient leaf list)``."""
    s = torch.nn.functional.one_hot(batch["s"], h.J).to(torch.float32)
    s1 = torch.nn.functional.one_hot(batch["s1"], h.J).to(torch.float32)
    nq = len(p["q"][0])
    ql = [t.detach().requires_grad_(True) for t in _leaves(p["q"])]
    qv = nets.mlp(*_net(ql, nq), s, mm)
    y = torch.gather(qv, -1, batch["a"][..., None])[..., 0]
    with torch.no_grad():
        a1 = torch.argmax(nets.mlp(*_net(ql, nq), s1, mm), dim=-1)
        q1 = nets.mlp(*p["q_target"], s1, mm)
        y_hat = batch["r"] + h.rho * torch.gather(q1, -1,
                                                  a1[..., None])[..., 0]
    loss = torch.mean(0.5 * (y_hat - y) ** 2, dim=-1)
    g = _grad_of(loss.sum(), ql)
    q_new, mu, nu = nets.adam_step([t.detach() for t in ql], g, *opt,
                                   step + 1, h.lr_q)
    new = {"q": _net(q_new, nq),
           "q_target": _net(nets.soft_update(_leaves(p["q_target"]), q_new,
                                             h.kappa), nq)}
    return new, (mu, nu), loss.detach(), g


# -- the controller's decisions ---------------------------------------------

def slot_decision(actor, st: dict, models: dict, seed: int, h: Hyper, mm):
    """The greedy allocation of every cell for one slot: the chain over
    the observations of all C cells, its x_L (C, A) then noises (L, C, A)
    drawn from one generator seeded with ``seed``; tanh; the amender.
    Returns (b, xi, the compute normaliser of each cell)."""
    g = torch.Generator(device=h.device)
    g.manual_seed(seed)
    s = renv.observe(st, h.env, models)
    shape = s.shape[:-1] + (h.A,)
    x_L = torch.randn(shape, generator=g, device=h.device)
    noises = torch.randn((h.L,) + shape, generator=g, device=h.device)
    raw = nets.actions_from_chain(nets.reverse_chain(
        actor[0], actor[1], h.sched, s, x_L, noises, h.te, mm))
    b, xi = renv.amend_actions(raw, st["req"], st["rho"], h.U)
    return b, xi, renv.compute_norm(raw, st["req"], st["rho"], h.U)


def q_values(q, gamma_idx, h: Hyper, mm):
    """The Q-net's values of every caching action for each cell's
    popularity state: (C, 2^M)."""
    s = torch.nn.functional.one_hot(gamma_idx, h.J).to(torch.float32)
    return nets.mlp(q[0], q[1], s, mm)
