"""AIGC edge-service environment (paper Secs. 3-4), port of
``repro.core.env``, with its scenario modulation (DESIGN.md §9).

State evolves on two timescales: per frame, the popularity skewness gamma
(a J-state Markov chain); per slot, the user-location distribution lambda
(an I-state Markov chain), Rayleigh fading, Zipf(gamma) requests and input
sizes.  Eqs. (1)-(10) and the reward (23) follow the JAX package op for op
(f32, same operation order), so the deterministic functions agree to
rounding.  Random draws come from the ``torch.Generator`` the ``EnvState``
carries (in place of a JAX key); they follow the same distributions, not
the same streams.  Every draw is made on the generator's device and no
function here reads a device value back to the host.

B cells (the vector-env modes) are one ``EnvState`` whose tensors carry a
leading (B,) axis and whose ``generator`` is a tuple of B generators
(``env_reset_batch``); ``ModelParams`` then hold (B, M) leaves
(``make_models_batch``) and masks are (B, U).  The same functions serve
both: at each draw site cell b draws from its own generator exactly what
a single cell draws there (so cell b's stream is that of a single-cell
run on its generator), the draws are stacked, and the arithmetic runs
once over all B cells.

Scenario modulation: a ``ScenarioSchedule`` holds precomputed tensors
indexed by frame t (``P_gamma``) or by the global slot g = t*K + k (the
per-slot leaves), and the env takes one ``SlotMod`` slice per draw
(``schedule_slot_mod``, ``schedule_frame_P``).  ``mod=None`` draws exactly
what the unmodulated env draws, in the same order.  With a mod, the
channel gains and input sizes are scaled after they are drawn and each
user's request is redirected to the flash-crowd model with probability
``burst_prob``: that redirect is one more uniform draw of (U,) per cell,
the last of a refresh (after the input sizes in ``_refresh_slot``, after
the requests in ``env_advance_frame``), drawn whether or not the slot is
in a burst.  Leaves may carry a leading (B,) cell axis.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.obs import profiling

from .quality import gen_delay, tv_quality

MB_BITS = 8e6  # bits per MB


@dataclasses.dataclass(frozen=True)
class EnvCfg:
    """Static environment configuration (paper Table 2); field for field
    the JAX ``EnvCfg``.  See ``repro.core.env.EnvCfg`` for the meaning of
    each field."""
    U: int = 10                 # users
    M: int = 10                 # GenAI model types
    T: int = 10                 # frames per episode
    K: int = 10                 # slots per frame
    tau: float = 20.0           # slot duration (s) = deadline (11h)
    L_steps: float = 1000.0     # total denoising steps at the BS
    C: float = 20.0             # BS storage capacity (GB)
    W_up: float = 20e6          # uplink bandwidth (Hz), shared
    W_dw: float = 40e6          # per-user downlink bandwidth (Hz)
    p_user_dbm: float = 23.0
    p_bs_dbm: float = 43.0
    n0_dbm_hz: float = -176.0   # noise PSD (dBm/Hz)
    r_bc: float = 100e6         # BS->cloud backhaul (bps)
    r_cb: float = 100e6         # cloud->BS backhaul (bps)
    d_in_mb: Tuple[float, float] = (5.0, 10.0)
    d_op_mb: Tuple[float, float] = (5.0, 10.0)
    alpha: float = 0.7          # delay-vs-quality preference (10)
    chi: float = 10.0           # deadline penalty (23)
    Xi: float = 100.0           # storage penalty (32)
    area: float = 250.0         # square side (m)
    gammas: Tuple[float, ...] = (0.2, 0.5, 0.7)     # J popularity states
    # Eq. (37) popularity transitions
    P_gamma: Tuple[Tuple[float, ...], ...] = (
        (0.6, 0.2, 0.2), (0.1, 0.7, 0.2), (0.2, 0.3, 0.5))
    # Eq. (36) location-distribution transitions
    P_lambda: Tuple[Tuple[float, ...], ...] = (
        (0.6, 0.1, 0.3), (0.3, 0.6, 0.1), (0.1, 0.3, 0.6))

    @property
    def p_user(self) -> float:          # mW
        return 10 ** (self.p_user_dbm / 10)

    @property
    def p_bs(self) -> float:            # mW
        return 10 ** (self.p_bs_dbm / 10)

    @property
    def n0(self) -> float:              # mW/Hz
        return 10 ** (self.n0_dbm_hz / 10)

    @property
    def state_dim(self) -> int:         # Eq. (21): 4U + M
        return 4 * self.U + self.M

    @property
    def action_dim(self) -> int:        # Eq. (22): 2U
        return 2 * self.U


class ModelParams(NamedTuple):
    """Per-GenAI-model fitted curve + storage parameters (Sec. 7.1), each
    an (M,) float32 tensor."""
    a1: torch.Tensor   # steps where quality starts improving  [50,100]
    a2: torch.Tensor   # worst TV                               [100,150]
    a3: torch.Tensor   # steps where quality saturates          [150,200]
    a4: torch.Tensor   # best TV                                [1,50]
    b1: torch.Tensor   # delay slope                            [0.05,0.5]
    b2: torch.Tensor   # delay intercept                        [1,10]
    c: torch.Tensor    # storage (GB)                           [2,10]
    d_op: torch.Tensor  # output size (bits)


class EnvState(NamedTuple):
    generator: torch.Generator  # advances in place (the JAX state's key);
    #                             B cells: a tuple of B generators
    gamma_idx: torch.Tensor     # () int64 — popularity state (per frame)
    lambda_idx: torch.Tensor    # () int64 — location state (per slot)
    pos: torch.Tensor           # (U, 2) user positions (m)
    h: torch.Tensor             # (U,) channel gains (linear)
    req: torch.Tensor           # (U,) int64 requested model ids
    d_in: torch.Tensor          # (U,) input sizes (bits)
    rho: torch.Tensor           # (M,) float 0/1 caching decision


@functools.lru_cache(maxsize=32)
def _consts(cfg: EnvCfg, device: torch.device):
    """Per-(config, device) constant tensors, made once instead of being
    copied to the device on every draw."""
    f32 = torch.float32
    return {
        "gammas": torch.tensor(cfg.gammas, dtype=f32, device=device),
        "log_P_gamma": torch.log(torch.tensor(cfg.P_gamma, dtype=f32,
                                              device=device) + 1e-12),
        "log_P_lambda": torch.log(torch.tensor(cfg.P_lambda, dtype=f32,
                                               device=device) + 1e-12),
        "log_ranks": torch.log(torch.arange(1, cfg.M + 1, dtype=f32,
                                            device=device)),
        "bs": torch.tensor([cfg.area / 2, cfg.area / 2], dtype=f32,
                           device=device),
    }


def _each(gen, draw):
    """``draw(g)`` from one generator, or from each of a tuple of B
    generators in turn, stacked on a leading (B,) axis."""
    if isinstance(gen, tuple):
        return torch.stack([draw(g) for g in gen])
    return draw(gen)


def _lead(gen) -> tuple:
    """The batch axes of what ``_each(gen, ...)`` returns: (B,) or ()."""
    return (len(gen),) if isinstance(gen, tuple) else ()


def _uniform(gen, shape, lo: float, hi: float):
    return lo + (hi - lo) * _each(gen, lambda g: torch.rand(
        shape, generator=g, device=g.device))


def _categorical(gen, logits, shape=()):
    """Draws from ``softmax(logits)`` over the last axis by the Gumbel-max
    trick (as ``jax.random.categorical`` does).  ``logits``: (..., n), its
    leading axes those of ``gen`` ((B,) for B generators); ``shape`` is
    each cell's sample shape, which must end with the logits' other
    axes."""
    n = logits.shape[-1]
    u = _each(gen, lambda g: torch.rand(tuple(shape) + (n,), generator=g,
                                        device=g.device))
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    lead = _lead(gen)
    if lead and logits.dim() == len(lead) + 1:
        logits = logits.reshape(lead + (1,) * len(shape) + (n,))
    return torch.argmax(logits + gumbel, dim=-1)


def make_models(generator: torch.Generator, cfg: EnvCfg) -> ModelParams:
    u = lambda lo, hi: _uniform(generator, (cfg.M,), lo, hi)  # noqa: E731
    return ModelParams(
        a1=u(50.0, 100.0), a2=u(100.0, 150.0), a3=u(150.0, 200.0),
        a4=u(1.0, 50.0), b1=u(0.05, 0.5), b2=u(1.0, 10.0), c=u(2.0, 10.0),
        d_op=u(cfg.d_op_mb[0], cfg.d_op_mb[1]) * MB_BITS)


def make_models_batch(generators, cfg: EnvCfg) -> ModelParams:
    """B cells' model zoos, (B, M) leaves; cell b's is ``make_models`` of
    ``generators[b]``."""
    return stack_models([make_models(g, cfg) for g in generators])


def stack_models(zoos) -> ModelParams:
    return ModelParams(*(torch.stack(f) for f in zip(*zoos)))


def _take(table, idx):
    """``table[idx]`` over the last axis: (M,) tables index directly, (...,
    M) tables (B cells, or a population axis) gather row by row."""
    if table.dim() == 1:
        return table[idx]
    return torch.gather(table.expand(idx.shape[:-1] + table.shape[-1:]),
                        -1, idx)


# -- scenario modulation (DESIGN.md §9) --------------------------------------

class SlotMod(NamedTuple):
    """One slot's modulation, consumed at draw time: 0-dim leaves, or (B,)
    for B cells.  ``h_scale`` multiplies the drawn channel gains,
    ``din_scale`` the drawn input sizes; each user's request is
    redirected to ``burst_model`` with probability ``burst_prob``."""
    h_scale: torch.Tensor
    din_scale: torch.Tensor
    burst_prob: torch.Tensor
    burst_model: torch.Tensor


class ScenarioSchedule(NamedTuple):
    """One episode of modulation, precomputed; a leading (B,) axis on every
    leaf gives per-cell schedules."""
    P_gamma: torch.Tensor      # (T, J, J) frame-indexed popularity chains
    h_scale: torch.Tensor      # (T*K,) per-slot channel-gain multiplier
    din_scale: torch.Tensor    # (T*K,) per-slot input-size multiplier
    burst_prob: torch.Tensor   # (T*K,) per-slot flash-crowd redirect prob
    burst_model: torch.Tensor  # () int64 flash-crowd model id


def schedule_slot_mod(sched, g: int):
    """The ``SlotMod`` of global slot ``g`` (clamped to the horizon), from
    an unbatched or a cell-batched schedule; ``None`` passes through."""
    if sched is None:
        return None
    g = min(g, sched.h_scale.shape[-1] - 1)
    return SlotMod(h_scale=sched.h_scale[..., g],
                   din_scale=sched.din_scale[..., g],
                   burst_prob=sched.burst_prob[..., g],
                   burst_model=sched.burst_model)


def schedule_frame_P(sched, t: int):
    """Frame t's popularity transition matrix, (J, J) or (B, J, J); None
    without a schedule (the configured ``P_gamma``)."""
    if sched is None:
        return None
    return sched.P_gamma[..., t, :, :]


def _per_cell(x):
    """A 0-dim or per-cell (B,) value against a (..., U) axis."""
    return x[..., None] if x.dim() else x


def burst_redirect(req, u, mod: SlotMod):
    """The flash-crowd redirect of the reference's ``_apply_burst`` with its
    uniform draws ``u`` (the shape of ``req``) given: a user whose draw
    is below ``burst_prob`` requests ``burst_model``."""
    redirect = u < _per_cell(mod.burst_prob)
    return torch.where(redirect, _per_cell(mod.burst_model).to(req.dtype),
                       req)


def _apply_burst(gen, req, mod: SlotMod):
    """``burst_redirect`` with one uniform draw of (U,) per cell."""
    u = _each(gen, lambda g: torch.rand(req.shape[-1], generator=g,
                                        device=g.device))
    return burst_redirect(req, u, mod)


# -- sampling -----------------------------------------------------------------

def _sample_positions(gen, lambda_idx, cfg: EnvCfg):
    """lambda states: 0 uniform, 1 concentrated (around BS), 2 boundary.
    All three are drawn and one is selected on the device (no host read of
    ``lambda_idx``), as the JAX version does."""
    A, U = cfg.area, cfg.U
    uni = _uniform(gen, (U, 2), 0.0, A)
    conc = torch.clamp(A / 2 + 30.0 * _each(gen, lambda g: torch.randn(
        (U, 2), generator=g, device=g.device)), 0.0, A)
    edge = _uniform(gen, (U, 2), 0.0, A)
    side = _each(gen, lambda g: torch.randint(0, 4, (U,), generator=g,
                                              device=g.device))
    off = _uniform(gen, (U,), 0.0, 15.0)
    bx = torch.where(side == 0, off,
                     torch.where(side == 1, A - off, edge[..., 0]))
    by = torch.where(side == 2, off,
                     torch.where(side == 3, A - off, edge[..., 1]))
    bnd = torch.stack([bx, by], dim=-1)
    lam = lambda_idx[..., None, None]
    return torch.where(lam == 0, uni, torch.where(lam == 1, conc, bnd))


def path_gain(pos, cfg: EnvCfg):
    """Eq. (3) large-scale gain g = 10^(g_dB/10), distance in km (>= 1 m)."""
    bs = _consts(cfg, pos.device)["bs"]
    dis_km = torch.clamp_min(torch.linalg.norm(pos - bs, dim=-1),
                             1.0) / 1000.0
    g_db = -128.1 - 37.6 * torch.log10(dis_km)
    return 10.0 ** (g_db / 10.0)


def _channel_gain(gen, pos, cfg: EnvCfg):
    """h = g·|delta|^2: path loss times Rayleigh power, |CN(0,1)|^2 ~ Exp(1)."""
    rayleigh2 = _each(gen, lambda g: torch.empty(
        cfg.U, device=pos.device).exponential_(1.0, generator=g))
    return path_gain(pos, cfg) * rayleigh2


def zipf_logits(gamma_idx, cfg: EnvCfg):
    """Unnormalized log-weights of the Eq. (1) Zipf popularity over model
    ids for skewness state ``gamma_idx``."""
    c = _consts(cfg, gamma_idx.device)
    return -c["gammas"][gamma_idx][..., None] * c["log_ranks"]


def _sample_requests(gen, gamma_idx, cfg: EnvCfg):
    """Zipf over model ids, Eq. (1): (U,) int64 ((B, U) for B cells)."""
    return _categorical(gen, zipf_logits(gamma_idx, cfg), (cfg.U,))


def _sample_markov(gen, idx, log_P):
    """Next state of the chain with log-transition matrix ``log_P`` (one
    (J, J) for every cell, or (B, J, J), cell b's own) from each cell's
    state ``idx`` (one draw per cell)."""
    if log_P.dim() == 3:
        rows = log_P[torch.arange(idx.shape[0], device=idx.device), idx]
    else:
        rows = log_P[idx]
    return _categorical(gen, rows, idx.shape[len(_lead(gen)):])


def _refresh_slot(state: EnvState, cfg: EnvCfg, new_lambda: bool = True,
                  mod: SlotMod = None) -> EnvState:
    """Draw per-slot randomness: location state, positions, fading,
    requests, input sizes; ``mod`` (the SlotMod of the slot being drawn)
    then scales the gains and input sizes and redirects a burst fraction
    of the requests, with one more draw."""
    g = state.generator
    lam = (_sample_markov(g, state.lambda_idx,
                          _consts(cfg, state.h.device)["log_P_lambda"])
           if new_lambda else state.lambda_idx)
    pos = _sample_positions(g, lam, cfg)
    h = _channel_gain(g, pos, cfg)
    req = _sample_requests(g, state.gamma_idx, cfg)
    d_in = _uniform(g, (cfg.U,), cfg.d_in_mb[0], cfg.d_in_mb[1]) * MB_BITS
    if mod is not None:
        h = h * _per_cell(mod.h_scale)
        d_in = d_in * _per_cell(mod.din_scale)
        req = _apply_burst(g, req, mod)
    return state._replace(lambda_idx=lam, pos=pos, h=h, req=req, d_in=d_in)


def env_reset(generator, cfg: EnvCfg, mod: SlotMod = None) -> EnvState:
    """Initial env state (slot 0 randomness included), on the generator's
    device; the state keeps ``generator`` and advances it.  A tuple of B
    generators resets B cells (``env_reset_batch``).  ``mod``: the first
    slot's modulation (``None``: unmodulated)."""
    gen = generator
    dev = (gen[0] if isinstance(gen, tuple) else gen).device
    lead = _lead(gen)

    def randint(n):
        return _each(gen, lambda g: torch.randint(0, n, (), generator=g,
                                                  device=dev))
    st = EnvState(
        generator=gen,
        gamma_idx=randint(len(cfg.gammas)),
        lambda_idx=randint(len(cfg.P_lambda)),
        pos=torch.zeros(lead + (cfg.U, 2), device=dev),
        h=torch.ones(lead + (cfg.U,), device=dev),
        req=torch.zeros(lead + (cfg.U,), dtype=torch.int64, device=dev),
        d_in=torch.ones(lead + (cfg.U,), device=dev) * cfg.d_in_mb[0]
        * MB_BITS,
        rho=torch.zeros(lead + (cfg.M,), device=dev))
    return _refresh_slot(st, cfg, new_lambda=False, mod=mod)


def env_reset_batch(generators, cfg: EnvCfg, mod: SlotMod = None
                    ) -> EnvState:
    """Reset B cells, cell b from ``generators[b]`` (cell b's state is what
    ``env_reset`` gives from that generator); ``mod`` with (B,) leaves."""
    return env_reset(tuple(generators), cfg, mod)


def env_cell(state: EnvState, b: int) -> EnvState:
    """Cell b of a B-cell state: views of its tensors, its generator."""
    return EnvState(state.generator[b], *(t[b] for t in state[1:]))


def make_user_masks(cfg: EnvCfg, counts) -> torch.Tensor:
    """(B, U) float masks: the first ``counts[b]`` users of cell b are
    active."""
    counts = torch.as_tensor(counts)
    return (torch.arange(cfg.U, device=counts.device)[None, :]
            < counts[:, None]).to(torch.float32)


def env_advance_frame(state: EnvState, cfg: EnvCfg, P_gamma=None,
                      mod: SlotMod = None) -> EnvState:
    """Frame boundary: popularity Markov transition; the first slot's
    requests are re-drawn under the new skewness.  The frame's caching
    decision is applied afterwards with ``env_set_cache``.  ``P_gamma``
    ((J, J), or (B, J, J)) replaces the configured transition matrix for
    this frame; ``mod`` redirects a burst fraction of the re-drawn
    requests."""
    g = state.generator
    log_P = (_consts(cfg, state.h.device)["log_P_gamma"] if P_gamma is None
             else torch.log(P_gamma + 1e-12))
    gamma = _sample_markov(g, state.gamma_idx, log_P)
    req = _sample_requests(g, gamma, cfg)
    if mod is not None:
        req = _apply_burst(g, req, mod)
    return state._replace(gamma_idx=gamma, req=req)


def env_set_cache(state: EnvState, rho) -> EnvState:
    return state._replace(rho=rho)


def env_new_frame(state: EnvState, cfg: EnvCfg, rho, P_gamma=None,
                  mod: SlotMod = None) -> EnvState:
    """Frame boundary: popularity Markov transition + new caching
    decision, with ``env_advance_frame``'s schedule slices."""
    return env_set_cache(env_advance_frame(state, cfg, P_gamma, mod), rho)


# -- slot dynamics (Eqs. 2-10, 23) --------------------------------------------

def radio_rates(h, b, cfg: EnvCfg):
    """Eqs. (2)/(5): per-user uplink rate under bandwidth shares ``b`` and
    the (share-independent) downlink rate."""
    snr_up = cfg.p_user * h / (cfg.n0 * b * cfg.W_up)
    r_up = b * cfg.W_up * torch.log2(1.0 + snr_up)
    snr_dw = cfg.p_bs * h / (cfg.n0 * cfg.W_dw)
    r_dw = cfg.W_dw * torch.log2(1.0 + snr_dw)
    return r_up, r_dw


def slot_metrics(state: EnvState, cfg: EnvCfg, models: ModelParams, b, xi):
    """Per-user delay/quality/utility for allocation (b, xi)."""
    cached = _take(state.rho, state.req)               # (U,) 0/1
    b = torch.clamp_min(b, 1e-9)
    r_up, r_dw = radio_rates(state.h, b, cfg)
    # Eq. (4): upload delay (+ backhaul if not cached)
    d_up = state.d_in / r_up + (1.0 - cached) * state.d_in / cfg.r_bc
    d_op = _take(models.d_op, state.req)
    # Eq. (6): feedback delay
    d_dw = d_op / r_dw + (1.0 - cached) * d_op / cfg.r_cb
    # Eqs. (7)-(8): generation quality / delay
    steps = xi * cfg.L_steps
    m = state.req
    a1, a2, a3, a4 = (_take(t, m) for t in (models.a1, models.a2, models.a3,
                                            models.a4))
    b1, b2 = _take(models.b1, m), _take(models.b2, m)
    q_edge = tv_quality(steps, a1, a2, a3, a4)
    q = torch.where(cached > 0, q_edge, a4)
    d_gt_edge = gen_delay(steps, b1, b2)
    d_gt_cloud = b1 * a3 + b2
    d_gt = torch.where(cached > 0, d_gt_edge, d_gt_cloud)
    # Eqs. (9)-(10)
    d_tl = d_up + d_dw + d_gt
    G = cfg.alpha * d_tl + (1.0 - cfg.alpha) * q
    return {"G": G, "d_tl": d_tl, "quality": q, "delay_up": d_up,
            "delay_dw": d_dw, "delay_gt": d_gt, "cached": cached,
            "rate_up": r_up, "rate_dw": r_dw}


def masked_mean(x, mask=None):
    """Mean over the user axis (the last); with a 0/1 mask, over active
    users only (safe when none is active).  x: (U,) or (B, U)."""
    if x.dim() > 1:
        if mask is None:
            return torch.mean(x, dim=-1)
        return torch.sum(x * mask, dim=-1) / torch.clamp_min(
            torch.sum(mask, dim=-1), 1.0)
    if mask is None:
        return torch.mean(x)
    return torch.sum(x * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def slot_reward(metrics, cfg: EnvCfg, mask=None):
    """Eq. (23)."""
    viol = (metrics["d_tl"] > cfg.tau).to(torch.float32)
    return -masked_mean(metrics["G"] + viol * cfg.chi, mask)


def env_step_slot(state: EnvState, cfg: EnvCfg, models: ModelParams, b, xi,
                  mask=None, mod: SlotMod = None):
    """Execute allocation (b, xi) on the current slot, then draw the next
    slot's randomness, modulated by ``mod`` (the next slot's SlotMod).
    Returns (next state, scalar reward, metrics)."""
    metrics = slot_metrics(state, cfg, models, b, xi)
    r = slot_reward(metrics, cfg, mask)
    return _refresh_slot(state, cfg, mod=mod), r, metrics


# -- observation (Eq. 21) -----------------------------------------------------

def observe(state: EnvState, cfg: EnvCfg, models: ModelParams, mask=None):
    """s_t(k) = {h, phi, rho, d_in, d_op} normalised to O(1) ranges."""
    if profiling.ON:
        with profiling.span("env.observe"):
            return _observe(state, cfg, models, mask)
    return _observe(state, cfg, models, mask)


def _observe(state, cfg, models, mask):
    h_n = (torch.log10(state.h + 1e-30) + 12.0) / 5.0
    req_n = state.req.to(torch.float32) / cfg.M
    din_n = state.d_in / (cfg.d_in_mb[1] * MB_BITS)
    dop_n = _take(models.d_op, state.req) / (cfg.d_op_mb[1] * MB_BITS)
    if mask is not None:
        h_n, req_n = h_n * mask, req_n * mask
        din_n, dop_n = din_n * mask, dop_n * mask
    return torch.cat([h_n, req_n, state.rho, din_n, dop_n], dim=-1)
