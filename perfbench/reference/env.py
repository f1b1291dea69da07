"""The AIGC edge environment, its draws and the amenders, plain.

Eqs. (1)-(10), (21)-(23) of the paper (arXiv:2411.01458, Secs. 3-4) in
float32, over a configuration file's ``env`` group.  Tensors carry a
leading cell axis (C, ...).  The draws follow the program's documented
protocol: cell c draws from its own ``torch.Generator`` at each draw site
what a single cell draws there, in the same order and shapes, so a
generator restored to the state it had at a call draws that call's
numbers again.
"""
from __future__ import annotations

import math

import torch

MB_BITS = 8e6


def _dbm_mw(dbm: float) -> float:
    return 10 ** (dbm / 10)


def consts(env: dict, device) -> dict:
    f32 = torch.float32
    return {
        "gammas": torch.tensor(env["gammas"], dtype=f32, device=device),
        "log_P_lambda": torch.log(torch.tensor(env["P_lambda"], dtype=f32,
                                               device=device) + 1e-12),
        "log_ranks": torch.log(torch.arange(1, env["M"] + 1, dtype=f32,
                                            device=device)),
        "bs": torch.tensor([env["area"] / 2, env["area"] / 2], dtype=f32,
                           device=device),
    }


# -- draws of one cell from its generator -----------------------------------

def uniform(g, shape, lo: float, hi: float):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=g.device)


def categorical(g, logits, shape=()):
    """Gumbel-max draw from softmax(logits) over the last axis."""
    n = logits.shape[-1]
    u = torch.rand(tuple(shape) + (n,), generator=g, device=g.device)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


def refresh_slot(g, env: dict, k: dict, gamma_idx, lambda_idx):
    """One cell's next-slot draws (no scenario): location state,
    positions, Rayleigh fading, Zipf requests and input sizes.  Returns
    ``{lambda_idx, pos, h, req, d_in}``."""
    A, U = env["area"], env["U"]
    lam = categorical(g, k["log_P_lambda"][lambda_idx])
    uni = uniform(g, (U, 2), 0.0, A)
    conc = torch.clamp(A / 2 + 30.0 * torch.randn((U, 2), generator=g,
                                                  device=g.device), 0.0, A)
    edge = uniform(g, (U, 2), 0.0, A)
    side = torch.randint(0, 4, (U,), generator=g, device=g.device)
    off = uniform(g, (U,), 0.0, 15.0)
    bx = torch.where(side == 0, off,
                     torch.where(side == 1, A - off, edge[..., 0]))
    by = torch.where(side == 2, off,
                     torch.where(side == 3, A - off, edge[..., 1]))
    bnd = torch.stack([bx, by], dim=-1)
    pos = torch.where(lam == 0, uni, torch.where(lam == 1, conc, bnd))
    ray = torch.empty(U, device=g.device).exponential_(1.0, generator=g)
    h = path_gain(pos, env, k) * ray
    logits = -k["gammas"][gamma_idx][..., None] * k["log_ranks"]
    req = categorical(g, logits, (U,))
    d_in = uniform(g, (U,), env["d_in_mb"][0], env["d_in_mb"][1]) * MB_BITS
    return {"lambda_idx": lam, "pos": pos, "h": h, "req": req, "d_in": d_in}


def make_models(g, env: dict) -> dict:
    """One cell's model zoo (Sec. 7.1): eight uniform (M,) draws."""
    M = env["M"]
    u = lambda lo, hi: uniform(g, (M,), lo, hi)  # noqa: E731
    out = {"a1": u(50.0, 100.0), "a2": u(100.0, 150.0),
           "a3": u(150.0, 200.0), "a4": u(1.0, 50.0), "b1": u(0.05, 0.5),
           "b2": u(1.0, 10.0), "c": u(2.0, 10.0)}
    out["d_op"] = u(env["d_op_mb"][0], env["d_op_mb"][1]) * MB_BITS
    return out


def mlp_init(g, dims):
    """w ~ N(0, 1/in), zero biases, layer by layer."""
    ws = [torch.randn(i, o, generator=g, device=g.device) / math.sqrt(i)
          for i, o in zip(dims[:-1], dims[1:])]
    bs = [torch.zeros(o, device=g.device) for o in dims[1:]]
    return ws, bs


# -- deterministic slot arithmetic ------------------------------------------

def path_gain(pos, env: dict, k: dict):
    """Eq. (3): 10^(g_dB/10), distance in km (at least 1 m)."""
    dis_km = torch.clamp_min(torch.linalg.norm(pos - k["bs"], dim=-1),
                             1.0) / 1000.0
    g_db = -128.1 - 37.6 * torch.log10(dis_km)
    return 10.0 ** (g_db / 10.0)


def _take(table, idx):
    return torch.gather(table.expand(idx.shape[:-1] + table.shape[-1:]),
                        -1, idx)


def slot_metrics(st: dict, env: dict, models: dict, b, xi):
    """Eqs. (2)-(10) for allocation (b, xi): per-user G, total delay and
    quality.  ``st``: h, req, d_in, rho of (C, U)/(C, M) cells."""
    W_up, W_dw = env["W_up"], env["W_dw"]
    n0 = _dbm_mw(env["n0_dbm_hz"])
    cached = _take(st["rho"], st["req"])
    b = torch.clamp_min(b, 1e-9)
    snr_up = _dbm_mw(env["p_user_dbm"]) * st["h"] / (n0 * b * W_up)
    r_up = b * W_up * torch.log2(1.0 + snr_up)
    snr_dw = _dbm_mw(env["p_bs_dbm"]) * st["h"] / (n0 * W_dw)
    r_dw = W_dw * torch.log2(1.0 + snr_dw)
    d_up = st["d_in"] / r_up + (1.0 - cached) * st["d_in"] / env["r_bc"]
    d_op = _take(models["d_op"], st["req"])
    d_dw = d_op / r_dw + (1.0 - cached) * d_op / env["r_cb"]
    steps = xi * env["L_steps"]
    a1, a2, a3, a4 = (_take(models[n], st["req"])
                      for n in ("a1", "a2", "a3", "a4"))
    b1, b2 = _take(models["b1"], st["req"]), _take(models["b2"], st["req"])
    slope = (a4 - a2) / (a3 - a1)
    mid = a2 + slope * (steps - a1)
    q_edge = torch.where(steps <= a1, a2, torch.where(steps >= a3, a4, mid))
    q = torch.where(cached > 0, q_edge, a4)
    d_gt = torch.where(cached > 0, b1 * steps + b2, b1 * a3 + b2)
    d_tl = d_up + d_dw + d_gt
    G = env["alpha"] * d_tl + (1.0 - env["alpha"]) * q
    return {"G": G, "d_tl": d_tl, "quality": q, "cached": cached}


def slot_reward(m: dict, env: dict):
    """Eq. (23): minus the users' mean utility plus deadline penalties."""
    viol = (m["d_tl"] > env["tau"]).to(torch.float32)
    return -torch.mean(m["G"] + viol * env["chi"], dim=-1)


def observe(st: dict, env: dict, models: dict):
    """Eq. (21): [h, requested model, rho, d_in, d_op], normalised."""
    h_n = (torch.log10(st["h"] + 1e-30) + 12.0) / 5.0
    req_n = st["req"].to(torch.float32) / env["M"]
    din_n = st["d_in"] / (env["d_in_mb"][1] * MB_BITS)
    dop_n = _take(models["d_op"], st["req"]) / (env["d_op_mb"][1] * MB_BITS)
    return torch.cat([h_n, req_n, st["rho"], din_n, dop_n], dim=-1)


def amend_actions(raw, req, rho, U: int, b_floor: float = 0.01):
    """The action amender: raw [0,1]^{2U} onto the bandwidth simplex
    (11e) and the cache-gated compute simplex (11f)-(11g)."""
    b_t, xi_t = raw[..., :U] + b_floor, raw[..., U:]
    b = b_t / (torch.sum(b_t, dim=-1, keepdim=True) + 1e-9)
    gate = torch.gather(rho, -1, req)
    xi = xi_t * gate / (torch.sum(gate * xi_t, dim=-1, keepdim=True) + 1e-9)
    return b, xi


def compute_norm(raw, req, rho, U: int):
    """Per cell, the compute simplex's normaliser in ``amend_actions``,
    sum_u gate_u xi_t_u: (...,).  Where it is small, xi is a ratio of
    small numbers that the rounding of the chain's output moves."""
    return torch.sum(torch.gather(rho, -1, req) * raw[..., U:], dim=-1)


def amend_caching(a_int, M: int):
    """rho_m = floor(a / 2^(M-m)) mod 2 (the paper's amender)."""
    m = torch.arange(1, M + 1, device=a_int.device)
    return (torch.div(a_int[..., None], 2 ** (M - m), rounding_mode="floor")
            % 2).to(torch.float32)
