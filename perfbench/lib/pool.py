"""The controller's traffic: one frame of slot states for C cells.

Drawn from the environment's distributions (paper Secs. 3.1-3.3 and
7.1, over a configuration file's ``env`` group) in a few large calls on
one seeded generator: each cell's model zoo, its popularity state after
one Markov step from a uniform start, and for each of the frame's K
slots its location state (a Markov chain from a uniform start),
positions, Rayleigh-faded channel gains, Zipf requests and input sizes.
The same seed gives the same frame.
"""
from __future__ import annotations

import torch

MB_BITS = 8e6


def _gumbel_argmax(g, logits):
    u = torch.rand(logits.shape, generator=g, device=logits.device)
    tiny = torch.finfo(torch.float32).tiny
    return torch.argmax(logits - torch.log(-torch.log(u.clamp_min(tiny))),
                        dim=-1)


def _uniform(g, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)


def frame(env: dict, C: int, seed: int, device) -> dict:
    """``{"models": {a1..d_op: (C, M)}, "gamma_idx": (C,), "slots": [K
    dicts of lambda_idx (C,), pos (C, U, 2), h (C, U), req (C, U), d_in
    (C, U)]}``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    U, M, K, A = env["U"], env["M"], env["K"], env["area"]
    f32 = dict(dtype=torch.float32, device=device)
    lo_hi = {"a1": (50.0, 100.0), "a2": (100.0, 150.0), "a3": (150.0, 200.0),
             "a4": (1.0, 50.0), "b1": (0.05, 0.5), "b2": (1.0, 10.0),
             "c": (2.0, 10.0), "d_op": tuple(env["d_op_mb"])}
    models = {k: _uniform(g, (C, M), lo, hi, device)
              for k, (lo, hi) in lo_hi.items()}
    models["d_op"] = models["d_op"] * MB_BITS
    log_pg = torch.log(torch.tensor(env["P_gamma"], **f32) + 1e-12)
    log_pl = torch.log(torch.tensor(env["P_lambda"], **f32) + 1e-12)
    J, I = log_pg.shape[0], log_pl.shape[0]
    gamma = _gumbel_argmax(g, log_pg[torch.randint(0, J, (C,), generator=g,
                                                   device=device)])
    gammas = torch.tensor(env["gammas"], **f32)
    zipf = -gammas[gamma][:, None] * torch.log(
        torch.arange(1, M + 1, **f32))[None, :]
    bs = torch.tensor([A / 2, A / 2], **f32)
    lam = torch.randint(0, I, (C,), generator=g, device=device)
    slots = []
    for _ in range(K):
        lam = _gumbel_argmax(g, log_pl[lam])
        uni = _uniform(g, (C, U, 2), 0.0, A, device)
        conc = torch.clamp(A / 2 + 30.0 * torch.randn(
            (C, U, 2), generator=g, device=device), 0.0, A)
        edge = _uniform(g, (C, U, 2), 0.0, A, device)
        side = torch.randint(0, 4, (C, U), generator=g, device=device)
        off = _uniform(g, (C, U), 0.0, 15.0, device)
        bx = torch.where(side == 0, off,
                         torch.where(side == 1, A - off, edge[..., 0]))
        by = torch.where(side == 2, off,
                         torch.where(side == 3, A - off, edge[..., 1]))
        la = lam[:, None, None]
        pos = torch.where(la == 0, uni, torch.where(
            la == 1, conc, torch.stack([bx, by], dim=-1)))
        dis_km = torch.clamp_min(torch.linalg.norm(pos - bs, dim=-1),
                                 1.0) / 1000.0
        gain = 10.0 ** ((-128.1 - 37.6 * torch.log10(dis_km)) / 10.0)
        ray = torch.empty((C, U), **f32).exponential_(1.0, generator=g)
        req = _gumbel_argmax(g, zipf[:, None, :].expand(C, U, M))
        d_in = _uniform(g, (C, U), env["d_in_mb"][0], env["d_in_mb"][1],
                        device) * MB_BITS
        slots.append({"lambda_idx": lam, "pos": pos, "h": gain * ray,
                      "req": req, "d_in": d_in})
    return {"models": models, "gamma_idx": gamma, "slots": slots}
