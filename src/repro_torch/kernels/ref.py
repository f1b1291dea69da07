"""Plain PyTorch versions of the hand-written kernels.

The CPU tests and ``chip_smoke.py`` hold the kernels against these.
``ddpm_step_ref`` repeats its kernel's arithmetic op for op, so on the card
the two agree bit for bit; the chain's MLP and its backward, attention and
the SSD scan sum in another order than their kernels and agree to a
tolerance.  The chain and its backward have stacked versions beside them
(``*_stacked_ref``: B learners' weights with a leading axis, batched
products), which the CPU path of a stacked chain runs.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, scale=None):
    """q: (B, L, H, D); k: (B, S, Hkv, D), v: (B, S, Hkv, DV) with H %
    Hkv == 0.  Returns (B, L, H, DV) in q.dtype; scores, softmax and the
    weighted sum in f32 (the oracle of
    ``repro.kernels.ref.flash_attention_ref``); ``scale`` defaults to
    1/sqrt(D)."""
    B, L, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = scale or 1.0 / math.sqrt(D)
    qg = q.float().reshape(B, L, Hkv, G, D)
    s = torch.einsum("blkgd,bskd->bkgls", qg, k.float()) * scale
    qpos = torch.arange(L, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    m = torch.ones((L, S), dtype=torch.bool, device=q.device)
    if causal:
        m &= kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    s = torch.where(m, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgls,bskd->blkgd", p, v.float())
    return o.reshape(B, L, H, v.shape[3]).to(q.dtype)


def ssd_scan_ref(x, dt, A, Bm, Cm, D, *, chunk: int = 128):
    """Chunked SSD; returns (y, final state).  Delegates to the layer's
    reference ``nn.ssm.ssd_reference`` (held against a step-by-step
    recurrence in the tests), as the JAX oracle does."""
    from repro_torch.nn.ssm import ssd_reference
    return ssd_reference(x, dt, A, Bm, Cm, D, chunk=chunk,
                         return_state=True)


def _math_dtype(dtype):
    """f32 math for f32 and bf16 (the kernels'), f64 for f64 (gradcheck)."""
    return torch.promote_types(dtype, torch.float32)


def ddpm_step_ref(x, eps_hat, noise, c1: float, c2: float, sigma: float):
    """One fused reverse-diffusion update (Eqs. 19-20) with the scalars
    precomputed: ``x' = c1*x - c2*eps_hat + sigma*noise``, in f32 (f64
    for f64 inputs), cast back to ``x.dtype``.  See
    ``ops.ddpm_coefficients`` for c1, c2, sigma."""
    md = _math_dtype(x.dtype)
    xf, ef, nf = x.to(md), eps_hat.to(md), noise.to(md)
    return (c1 * xf - c2 * ef + sigma * nf).to(x.dtype)


def ddpm_step_bwd_ref(g, c1: float, c2: float):
    """The backward of ``ddpm_step_ref`` in ``x`` and ``eps_hat``:
    ``(c1 * g, -c2 * g)``, each one product in f32 (f64 for f64), cast
    back to ``g.dtype``; the noise gets no gradient."""
    gf = g.to(_math_dtype(g.dtype))
    return (c1 * gf).to(g.dtype), ((-c2) * gf).to(g.dtype)


def ddpm_chain_ref(net, x_L, state, noises, coef, te, *, record=False):
    """A whole reverse chain as the sampler's step loop runs it: for
    l_rev = L-1 .. 0, ``eps_hat = net([x, state, te[l_rev]])`` and
    ``ddpm_step_ref`` with ``coef[l_rev]`` = [c1, c2, sigma] and
    ``noises[L-1-l_rev]``.  Returns x_0, before the sampler's tanh; with
    ``record`` also the (L, R, A + hidden widths) record of every step's x
    and hidden outputs after their ReLU, as the kernel writes it."""
    L = coef.shape[0]
    coefs = coef.tolist()
    n = len(net.w)
    x, rec = x_L, []
    for i in range(L):
        l_rev = L - 1 - i
        t = te[l_rev].expand(x.shape[:-1] + te.shape[-1:])
        h, hs = torch.cat([x, state, t], dim=-1), [x]
        for k, (w, b) in enumerate(zip(net.w, net.b)):      # net's forward
            h = h @ w + b
            if k < n - 1:
                h = torch.relu(h)
                hs.append(h)
        if record:
            rec.append(torch.cat(hs, dim=-1))
        x = ddpm_step_ref(x, h, noises[i], *coefs[l_rev])
    return (x, torch.stack(rec)) if record else x


def ddpm_chain_bwd_ref(net, record, state, coef, te, g):
    """The backward of ``ddpm_chain_ref`` in the MLP's weights and biases,
    as an explicit loop over l_rev = 0 .. L-1 from its ``record``:
    ``delta = -c2 g``; per layer from the top ``dW += h^T delta``,
    ``db += sum(delta)`` and ``delta = (delta W^T) * (h > 0)``; into x
    ``g = c1 g + delta W_0[:A]^T``.  Returns ``(dws, dbs)`` in f32 (f64
    for f64 inputs)."""
    ws, bs = list(net.w), list(net.b)
    n, L, A = len(ws), coef.shape[0], g.shape[-1]
    md = _math_dtype(g.dtype)
    wm = [w.to(md) for w in ws]
    dws = [torch.zeros(w.shape, dtype=md, device=g.device) for w in ws]
    dbs = [torch.zeros(b.shape, dtype=md, device=g.device) for b in bs]
    coefs = coef.tolist()
    cols = [A] + [w.shape[1] for w in ws[:-1]]     # x, then hidden outputs
    g, state = g.to(md), state.to(md)
    for i in reversed(range(L)):
        l_rev = L - 1 - i
        c1, c2, _ = coefs[l_rev]
        parts = torch.split(record[i].to(md), cols, dim=-1)
        t = te[l_rev].to(md).expand(g.shape[0], -1)
        hs = [torch.cat([parts[0], state, t], dim=-1), *parts[1:]]
        d = (-c2) * g
        for l in reversed(range(n)):
            dws[l] += hs[l].T @ d
            dbs[l] += d.sum(0)
            if l > 0:
                d = (d @ wm[l].T) * (hs[l] > 0)
            elif i > 0:
                g = c1 * g + d @ wm[0][:A].T
    return ([d.to(w.dtype) for d, w in zip(dws, ws)],
            [d.to(b.dtype) for d, b in zip(dbs, bs)])


def ddpm_chain_stacked_ref(net, x_L, state, noises, coef, te, *,
                           record=False):
    """``ddpm_chain_ref`` for B stacked learners in batched products: every
    ``w`` (B, in, out), ``b`` (B, out); x_L (B, R, A), state (B, R, S),
    noises (B, L, R, A), each learner's chain on its own weights and rows.
    Returns x_0 (B, R, A); with ``record`` also the (B, L, R, A + hidden
    widths) record, as the stacked kernel writes it."""
    L = coef.shape[0]
    coefs = coef.tolist()
    n = len(net.w)
    x, rec = x_L, []
    for i in range(L):
        l_rev = L - 1 - i
        t = te[l_rev].expand(x.shape[:-1] + te.shape[-1:])
        h, hs = torch.cat([x, state, t], dim=-1), [x]
        for k, (w, b) in enumerate(zip(net.w, net.b)):
            h = torch.bmm(h, w) + b[:, None, :]
            if k < n - 1:
                h = torch.relu(h)
                hs.append(h)
        if record:
            rec.append(torch.cat(hs, dim=-1))
        x = ddpm_step_ref(x, h, noises[:, i], *coefs[l_rev])
    return (x, torch.stack(rec, dim=1)) if record else x


def ddpm_chain_bwd_stacked_ref(net, record, state, coef, te, g):
    """``ddpm_chain_bwd_ref`` for B stacked learners in batched products:
    record (B, L, R, W), state (B, R, S), g (B, R, A); returns each
    learner's ``(dws, dbs)``, (B, in, out) and (B, out), never summed
    across learners."""
    ws, bs = list(net.w), list(net.b)
    n, L, A = len(ws), coef.shape[0], g.shape[-1]
    md = _math_dtype(g.dtype)
    wm = [w.to(md) for w in ws]
    dws = [torch.zeros(w.shape, dtype=md, device=g.device) for w in ws]
    dbs = [torch.zeros(b.shape, dtype=md, device=g.device) for b in bs]
    coefs = coef.tolist()
    cols = [A] + [w.shape[-1] for w in ws[:-1]]
    g, state = g.to(md), state.to(md)
    for i in reversed(range(L)):
        l_rev = L - 1 - i
        c1, c2, _ = coefs[l_rev]
        parts = torch.split(record[:, i].to(md), cols, dim=-1)
        t = te[l_rev].to(md).expand(g.shape[:-1] + te.shape[-1:])
        hs = [torch.cat([parts[0], state, t], dim=-1), *parts[1:]]
        d = (-c2) * g
        for l in reversed(range(n)):
            dws[l] += torch.bmm(hs[l].transpose(1, 2), d)
            dbs[l] += d.sum(1)
            if l > 0:
                d = torch.bmm(d, wm[l].transpose(1, 2)) * (hs[l] > 0)
            elif i > 0:
                g = c1 * g + torch.bmm(d, wm[0][:, :A].transpose(1, 2))
    return ([d.to(w.dtype) for d, w in zip(dws, ws)],
            [d.to(b.dtype) for d, b in zip(dbs, bs)])
