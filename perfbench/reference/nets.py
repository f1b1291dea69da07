"""Plain networks, reverse chain and optimiser of the T2DRL learners.

Plain PyTorch in float32 with TF32 off, written from the paper's
equations (Secs. 5.2 and 6.2) in the operation order of the program's
own plain arithmetic, so the two agree to rounding.  Networks are lists
of weights ``w`` (in, out) and biases ``b`` (out,) applied as ``x @ w +
b`` with ReLU between layers; a leading learner axis (B, in, out) runs B
learners at once.

``mm`` is the matrix product every function takes: ``torch.matmul`` for
the reference, or ``tf32_matmul``, whose operands are first rounded to
TF32's 10-bit mantissa: the control, one precision below the
configuration's float32, the same on the card and on the CPU.
"""
from __future__ import annotations

import math

import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to the nearest TF32 value (10 mantissa bits),
    ties to even."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """A product whose operands, forward and backward, are rounded to
    TF32 first, as a TF32 matrix unit rounds them; f32 accumulation."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(tf32(a), tf32(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32(g)
        return (torch.matmul(g, tf32(b).transpose(-1, -2)),
                torch.matmul(tf32(a).transpose(-1, -2), g))


def tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _TF32MatMul.apply(a, b)


def mlp(ws, bs, x, mm=torch.matmul):
    """ReLU between layers, none after the last.  x (..., in), or
    (B, ..., in) against stacked layers (B, in, out)."""
    n = len(ws)
    for k, (w, b) in enumerate(zip(ws, bs)):
        if w.dim() == 3:
            lead = x.shape[1:-1]
            y = mm(x.reshape(x.shape[0], -1, x.shape[-1]), w)
            x = y.reshape((x.shape[0],) + lead + (w.shape[-1],)) + b.reshape(
                (b.shape[0],) + (1,) * len(lead) + (b.shape[-1],))
        else:
            x = mm(x, w) + b
        if k < n - 1:
            x = torch.relu(x)
    return x


def time_embedding(steps: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding of the denoising step numbers: (..., dim)."""
    half = dim // 2
    freqs = torch.exp(-math.log(1000.0)
                      * torch.arange(half, device=steps.device) / half)
    ang = steps.to(torch.float32)[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def paper_schedule(L: int, beta_min: float, beta_max: float) -> dict:
    """The exponential VP schedule of Sec. 5.2.1 in f32 on the host,
    beta_l = 1 - exp(-beta_min/L - (2l-1)/(2L^2)(beta_max-beta_min)), and
    each step's update coefficients [c1, c2, sigma] (sigma exactly 0 at
    the last step) as Python floats."""
    f32 = torch.float32
    l = torch.arange(1, L + 1, dtype=f32)
    betas = 1.0 - torch.exp(-beta_min / L - (2 * l - 1) / (2 * L ** 2)
                            * (beta_max - beta_min))
    alphas = 1.0 - betas
    abars = torch.cumprod(alphas, dim=0)
    prev = torch.cat([torch.ones(1, dtype=f32), abars[:-1]])
    btil = (1.0 - prev) / (1.0 - abars) * betas
    coef = []
    for k, (a, ab, bt) in enumerate(zip(alphas.tolist(), abars.tolist(),
                                        btil.tolist())):
        c1 = 1.0 / math.sqrt(a)
        c2 = (1.0 - a) / (math.sqrt(1.0 - ab) * math.sqrt(a))
        coef.append((c1, c2, math.sqrt(bt) if k > 0 else 0.0))
    return {"L": L, "coef": coef}


def reverse_chain(ws, bs, sched: dict, state, x_L, noises, te,
                  mm=torch.matmul):
    """x_0 of the reverse chain (Eqs. 17-20): for l = L .. 1,
    eps_hat = net([x, state, te_l]) and x <- c1 x - c2 eps_hat + sigma
    noise, noises consumed in chain order.  ``te``: (L, T) embeddings of
    steps 1..L.  Stacked weights take state (B, ..., S), x_L (B, ..., A),
    noises (B, L, ..., A)."""
    L = sched["L"]
    stacked = ws[0].dim() == 3
    x = x_L
    for i in range(L):
        l_rev = L - 1 - i
        c1, c2, sigma = sched["coef"][l_rev]
        t = te[l_rev].expand(x.shape[:-1] + te.shape[-1:])
        eps = mlp(ws, bs, torch.cat([x, state, t], dim=-1), mm)
        noise = noises[:, i] if stacked else noises[i]
        x = c1 * x - c2 * eps + sigma * noise
    return x


def actions_from_chain(x0):
    """Raw actions in [0, 1]: 0.5 (tanh(x_0) + 1)."""
    return 0.5 * (torch.tanh(x0) + 1.0)


def adam_step(params, grads, mu, nu, step: int, lr, b1=0.9, b2=0.999,
              eps=1e-8):
    """One Adam step on lists of tensors, returning new ones: moments
    ``mu' = b1 mu + (1 - b1) g``, ``nu' = b2 nu + ((1 - b2) g) g``, bias
    corrections ``1 - b ** step`` in f32, ``p' = p - lr (mu'/b1c) /
    (sqrt(nu'/b2c) + eps)``.  ``lr`` a number or a (B,) tensor."""
    import numpy as np
    f32 = np.float32
    b1c = float(f32(1.0) - f32(b1) ** f32(step))
    b2c = float(f32(1.0) - f32(b2) ** f32(step))
    out_p, out_m, out_v = [], [], []
    for p, g, m, v in zip(params, grads, mu, nu):
        m = m * b1 + g * (1 - b1)
        v = v * b2 + (g * (1 - b2)) * g
        lr_p = (lr.reshape(lr.shape + (1,) * (p.dim() - 1))
                if torch.is_tensor(lr) else lr)
        delta = (m / b1c) * lr_p / (torch.sqrt(v / b2c) + eps)
        out_p.append(p - delta)
        out_m.append(m)
        out_v.append(v)
    return out_p, out_m, out_v


def soft_update(target, online, rate: float):
    """Polyak averaging ``target + rate (online - target)``, new tensors."""
    return [torch.lerp(t, o, rate) for t, o in zip(target, online)]
