"""Adam/AdamW with dtype-configurable moments and global-norm clipping
(port of ``repro.optim.adam``).

Written out by hand on ``torch._foreach_*`` passes, not with
``torch.optim.Adam``, whose arithmetic is not the reference's: here
``eps`` is added after ``sqrt(nu / b2c)``, weight decay is decoupled
(added to the step, as AdamW), the gradients are clipped on their global
norm before the moments, the bias corrections are ``1 - b ** step`` in
f32, and the moments may be kept in bf16.

``params`` and ``grads`` are an ``nn.Module`` (its ``parameters()``, in
order) or a sequence of tensors.  Unlike the pure JAX update, this one
works in place: the parameters and the moments are overwritten and the
same tensors come back, so no second copy of either is made.  ``step``
is a host int, read by the bias corrections without a device read.
"""
from __future__ import annotations

import numpy as np
import torch


def _leaves(tree) -> list:
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for t in tree for x in _leaves(t)]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (0-dim tensor)."""
    xs = [x.detach().float() for x in _leaves(tree)]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(xs)))


def clip_by_global_norm(grads, max_norm: float):
    """``(grads * min(1, max_norm / (norm + 1e-9)), norm)``: new tensors."""
    gs = [g.float() for g in _leaves(grads)]
    norm = global_norm(gs)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return torch._foreach_mul(gs, scale), norm


def adam_init(params, *, moment_dtype=torch.float32) -> dict:
    """``{"mu": [...], "nu": [...], "step": 0}``: zero moments of
    ``moment_dtype`` beside each parameter, on its device."""
    ps = _leaves(params)
    zeros = lambda p: torch.zeros_like(p, dtype=moment_dtype,  # noqa: E731
                                       memory_format=torch.contiguous_format)
    return {"mu": [zeros(p) for p in ps], "nu": [zeros(p) for p in ps],
            "step": 0}


@torch.no_grad()
def adam_update(grads, state, params, *, lr, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8,
                weight_decay: float = 0.0, max_norm: float = 0.0):
    """One Adam step, in place.  Returns ``(params, state, {"gnorm"})``:
    the same parameter container, overwritten; the state with its moments
    overwritten and ``step`` advanced; the gradients' global norm before
    clipping (0-dim tensor)."""
    ps, mus, nus = _leaves(params), state["mu"], state["nu"]
    gs = [g.float() for g in _leaves(grads)]
    gnorm = global_norm(gs)
    if max_norm:
        gs = torch._foreach_mul(
            gs, torch.clamp(max_norm / (gnorm + 1e-9), max=1.0))
    step = state["step"] + 1
    f32 = np.float32
    b1c = float(f32(1.0) - f32(b1) ** f32(step))
    b2c = float(f32(1.0) - f32(b2) ** f32(step))
    mu = [m.float() for m in mus]
    nu = [v.float() for v in nus]
    # mu' = b1 mu + (1 - b1) g;  nu' = b2 nu + ((1 - b2) g) g
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, torch._foreach_mul(gs, 1 - b1))
    torch._foreach_mul_(nu, b2)
    g2 = torch._foreach_mul(gs, 1 - b2)
    torch._foreach_mul_(g2, gs)
    torch._foreach_add_(nu, g2)
    # delta = lr (mu' / b1c) / (sqrt(nu' / b2c) + eps) [+ lr wd p]
    delta = torch._foreach_div(mu, b1c)
    torch._foreach_mul_(delta, lr)
    den = torch._foreach_div(nu, b2c)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    torch._foreach_div_(delta, den)
    pf = [p.float() for p in ps]
    if weight_decay:
        torch._foreach_add_(delta, torch._foreach_mul(pf, lr * weight_decay))
    torch._foreach_sub_(pf, delta)
    for dst, src in ((ps, pf), (mus, mu), (nus, nu)):
        for d, s in zip(dst, src):
            if d is not s:
                d.copy_(s)
    return params, {"mu": mus, "nu": nus, "step": step}, {"gnorm": gnorm}


def _stacked(name: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"{name}: the stacked (B-learner) Adam is not ported yet; it "
            "comes with the vector-env modes (ROADMAP queue A, item 6)")
    fn.__name__ = name
    fn.__doc__ = f"Not ported yet (ROADMAP A.6): ``repro.optim.{name}``."
    return fn


adam_init_stacked = _stacked("adam_init_stacked")
adam_update_stacked = _stacked("adam_update_stacked")
global_norm_stacked = _stacked("global_norm_stacked")
