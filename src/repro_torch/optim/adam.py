"""Adam/AdamW with dtype-configurable moments and global-norm clipping
(port of ``repro.optim.adam``).

Written out by hand on ``torch._foreach_*`` passes, not with
``torch.optim.Adam``, whose arithmetic is not the reference's: here
``eps`` is added after ``sqrt(nu / b2c)``, weight decay is decoupled
(added to the step, as AdamW), the gradients are clipped on their global
norm before the moments, the bias corrections are ``1 - b ** step`` in
f32, and the moments may be kept in bf16.

``params`` and ``grads`` are an ``nn.Module`` (its ``parameters()``, in
order) or a sequence of tensors.  The ``*_stacked`` functions step B
learners' stacked parameters (a leading (B,) axis on every leaf) at once,
with per-learner learning rates.  Unlike the pure JAX update, this one
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


# -- B stacked learners (DESIGN.md §13) ---------------------------------------
#
# Every parameter and moment carries a leading (B,) learner axis (a
# ``StackedMLP``'s layers); the step counter is one host int, since the
# fused learners take their updates together.  One pass per leaf advances
# all B learners; per-learner values (lr, the clip scale) broadcast over a
# leaf's trailing axes.


def _per_learner(v, ndim: int):
    """A per-learner (B,) tensor shaped to broadcast against a (B, ...)
    leaf of rank ``ndim``; a number passes through."""
    if not torch.is_tensor(v) or v.dim() == 0:
        return v
    return v.reshape(v.shape + (1,) * (ndim - 1))


def global_norm_stacked(tree) -> torch.Tensor:
    """Per-learner global norms (B,), f32: each leaf's sum of squares over
    its non-learner axes, summed over the leaves in order, then sqrt."""
    total = None
    for x in _leaves(tree):
        x = x.detach().float()
        s = torch.sum(torch.square(x).reshape(x.shape[0], -1), dim=1)
        total = s if total is None else total + s
    return torch.sqrt(total)


def adam_init_stacked(params, *, moment_dtype=torch.float32) -> dict:
    """Zero moments for stacked (B-leading) parameters; ``step`` 0."""
    return adam_init(params, moment_dtype=moment_dtype)


@torch.no_grad()
def adam_update_stacked(grads, state, params, *, lr, b1: float = 0.9,
                        b2: float = 0.999, eps: float = 1e-8,
                        weight_decay: float = 0.0, max_norm: float = 0.0):
    """B independent Adam steps in one pass per leaf, in place, with the
    single-learner arithmetic.  ``lr`` is a number or a per-learner (B,)
    tensor on the parameters' device (the population lever).  Returns
    ``(params, state, {"gnorm": (B,)})``."""
    ps, mus, nus = _leaves(params), state["mu"], state["nu"]
    gs = [g.float() for g in _leaves(grads)]
    gnorm = global_norm_stacked(gs)
    if max_norm:
        scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
        gs = [g * _per_learner(scale, g.dim()) for g in gs]
    step = state["step"] + 1
    f32 = np.float32
    b1c = float(f32(1.0) - f32(b1) ** f32(step))
    b2c = float(f32(1.0) - f32(b2) ** f32(step))
    mu = [m.float() for m in mus]
    nu = [v.float() for v in nus]
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, torch._foreach_mul(gs, 1 - b1))
    torch._foreach_mul_(nu, b2)
    g2 = torch._foreach_mul(gs, 1 - b2)
    torch._foreach_mul_(g2, gs)
    torch._foreach_add_(nu, g2)
    delta = torch._foreach_div(mu, b1c)
    lrs = [_per_learner(lr, p.dim()) for p in ps]
    if torch.is_tensor(lr) and lr.dim():
        torch._foreach_mul_(delta, lrs)
    else:
        torch._foreach_mul_(delta, lr)
    den = torch._foreach_div(nu, b2c)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    torch._foreach_div_(delta, den)
    pf = [p.float() for p in ps]
    if weight_decay:
        torch._foreach_add_(delta, [p * (l * weight_decay)
                                    for p, l in zip(pf, lrs)])
    torch._foreach_sub_(pf, delta)
    for dst, src in ((ps, pf), (mus, mu), (nus, nu)):
        for d, s in zip(dst, src):
            if d is not s:
                d.copy_(s)
    return params, {"mu": mus, "nu": nus, "step": step}, {"gnorm": gnorm}


def stack_adam(states) -> dict:
    """B learners' Adam states -> one stacked state (copies); their steps
    must agree (the stacked learners step together)."""
    states = list(states)
    steps = {st["step"] for st in states}
    if len(steps) != 1:
        raise ValueError(f"stacked learners step together; got steps "
                         f"{sorted(steps)}")
    return {k: [torch.stack(m) for m in zip(*(st[k] for st in states))]
            for k in ("mu", "nu")} | {"step": steps.pop()}


def adam_learner(state: dict, b: int) -> dict:
    """Learner b's Adam state: views of the stacked moments."""
    return {"mu": [m[b] for m in state["mu"]],
            "nu": [v[b] for v in state["nu"]], "step": state["step"]}


def learner_values(v, B: int, device):
    """A per-learner value as the stacked math takes it: a number stays a
    number; a sequence or tensor of B becomes a (B,) f32 tensor."""
    if v is None or isinstance(v, (int, float)):
        return v
    t = torch.as_tensor(v, dtype=torch.float32, device=device)
    if t.dim() == 0:
        return t
    if t.shape != (B,):
        raise ValueError(f"per-learner value of shape {tuple(t.shape)} for "
                         f"{B} learners")
    return t
