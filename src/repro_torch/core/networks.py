"""Plain MLPs for the denoiser and Q networks (paper Sec. 7.1 topology).

Weights keep the JAX layout — ``w: (in, out)``, ``b: (out,)``, applied as
``x @ w + b`` — so trees cross over from ``repro.core.networks`` as they
are (:mod:`repro_torch.bridge`).

B independent learners (the fused vector-env path, DESIGN.md §13) keep
their MLPs as one ``StackedMLP``: one tensor per layer with a leading
learner axis, ``w: (B, in, out)``, ``b: (B, out)``, applied as one batched
product per layer (``stacked_linear``), so the chain kernel reads every
learner's weights with one stride.  ``MLP.learner``-style per-learner views
(``StackedMLP.learner(b)``) share the stack's storage.
"""
from __future__ import annotations

import math

import torch
from torch import nn


class MLP(nn.Module):
    """ReLU between layers, none after the last (``mlp_apply``)."""

    def __init__(self, ws, bs):
        super().__init__()
        self.w = nn.ParameterList(nn.Parameter(w) for w in ws)
        self.b = nn.ParameterList(nn.Parameter(b) for b in bs)

    def forward(self, x, final_act=None):
        n = len(self.w)
        for i, (w, b) in enumerate(zip(self.w, self.b)):
            x = x @ w + b
            if i < n - 1:
                x = torch.relu(x)
        return x if final_act is None else final_act(x)


def mlp_init(dims, generator: torch.Generator) -> MLP:
    """``w ~ N(0, 1/in)``, zero bias (the JAX init distribution), drawn on
    the generator's device."""
    dev = generator.device
    ws = [torch.randn(i, o, generator=generator, device=dev) / math.sqrt(i)
          for i, o in zip(dims[:-1], dims[1:])]
    bs = [torch.zeros(o, device=dev) for o in dims[1:]]
    return MLP(ws, bs)


def mlp_apply(mlp: MLP, x, *, final_act=None):
    return mlp(x, final_act=final_act)


@torch.no_grad()
def soft_update(target: nn.Module, online: nn.Module, rate: float):
    """Polyak averaging, Eqs. (28)-(29)/(35): ``target <- target +
    rate * (online - target)``, in place (one ``lerp`` over every
    parameter; stacked modules too, every learner at once); returns
    ``target``."""
    torch._foreach_lerp_(list(target.parameters()),
                         list(online.parameters()), rate)
    return target


class StackedMLP(nn.Module):
    """B MLPs of the same widths as one module: ``w[l]`` (B, in, out),
    ``b[l]`` (B, out); ``forward`` maps (B, ..., in) to (B, ..., out)."""

    def __init__(self, ws, bs):
        super().__init__()
        self.w = nn.ParameterList(nn.Parameter(w) for w in ws)
        self.b = nn.ParameterList(nn.Parameter(b) for b in bs)

    @property
    def learners(self) -> int:
        return self.w[0].shape[0]

    def forward(self, x, final_act=None):
        n = len(self.w)
        for i, (w, b) in enumerate(zip(self.w, self.b)):
            x = stacked_linear(x, w, b)
            if i < n - 1:
                x = torch.relu(x)
        return x if final_act is None else final_act(x)

    def learner(self, b: int) -> MLP:
        """Learner b's MLP, its parameters views of this stack's (an
        in-place update of either is seen by both)."""
        mlp = MLP([], [])
        mlp.w = nn.ParameterList(_view_param(w, b) for w in self.w)
        mlp.b = nn.ParameterList(_view_param(x, b) for x in self.b)
        return mlp


def _view_param(p, b: int):
    """``p[b]`` as a Parameter sharing ``p``'s storage, with ``p``'s
    ``requires_grad``."""
    return nn.Parameter(p.data[b], requires_grad=p.requires_grad)


def stack_mlps(mlps) -> StackedMLP:
    """B MLPs of the same widths -> one ``StackedMLP`` (copies)."""
    mlps = list(mlps)
    ws = [torch.stack([m.w[i].detach() for m in mlps])
          for i in range(len(mlps[0].w))]
    bs = [torch.stack([m.b[i].detach() for m in mlps])
          for i in range(len(mlps[0].b))]
    out = StackedMLP(ws, bs)
    return out.requires_grad_(mlps[0].w[0].requires_grad)


def stacked_linear(x, w, b):
    """``x @ w + b`` with a leading learner axis: x (B, ..., i), w
    (B, i, o), b (B, o) -> (B, ..., o), one batched product for all B
    learners."""
    B, i = x.shape[0], x.shape[-1]
    xb = x.reshape(B, -1, i)
    if B == 1:
        # BLAS runs a lone product one column wide (the critic's head) as
        # a matrix-vector product, which rounds other than the batched
        # one; a learner's numbers must not depend on how many learners
        # share the call (one cell a rank, run_training_sharded), so a
        # lone learner runs batched, beside a copy whose output is unused
        # (its gradient is zero, and adds exactly)
        y = torch.bmm(xb.expand(2, -1, -1), w.expand(2, -1, -1))[:1]
    else:
        y = torch.bmm(xb, w)
    return y.reshape(x.shape[:-1] + (w.shape[-1],)) + b.reshape(
        (B,) + (1,) * (x.dim() - 2) + (w.shape[-1],))


def mlp_init_stacked(dims, generators) -> StackedMLP:
    """B MLPs, learner b drawn from ``generators[b]`` exactly as
    ``mlp_init`` draws one (so learner b is the MLP that ``mlp_init`` gives
    from that generator)."""
    return stack_mlps(mlp_init(dims, g) for g in generators)


def mlp_apply_stacked(mlp: StackedMLP, x, *, final_act=None):
    """``mlp_apply`` over B stacked learners: x (B, ..., in)."""
    return mlp(x, final_act=final_act)
