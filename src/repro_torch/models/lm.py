"""CompositeLM: a decoder-only LM assembled from groups of block cycles
(port of ``repro.models.lm``).

A group is ``repeats`` × ``cycle`` (a tuple of BlockCfg).  Parameters of a
block that is not ``shared`` are stacked with a leading repeat axis, as in
the JAX tree; the JAX ``lax.scan`` over repeats is a Python loop over that
axis here.  A ``shared`` block keeps one parameter set for every repeat
while its caches stay per repeat.  The cache is a list (one per group) of
dicts (one per stateful block of the cycle) whose leaves carry the repeat
axis first.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): the VLM prefix projector, multi-token prediction, learned
positions and an untied LM head.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.nn import core

from . import blocks
from .blocks import (BlockCfg, block_decode, block_forward, block_init,
                     block_init_cache, block_prefill)


@dataclasses.dataclass(frozen=True)
class GroupCfg:
    cycle: Tuple[BlockCfg, ...]
    repeats: int


@dataclasses.dataclass(frozen=True)
class LMCfg:
    name: str
    vocab: int
    d_model: int
    groups: Tuple[GroupCfg, ...]
    final_norm: str = "rms"
    tie_embeddings: bool = True
    pos_embed: str = "none"        # "none" (rope inside attention)
    max_positions: int = 0
    n_prefix: int = 0
    prefix_embed_dim: int = 0      # VLM (not ported)
    mtp: bool = False              # multi-token prediction (not ported)
    remat: bool = False            # training only; ignored here
    unroll: bool = False           # the port always loops in Python

    @property
    def n_layers(self) -> int:
        return sum(g.repeats * len(g.cycle) for g in self.groups)


def check_ported(cfg: LMCfg) -> None:
    """Raise ``NotImplementedError`` for what the port does not have yet,
    naming the ROADMAP item."""
    todo = []
    if cfg.prefix_embed_dim:
        todo.append("the VLM prefix projector")
    if cfg.mtp:
        todo.append("multi-token prediction")
    if cfg.pos_embed != "none":
        todo.append("learned positions")
    if not cfg.tie_embeddings:
        todo.append("an untied LM head")
    if todo:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(todo)} not ported yet (ROADMAP queue "
            "A: the remaining architectures)")
    for g in cfg.groups:
        for b in g.cycle:
            blocks.check_ported(b)


def tree_map(fn, *trees):
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, list):
        return [tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def _index(tree, r: int):
    return tree_map(lambda a: a[r], tree)


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


# -- init --------------------------------------------------------------------------

def _group_init(generator, g: GroupCfg, *, dtype):
    shared, stacked = {}, {}
    for i, bcfg in enumerate(g.cycle):
        if bcfg.shared:
            shared[str(i)] = block_init(generator, bcfg, dtype=dtype)
        else:
            stacked[str(i)] = _stack([block_init(generator, bcfg, dtype=dtype)
                                      for _ in range(g.repeats)])
    return {"shared": shared, "stacked": stacked}


def lm_init(generator: torch.Generator, cfg: LMCfg, *,
            dtype=torch.float32) -> dict:
    """Random parameters from ``generator``, on its device, in the JAX
    tree layout (``embed.table``, ``groups[i].shared / .stacked``,
    ``final_norm``)."""
    check_ported(cfg)
    dev = generator.device
    p = {"embed": core.embedding_init(generator, cfg.vocab, cfg.d_model,
                                      dtype=dtype),
         "groups": [_group_init(generator, g, dtype=dtype)
                    for g in cfg.groups]}
    if cfg.final_norm == "rms":
        p["final_norm"] = core.rmsnorm_init(cfg.d_model, dtype, dev)
    else:
        p["final_norm"] = core.layernorm_init(
            cfg.d_model, elementwise=cfg.final_norm == "ln", dtype=dtype,
            device=dev)
    return p


# -- embedding / head ------------------------------------------------------------------

def _final_norm(p, cfg: LMCfg, x):
    if cfg.final_norm == "rms":
        return core.rmsnorm(p["final_norm"], x)
    return core.layernorm(p["final_norm"], x)


def _logits(p, cfg: LMCfg, x, *, compute_dtype):
    return core.unembed(p["embed"], _final_norm(p, cfg, x),
                        compute_dtype=compute_dtype)


def _block_params(gp, bcfg: BlockCfg, i: int, r: int):
    return gp["shared"][str(i)] if bcfg.shared \
        else _index(gp["stacked"][str(i)], r)


# -- forward -------------------------------------------------------------------------

def lm_forward(p, cfg: LMCfg, tokens, *, positions=None,
               impl: str = "kernel", compute_dtype=torch.bfloat16):
    """tokens: (B, L) int.  Returns (logits (B, L, vocab) f32, aux)."""
    check_ported(cfg)
    x = core.embed(p["embed"], tokens, compute_dtype=compute_dtype)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), device=x.device)
    for gp, g in zip(p["groups"], cfg.groups):
        for r in range(g.repeats):
            for i, bcfg in enumerate(g.cycle):
                x, a = block_forward(_block_params(gp, bcfg, i, r), bcfg, x,
                                     positions=positions, impl=impl,
                                     compute_dtype=compute_dtype)
                aux = aux + a
    return _logits(p, cfg, x, compute_dtype=compute_dtype), aux


# -- cache / prefill / decode -----------------------------------------------------------

def lm_init_cache(cfg: LMCfg, B: int, S: int, *, dtype=torch.bfloat16,
                  device=None) -> list:
    check_ported(cfg)
    out = []
    for g in cfg.groups:
        gc = {}
        for i, bcfg in enumerate(g.cycle):
            c = block_init_cache(bcfg, B, S, dtype=dtype, device=device)
            if c:
                gc[str(i)] = tree_map(
                    lambda a: a.unsqueeze(0).repeat(
                        (g.repeats,) + (1,) * a.dim()), c)
        out.append(gc)
    return out


def lm_prefill(p, cfg: LMCfg, tokens, cache, *, impl: str = "kernel",
               compute_dtype=torch.bfloat16):
    """Prefill positions [0, L) of ``tokens`` (B, L); returns (last-token
    logits (B, 1, vocab) f32, the filled cache).  The cache passed in is
    not changed."""
    check_ported(cfg)
    x = core.embed(p["embed"], tokens, compute_dtype=compute_dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    new_cache = []
    for gp, g, gc in zip(p["groups"], cfg.groups, cache):
        per_repeat = []
        for r in range(g.repeats):
            nc_r = {}
            for i, bcfg in enumerate(g.cycle):
                bc = _index(gc[str(i)], r) if str(i) in gc else {}
                x, nc, _ = block_prefill(_block_params(gp, bcfg, i, r), bcfg,
                                         x, bc, positions=positions,
                                         impl=impl,
                                         compute_dtype=compute_dtype)
                if nc:
                    nc_r[str(i)] = nc
            per_repeat.append(nc_r)
        new_cache.append(_stack(per_repeat))
    return _logits(p, cfg, x[:, -1:], compute_dtype=compute_dtype), new_cache


def lm_decode(p, cfg: LMCfg, token, cache, pos, *,
              compute_dtype=torch.bfloat16):
    """One-token decode.  token: (B, 1) int; pos: scalar or (B,) int, the
    absolute position of each row's token.  Returns (logits (B, 1, vocab)
    f32, new cache); the cache passed in is not changed."""
    check_ported(cfg)
    x = core.embed(p["embed"], token, compute_dtype=compute_dtype)
    new_cache = []
    for gp, g, gc in zip(p["groups"], cfg.groups, cache):
        per_repeat = []
        for r in range(g.repeats):
            nc_r = {}
            for i, bcfg in enumerate(g.cycle):
                bc = _index(gc[str(i)], r) if str(i) in gc else {}
                x, nc = block_decode(_block_params(gp, bcfg, i, r), bcfg, x,
                                     bc, pos, compute_dtype=compute_dtype)
                if nc:
                    nc_r[str(i)] = nc
            per_repeat.append(nc_r)
        new_cache.append(_stack(per_repeat))
    return _logits(p, cfg, x, compute_dtype=compute_dtype), new_cache
