"""CompositeLM: a decoder-only LM assembled from groups of block cycles
(port of ``repro.models.lm``), covering dense, MoE, SSM, hybrid and VLM
architectures.

A group is ``repeats`` × ``cycle`` (a tuple of BlockCfg).  Parameters of a
block that is not ``shared`` are stacked with a leading repeat axis, as in
the JAX tree; the JAX ``lax.scan`` over repeats is a Python loop over that
axis here.  A ``shared`` block keeps one parameter set for every repeat
(Zamba2's shared attention) while its caches stay per repeat.  The cache
is a list (one per group) of dicts (one per stateful block of the cycle)
whose leaves carry the repeat axis first.

Inputs: ``prefix_embeds`` (B, n_prefix, prefix_embed_dim), precomputed
vision-patch embeddings, go through the projector ``proj`` into the
leading sequence slots (VLM); learned absolute positions (``pos``) are
added to the embeddings; an untied ``lm_head`` replaces the tied
unembedding; a DeepSeek-V3 config carries its multi-token-prediction
module's parameters (``mtp``), so its tree is the reference's.

Training: ``lm_loss`` (next-token cross-entropy, the MoE aux loss and
DeepSeek-V3's depth-1 MTP loss) runs through ``impl="plain"`` (the
reference's ``"xla"``) or ``"chunked"``; ``cfg.remat`` recomputes each
repeat of a cycle in the backward (``torch.utils.checkpoint``), as the
reference's ``jax.checkpoint`` of its scan body does.

Under a mesh: ``lm_spec`` and ``lm_cache_spec`` are the reference's
PartitionSpec trees (the repeat axis unsharded); with DTensor parameters
and inputs the embeddings, logits and every block's residual stream
cross the reference's ``constrain`` points, and each group's new cache
comes back in the layout of the cache passed in.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.nn import core
from repro_torch.nn.sharding import P, batch_spec, constrain, gather_dim, like

from .blocks import (BlockCfg, block_cache_spec, block_decode, block_forward,
                     block_init, block_init_cache, block_prefill, block_spec)


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
    pos_embed: str = "none"        # "none" (rope inside attn) | "learned"
    max_positions: int = 0         # for learned positions
    n_prefix: int = 0              # VLM: number of vision-patch slots
    prefix_embed_dim: int = 0      # VLM: raw patch-embedding dim (0 = none)
    mtp: bool = False              # DeepSeek-V3 multi-token prediction
    remat: bool = False            # recompute each repeat in the backward
    unroll: bool = False           # the port always loops in Python

    @property
    def n_layers(self) -> int:
        return sum(g.repeats * len(g.cycle) for g in self.groups)


def tree_map(fn, *trees):
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, list):
        return [tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts and lists, dict keys sorted: the leaf
    order of ``jax.tree.leaves``."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` in ``tree_leaves``
    order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [build(x) for x in t]
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def unstack(tree, n: int) -> list:
    """The ``n`` per-repeat trees of a tree whose leaves lead with a
    repeat axis, from one ``unbind`` a leaf: under autograd each leaf then
    gets one backward that stacks its repeats' gradients, where a select
    a repeat would write a zero-filled copy of the whole stack each."""
    parts = tree_map(lambda a: gather_dim(a, 0).unbind(0), tree)
    return [tree_map(lambda t: t[r], parts) for r in range(n)]


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


# -- specs -------------------------------------------------------------------------

def _stack_spec(spec):
    """Prepend a None (repeat) dim to every PartitionSpec leaf."""
    if isinstance(spec, dict):
        return {k: _stack_spec(v) for k, v in spec.items()}
    return P(None, *spec)


def _group_spec(g: GroupCfg) -> dict:
    shared, stacked = {}, {}
    for i, bcfg in enumerate(g.cycle):
        if bcfg.shared:
            shared[str(i)] = block_spec(bcfg)
        else:
            stacked[str(i)] = _stack_spec(block_spec(bcfg))
    return {"shared": shared, "stacked": stacked}


def lm_spec(cfg: LMCfg) -> dict:
    s: dict = {
        "embed": core.embedding_spec(),
        "groups": [_group_spec(g) for g in cfg.groups],
        "final_norm": (core.rmsnorm_spec() if cfg.final_norm == "rms"
                       else core.layernorm_spec(
                           elementwise=cfg.final_norm == "ln"))}
    if cfg.pos_embed == "learned":
        s["pos"] = P(None, None)
    if not cfg.tie_embeddings:
        s["lm_head"] = {"w": P(None, "model")}
    if cfg.prefix_embed_dim:
        s["proj"] = {"w": P(None, None), "b": P(None)}
    if cfg.mtp:
        s["mtp"] = {"norm_h": core.rmsnorm_spec(),
                    "norm_e": core.rmsnorm_spec(),
                    "proj": {"w": P(None, None)},
                    "block": block_spec(cfg.groups[-1].cycle[-1])}
    return s


def lm_cache_spec(cfg: LMCfg, *, seq_shard=None) -> list:
    out = []
    for g in cfg.groups:
        gs = {}
        for i, bcfg in enumerate(g.cycle):
            c = block_cache_spec(bcfg, seq_shard=seq_shard)
            if c:
                gs[str(i)] = _stack_spec(c)
        out.append(gs)
    return out


# -- init --------------------------------------------------------------------------

def _stack_init(make, n: int):
    """``n`` calls of ``make()`` stacked on a leading axis, each written
    into one preallocated tree as it comes, so the peak is the stack and
    one block (a full-width group is most of a model's weights)."""
    first = make()
    out = tree_map(lambda a: a.new_empty((n,) + tuple(a.shape)), first)
    for r in range(n):
        block = first if r == 0 else make()
        tree_map(lambda o, a: o[r].copy_(a), out, block)
        first = block = None
    return out


def _group_init(generator, g: GroupCfg, *, dtype):
    shared, stacked = {}, {}
    for i, bcfg in enumerate(g.cycle):
        if bcfg.shared:
            shared[str(i)] = block_init(generator, bcfg, dtype=dtype)
        else:
            stacked[str(i)] = _stack_init(
                lambda b=bcfg: block_init(generator, b, dtype=dtype),
                g.repeats)
    return {"shared": shared, "stacked": stacked}


def _final_norm_init(kind: str, d: int, dtype, device):
    if kind == "rms":
        return core.rmsnorm_init(d, dtype, device)
    return core.layernorm_init(d, elementwise=kind == "ln", dtype=dtype,
                               device=device)


def lm_init(generator: torch.Generator, cfg: LMCfg, *,
            dtype=torch.float32) -> dict:
    """Random parameters from ``generator``, on its device, in the JAX
    tree layout: ``embed.table``, ``groups[i].shared / .stacked``,
    ``final_norm``, and where the config has them ``pos``, ``lm_head``,
    ``proj`` and ``mtp``."""
    dev = generator.device
    p = {"embed": core.embedding_init(generator, cfg.vocab, cfg.d_model,
                                      dtype=dtype),
         "groups": [_group_init(generator, g, dtype=dtype)
                    for g in cfg.groups],
         "final_norm": _final_norm_init(cfg.final_norm, cfg.d_model, dtype,
                                        dev)}
    if cfg.pos_embed == "learned":
        p["pos"] = core.normal_init(generator, (cfg.max_positions,
                                                cfg.d_model), 0.02, dtype)
    if not cfg.tie_embeddings:
        p["lm_head"] = core.linear_init(generator, cfg.d_model, cfg.vocab,
                                        dtype=dtype)
    if cfg.prefix_embed_dim:
        p["proj"] = core.linear_init(generator, cfg.prefix_embed_dim,
                                     cfg.d_model, bias=True, dtype=dtype)
    if cfg.mtp:
        # depth-1 MTP module: both streams normed, 2d -> d, one block
        p["mtp"] = {
            "norm_h": core.rmsnorm_init(cfg.d_model, dtype, dev),
            "norm_e": core.rmsnorm_init(cfg.d_model, dtype, dev),
            "proj": core.linear_init(generator, 2 * cfg.d_model, cfg.d_model,
                                     dtype=dtype),
            "block": block_init(generator, cfg.groups[-1].cycle[-1],
                                dtype=dtype)}
    return p


# -- embedding / head ------------------------------------------------------------------

def _positions(p, cfg: LMCfg, start, L: int):
    """Rows [start, start + L) of the learned position table, with the
    start clamped as ``dynamic_slice`` clamps it; ``start`` an int or a
    (B,) tensor (L = 1, one position per row)."""
    if torch.is_tensor(start) and start.dim():
        idx = start.clamp(0, cfg.max_positions - 1)[:, None]
        return p["pos"][idx]                                 # (B, 1, d)
    s = min(max(int(start), 0), cfg.max_positions - L)
    return p["pos"][s: s + L]


def _embed_inputs(p, cfg: LMCfg, tokens, prefix_embeds, *, compute_dtype):
    # a vocab-sharded table's lookup is partial until this constrain
    x = constrain(core.embed(p["embed"], tokens, compute_dtype=compute_dtype),
                  batch_spec(None, None))
    if cfg.prefix_embed_dim and prefix_embeds is not None:
        vis = core.linear(p["proj"], prefix_embeds,
                          compute_dtype=compute_dtype)
        x = torch.cat([vis, x], dim=1)
    if cfg.pos_embed == "learned":
        x = x + _positions(p, cfg, 0, x.shape[1]).to(compute_dtype)
    return x


def _final_norm(p, cfg: LMCfg, x):
    if cfg.final_norm == "rms":
        return core.rmsnorm(p["final_norm"], x)
    return core.layernorm(p["final_norm"], x)


def _logits(p, cfg: LMCfg, x, *, compute_dtype):
    """f32 logits of the final-normed ``x``: the tied unembedding, or the
    untied head (bf16 operands, f32 products and sums)."""
    x = _final_norm(p, cfg, x)
    if cfg.tie_embeddings:
        logits = core.unembed(p["embed"], x, compute_dtype=compute_dtype)
    else:
        w = p["lm_head"]["w"].to(compute_dtype).float()
        logits = torch.matmul(x.to(compute_dtype).float(), w)
    return constrain(logits, batch_spec(None, "model"))


def repeat_params(gp, g: GroupCfg) -> list:
    """Per repeat of group ``g``, each cycle block's parameters (a shared
    block's one set, a stacked block's slice of the repeat)."""
    stacked = unstack(gp["stacked"], g.repeats)
    return [[gp["shared"][str(i)] if b.shared else stacked[r][str(i)]
             for i, b in enumerate(g.cycle)] for r in range(g.repeats)]


def run_repeats(body, reps: list, x, aux, remat: bool):
    """``x, aux = body(bp, x, aux)`` for each repeat's parameters ``bp``;
    with ``remat`` each repeat runs under ``checkpoint`` and is recomputed
    in the backward (the reference's ``jax.checkpoint`` of its scan
    body)."""
    for bp in reps:
        if remat and torch.is_grad_enabled():
            x, aux = checkpoint(body, bp, x, aux, use_reentrant=False)
        else:
            x, aux = body(bp, x, aux)
    return x, aux


# -- forward -------------------------------------------------------------------------

def lm_forward(p, cfg: LMCfg, tokens, *, prefix_embeds=None, positions=None,
               impl: str = "kernel", compute_dtype=torch.bfloat16):
    """tokens: (B, L_text) int [+ prefix_embeds (B, n_prefix, raw_dim)].
    Returns (logits (B, L, vocab) f32, aux)."""
    x = _embed_inputs(p, cfg, tokens, prefix_embeds,
                      compute_dtype=compute_dtype)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    x = constrain(x, batch_spec(None, None))
    aux = x.new_zeros((), dtype=torch.float32)
    for gp, g in zip(p["groups"], cfg.groups):
        def body(bps, x, aux, g=g):
            for bp, bcfg in zip(bps, g.cycle):
                x, a = block_forward(bp, bcfg, x, positions=positions,
                                     impl=impl, compute_dtype=compute_dtype)
                aux = aux + a
            return x, aux
        x, aux = run_repeats(body, repeat_params(gp, g), x, aux, cfg.remat)
    return _logits(p, cfg, x, compute_dtype=compute_dtype), aux


# -- training losses --------------------------------------------------------------------

MTP_WEIGHT = 0.3   # DeepSeek-V3's depth-1 MTP loss weight


def softmax_xent(logits, labels, *, ignore: int = -100):
    """Mean next-token cross-entropy.  logits (B, L, V) f32; labels (B, L)
    int, entries equal to ``ignore`` masked out (the mean is over the
    others, at least one)."""
    mask = labels != ignore
    safe = torch.where(mask, labels, torch.zeros_like(labels))
    logz = torch.logsumexp(logits, dim=-1)
    # gathered from (B·L, V) rows: a vocab-sharded DTensor's gather is
    # partial until reduced, and DTensor reduces it on 2-D tensors
    V = logits.shape[-1]
    gold = constrain(torch.gather(logits.reshape(-1, V), -1,
                                  safe.reshape(-1, 1).long()),
                     batch_spec(None)).reshape(safe.shape)
    nll = (logz - gold) * mask
    # replicated: a DTensor sum over sharded rows is partial until reduced
    return constrain(nll.sum() / mask.sum().clamp(min=1), P())


def lm_loss(p, cfg: LMCfg, batch: dict, *, impl: str = "plain",
            compute_dtype=torch.bfloat16):
    """batch: {"tokens", "labels"[, "prefix_embeds"]}.  Returns (loss,
    metrics): the cross-entropy plus the MoE aux loss and, with
    ``cfg.mtp``, 0.3 x the depth-1 MTP loss (the hidden states of
    positions 1..L-1 joined with the next embeddings, one extra block, the
    shared head, scored on the labels shifted by one).

    ``impl`` is ``"plain"`` (the reference's ``"xla"``) or ``"chunked"``;
    ``"kernel"`` is refused under grad by the kernels, which have no
    backward.  The MTP block runs the plain path, as the reference's call,
    which passes no ``impl``, runs ``"xla"``."""
    logits, aux = lm_forward(p, cfg, batch["tokens"],
                             prefix_embeds=batch.get("prefix_embeds"),
                             impl=impl, compute_dtype=compute_dtype)
    loss = softmax_xent(logits, batch["labels"])
    metrics = {"xent": loss, "aux": aux}
    if cfg.mtp:
        x = _embed_inputs(p, cfg, batch["tokens"], batch.get("prefix_embeds"),
                          compute_dtype=compute_dtype)
        h = core.rmsnorm(p["mtp"]["norm_h"], x[:, :-1])
        e = core.rmsnorm(p["mtp"]["norm_e"], x[:, 1:])
        hm = core.linear(p["mtp"]["proj"], torch.cat([h, e], dim=-1),
                         compute_dtype=compute_dtype)
        hm, a2 = block_forward(
            p["mtp"]["block"], cfg.groups[-1].cycle[-1], hm,
            positions=torch.arange(hm.shape[1], device=hm.device),
            impl="plain", compute_dtype=compute_dtype)
        mtp_loss = softmax_xent(_logits(p, cfg, hm,
                                        compute_dtype=compute_dtype),
                                batch["labels"][:, 1:])
        loss = loss + MTP_WEIGHT * mtp_loss
        aux = aux + a2
        metrics["mtp_xent"] = mtp_loss
    loss = loss + aux
    metrics["loss"] = loss
    return loss, {k: constrain(v, P()) for k, v in metrics.items()}


# -- cache / prefill / decode -----------------------------------------------------------

def stacked_cache(g: GroupCfg, make) -> dict:
    """Per-repeat cache of every stateful block of the cycle, ``make(bcfg)``
    repeated along a leading repeat axis."""
    gc = {}
    for i, bcfg in enumerate(g.cycle):
        c = make(bcfg)
        if c:
            gc[str(i)] = tree_map(
                lambda a: a.unsqueeze(0).repeat((g.repeats,) + (1,) * a.dim()),
                c)
    return gc


def lm_init_cache(cfg: LMCfg, B: int, S: int, *, dtype=torch.bfloat16,
                  device=None) -> list:
    return [stacked_cache(g, lambda b: block_init_cache(
        b, B, S, dtype=dtype, device=device)) for g in cfg.groups]


def group_prefill(gp, g: GroupCfg, x, gc, *, positions, enc=None,
                  impl: str = "kernel", compute_dtype=torch.bfloat16):
    """One group's repeats over ``x``, filling its cache ``gc``.  Returns
    (x, the group's new cache)."""
    per_repeat = []
    caches = unstack(gc, g.repeats)
    for bps, c_r in zip(repeat_params(gp, g), caches):
        nc_r = {}
        for i, (bp, bcfg) in enumerate(zip(bps, g.cycle)):
            x, nc, _ = block_prefill(bp, bcfg, x, c_r.get(str(i), {}),
                                     positions=positions, enc=enc,
                                     impl=impl, compute_dtype=compute_dtype)
            if nc:
                nc_r[str(i)] = nc
        per_repeat.append(nc_r)
    return x, _stack_like(per_repeat, gc)


def _stack_like(per_repeat: list, gc):
    """The per-repeat caches stacked, each leaf in the layout of ``gc``'s
    (a DTensor cache keeps its placements)."""
    return tree_map(like, _stack(per_repeat), gc)


def group_decode(gp, g: GroupCfg, x, gc, pos, *,
                 compute_dtype=torch.bfloat16, route_rows: bool = False):
    """One decode step through one group's repeats.  Returns (x, the
    group's new cache)."""
    per_repeat = []
    caches = unstack(gc, g.repeats)
    for bps, c_r in zip(repeat_params(gp, g), caches):
        nc_r = {}
        for i, (bp, bcfg) in enumerate(zip(bps, g.cycle)):
            x, nc = block_decode(bp, bcfg, x, c_r.get(str(i), {}), pos,
                                 compute_dtype=compute_dtype,
                                 route_rows=route_rows)
            if nc:
                nc_r[str(i)] = nc
        per_repeat.append(nc_r)
    return x, _stack_like(per_repeat, gc)


def lm_prefill(p, cfg: LMCfg, tokens, cache, *, prefix_embeds=None,
               impl: str = "kernel", compute_dtype=torch.bfloat16):
    """Prefill positions [0, L) of ``tokens`` (B, L_text), behind the
    projected ``prefix_embeds`` if given; returns (last-token logits (B,
    1, vocab) f32, the filled cache).  The cache passed in is not
    changed."""
    x = _embed_inputs(p, cfg, tokens, prefix_embeds,
                      compute_dtype=compute_dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    x = constrain(x, batch_spec(None, None))
    new_cache = []
    for gp, g, gc in zip(p["groups"], cfg.groups, cache):
        x, nc = group_prefill(gp, g, x, gc, positions=positions, impl=impl,
                              compute_dtype=compute_dtype)
        new_cache.append(nc)
    return _logits(p, cfg, x[:, -1:], compute_dtype=compute_dtype), new_cache


def lm_decode(p, cfg: LMCfg, token, cache, pos, *,
              compute_dtype=torch.bfloat16, route_rows: bool = False):
    """One-token decode.  token: (B, 1) int; pos: scalar or (B,) int, the
    absolute position of each row's token.  ``route_rows``: MoE layers
    route each row on its own, as the reference's engine, which maps a
    one-row decode over its slots, does.  Returns (logits (B, 1, vocab)
    f32, new cache); the cache passed in is not changed."""
    x = core.embed(p["embed"], token, compute_dtype=compute_dtype)
    if cfg.pos_embed == "learned":
        start = torch.as_tensor(pos, device=x.device)
        start = start.expand(x.shape[0]) if start.dim() == 0 else start
        x = x + _positions(p, cfg, start, 1).to(compute_dtype)
    x = constrain(x, batch_spec(None, None))
    new_cache = []
    for gp, g, gc in zip(p["groups"], cfg.groups, cache):
        x, nc = group_decode(gp, g, x, gc, pos, compute_dtype=compute_dtype,
                             route_rows=route_rows)
        new_cache.append(nc)
    return _logits(p, cfg, x, compute_dtype=compute_dtype), new_cache
