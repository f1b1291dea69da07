"""Grouped-query attention with optional QKV bias, qk-norm, sliding
window, cross-attention, and KV-cache decode (port of
``repro.nn.attention``).

``attn_forward`` sends causal self-attention through the hand-written
``flash_attention`` kernel (``impl="kernel"``, the default), through the
plain score-matrix path (``impl="plain"``, the JAX ``impl="xla"``), or
through ``chunked_attention`` (``impl="chunked"``, any self-attention).
Under ``"kernel"``, non-causal attention (whisper's encoder) takes the
plain path, and cross-attention always does, as the reference's do.  Cross-attention
reads its K/V from encoder states (``kv_src``) and applies no RoPE; its
decode cache holds those static K/V and is never written.  Decode takes
one position per batch row, so a continuous-batching engine decodes all
its slots in one call.

``chunked_attention`` is the training path: an online softmax over
q-blocks and k-blocks whose backward recomputes the probabilities from
the saved log-sum-exp (a ``torch.autograd.Function``, the reference's
``custom_vjp``), so neither direction holds an (L, S) score matrix and
the backward keeps only q, k, v, the output and the log-sum-exp.

Tensor parallelism over heads (``"model"``; the reference's specs,
``attn_spec`` and ``kv_cache_spec``): under a mesh with DTensor inputs the
projections run as DTensor products, and q, k and v cross the
reference's ``constrain`` into a local region (``sharding.Region``)
where heads are counted from the local shards, RoPE tables are built,
and the kernel or the plain path runs on this rank's heads.  Where
``"model"`` divides the query heads but not the KV heads, k and v stay
whole on each rank, and the rank takes the KV heads its own query heads
read (``Region.groups_of_heads``) before the kernel is called.  Decode gathers a
sequence-sharded cache (``block_cache_spec(seq_shard=...)``) to the
heads layout before it writes and reads it, as the reference's
``constrain`` of the written cache does, and hands the new cache back in
the layout it came in.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.kernels import ops as kops

from .core import linear, linear_init, rmsnorm, rmsnorm_init
from .rotary import apply_rope, rope_cos_sin
from .sharding import (P, Region, batch_spec, constrain, gather_dim, like,
                       split_last)

NEG_INF = -1e30
IMPLS = ("kernel", "plain", "chunked")


@dataclasses.dataclass(frozen=True)
class AttnCfg:
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    qkv_bias: bool = False
    qk_norm: bool = False
    rope: bool = True
    rope_theta: float = 10000.0
    causal: bool = True
    window: Optional[int] = None      # sliding-window size (tokens)
    cross: bool = False               # cross-attention (kv from encoder)
    d_kv_in: Optional[int] = None     # input dim for kv projections (cross)
    ring: bool = False                # decode KV cache = ring buffer of size
    # `window` instead of the full sequence


def attn_init(generator: torch.Generator, cfg: AttnCfg, *,
              dtype=torch.float32) -> dict:
    d_kv_in = cfg.d_kv_in or cfg.d_model
    hd = cfg.n_heads * cfg.d_head
    kvd = cfg.n_kv_heads * cfg.d_head
    p = {"q": linear_init(generator, cfg.d_model, hd, bias=cfg.qkv_bias,
                          dtype=dtype),
         "k": linear_init(generator, d_kv_in, kvd, bias=cfg.qkv_bias,
                          dtype=dtype),
         "v": linear_init(generator, d_kv_in, kvd, bias=cfg.qkv_bias,
                          dtype=dtype),
         "o": linear_init(generator, hd, cfg.d_model, dtype=dtype)}
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(cfg.d_head, dtype, generator.device)
        p["k_norm"] = rmsnorm_init(cfg.d_head, dtype, generator.device)
    return p


def attn_spec(cfg: AttnCfg) -> dict:
    def lin(bias, wspec):
        s = {"w": wspec}
        if bias:
            s["b"] = P(wspec[1])
        return s
    s = {"q": lin(cfg.qkv_bias, P(None, "model")),
         "k": lin(cfg.qkv_bias, P(None, "model")),
         "v": lin(cfg.qkv_bias, P(None, "model")),
         "o": lin(False, P("model", None))}
    if cfg.qk_norm:
        s["q_norm"] = {"scale": P(None)}
        s["k_norm"] = {"scale": P(None)}
    return s


def _split_heads(x, n, d):
    return split_last(x, n, d)


def _merge_heads(x):
    return x.reshape(x.shape[:-2] + (x.shape[-2] * x.shape[-1],))


def _gqa_scores(q, k, scale):
    """q:(B,L,H,D) k:(B,S,Hkv,D) -> (B,Hkv,G,L,S) f32."""
    B, L, H, D = q.shape
    Hkv = k.shape[2]
    qg = q.float().reshape(B, L, Hkv, H // Hkv, D)
    return torch.einsum("blkgd,bskd->bkgls", qg, k.float()) * scale


def _gqa_out(probs, v):
    """probs:(B,Hkv,G,L,S) v:(B,S,Hkv,D) -> (B,L,H,D) f32."""
    B, Hkv, G, L, S = probs.shape
    out = torch.einsum("bkgls,bskd->blkgd", probs, v.float())
    return out.reshape(B, L, Hkv * G, v.shape[-1])


def _heads_spec() -> P:
    return batch_spec(None, "model", None)


def _leave(reg: Region, out):
    """The region's output (B, L, H, D), heads merged, as it crosses the
    reference's ``constrain`` back: merged on the local shard and handed
    out sharded on its last dim where the heads are (DTensor's backward
    of a merge, a view that splits a sharded dim, is not taken)."""
    out = _merge_heads(out)
    return reg.give_spec(out, reg.spec(None, "model")) if reg.active \
        else out


def causal_window_mask(L: int, S: int, *, causal: bool,
                       window: Optional[int], q_offset: int = 0,
                       device=None) -> torch.Tensor:
    """(L, S) bool mask; query i sits at absolute position i + q_offset."""
    qpos = torch.arange(L, device=device)[:, None] + q_offset
    kpos = torch.arange(S, device=device)[None, :]
    m = torch.ones((L, S), dtype=torch.bool, device=device)
    if causal:
        m &= kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    return m


def _masked_softmax(scores, valid):
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    return torch.softmax(scores, dim=-1)


def _block_mask(iq: int, ik: int, bq: int, bk: int, causal: bool,
                window: Optional[int], device) -> torch.Tensor:
    """(bq, bk) bool: which keys of k-block ``ik`` each query of q-block
    ``iq`` may see."""
    qpos = iq * bq + torch.arange(bq, device=device)[:, None]
    kpos = ik * bk + torch.arange(bk, device=device)[None, :]
    mask = torch.ones((bq, bk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def _live_blocks(iq: int, nk: int, bq: int, bk: int, causal: bool,
                 window: Optional[int]) -> list:
    """The k-blocks of which some key is visible to some query of q-block
    ``iq``.  A block wholly masked adds exactly nothing in either
    direction (its probabilities are 0 after the masking ``where``s), so
    skipping it changes no bit."""
    q_lo, q_hi = iq * bq, iq * bq + bq - 1
    out = []
    for ik in range(nk):
        k_lo, k_hi = ik * bk, ik * bk + bk - 1
        if causal and k_lo > q_hi:
            continue
        if window is not None and k_hi <= q_lo - window:
            continue
        out.append(ik)
    return out


def _chunk_views(q, k, v, bq: int, bk: int):
    B, L, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    return (q.reshape(B, L // bq, bq, Hkv, G, D),
            k.reshape(B, S // bk, bk, Hkv, D),
            v.reshape(B, S // bk, bk, Hkv, D))


def _chunked_fwd(q, k, v, causal: bool, window: Optional[int], scale: float,
                 bq: int, bk: int):
    """Online softmax over q-blocks (outer) and k-blocks (inner), scores
    in f32 from q and k upcast.  Returns (out (B, L, H, D) in q's dtype,
    lse (B, Hkv, G, L) f32)."""
    B, L, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    nq, nk = L // bq, k.shape[1] // bk
    qc, kc, vc = _chunk_views(q, k, v, bq, bk)
    outs, lses = [], []
    for iq in range(nq):
        qb = qc[:, iq].float()                          # (B,bq,Hkv,G,D)
        m = torch.full((B, Hkv, G, bq), NEG_INF, device=q.device)
        l = torch.zeros((B, Hkv, G, bq), device=q.device)
        acc = torch.zeros((B, Hkv, G, bq, D), device=q.device)
        for ik in _live_blocks(iq, nk, bq, bk, causal, window):
            s = torch.einsum("bqkgd,bskd->bkgqs", qb,
                             kc[:, ik].float()) * scale
            mask = _block_mask(iq, ik, bq, bk, causal, window, q.device)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p_ = torch.exp(s - m_new[..., None])
            p_ = torch.where(m_new[..., None] > NEG_INF / 2, p_, 0.0)
            corr = torch.where(m > NEG_INF / 2, torch.exp(m - m_new), 0.0)
            l = corr * l + p_.sum(dim=-1)
            acc = corr[..., None] * acc + torch.einsum(
                "bkgqs,bskd->bkgqd", p_, vc[:, ik].float())
            m = m_new
        lc = torch.clamp(l, min=1e-30)
        outs.append((acc / lc[..., None]).permute(0, 3, 1, 2, 4))
        lses.append(m + torch.log(lc))
    out = torch.stack(outs, dim=1).reshape(B, L, H, D).to(q.dtype)
    return out, torch.cat(lses, dim=-1)


def _chunked_bwd(q, k, v, out, lse, do, causal: bool,
                 window: Optional[int], scale: float, bq: int, bk: int):
    """The recomputing backward: per block pair the probabilities come
    back from q, k and ``lse``; ``delta = rowsum(do·out)``; dk and dv are
    summed over each KV head's G query heads.  Returns (dq, dk, dv) in the
    inputs' dtypes."""
    B, L, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    nq, nk = L // bq, S // bk
    qc, kc, vc = _chunk_views(q, k, v, bq, bk)
    oc = out.reshape(qc.shape)
    doc = do.reshape(qc.shape)
    lsec = lse.reshape(B, Hkv, G, nq, bq)
    dk = torch.zeros((B, nk, bk, Hkv, D), device=q.device)
    dv = torch.zeros((B, nk, bk, Hkv, D), device=q.device)
    dqs = []
    for iq in range(nq):
        qbf = qc[:, iq].float()
        dobf = doc[:, iq].float()
        delta = (dobf * oc[:, iq].float()).sum(dim=-1)       # (B,bq,Hkv,G)
        delta = delta.permute(0, 2, 3, 1)                    # (B,Hkv,G,bq)
        dob_r = dobf.permute(0, 2, 3, 1, 4)                  # (B,Hkv,G,bq,D)
        q_r = qbf.permute(0, 2, 3, 1, 4)
        lseb = lsec[:, :, :, iq]
        dq_b = torch.zeros((B, Hkv, G, bq, D), device=q.device)
        for ik in _live_blocks(iq, nk, bq, bk, causal, window):
            kb, vb = kc[:, ik].float(), vc[:, ik].float()
            s = torch.einsum("bqkgd,bskd->bkgqs", qbf, kb) * scale
            mask = _block_mask(iq, ik, bq, bk, causal, window, q.device)
            s = torch.where(mask, s, NEG_INF)
            p_ = torch.where(mask, torch.exp(s - lseb[..., None]), 0.0)
            dv[:, ik] += torch.einsum("bkgqs,bkgqd->bskd", p_, dob_r)
            dp = torch.einsum("bkgqd,bskd->bkgqs", dob_r, vb)
            ds = p_ * (dp - delta[..., None]) * scale
            dq_b += torch.einsum("bkgqs,bskd->bkgqd", ds, kb)
            dk[:, ik] += torch.einsum("bkgqs,bkgqd->bskd", ds, q_r)
        dqs.append(dq_b.permute(0, 3, 1, 2, 4))
    dq = torch.stack(dqs, dim=1).reshape(B, L, H, D)
    return (dq.to(q.dtype), dk.reshape(B, S, Hkv, D).to(k.dtype),
            dv.reshape(B, S, Hkv, D).to(v.dtype))


class ChunkedAttention(torch.autograd.Function):
    """``_chunked_fwd`` forward; the backward recomputes from the saved
    q, k, v, out and lse (``_chunked_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, bq, bk):
        out, lse = _chunked_fwd(q, k, v, causal, window, scale, bq, bk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, scale, bq, bk)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _chunked_bwd(q, k, v, out, lse, do.contiguous(),
                                  *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def chunked_attention(q, k, v, *, causal: bool, window: Optional[int],
                      scale: float, bq: int = 1024, bk: int = 1024):
    """Flash-style double-chunked attention in plain PyTorch with a
    recomputing backward: an O(bq·bk) working set in both directions,
    where autograd through the block loops would keep every block's
    carries.  q: (B, L, H, D); k, v: (B, S, Hkv, D); the blocks are
    ``min(bq, L)`` and ``min(bk, S)``, which must divide L and S.
    Returns (B, L, H, D) in q's dtype."""
    bq, bk = min(bq, q.shape[1]), min(bk, k.shape[1])
    if q.shape[1] % bq or k.shape[1] % bk:
        raise ValueError(f"chunked_attention: L = {q.shape[1]} and S = "
                         f"{k.shape[1]} must be multiples of the blocks "
                         f"({bq}, {bk})")
    return ChunkedAttention.apply(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal, window, scale,
                                  bq, bk)


def attn_forward(p: dict, cfg: AttnCfg, x: torch.Tensor, *, kv_src=None,
                 positions=None, impl: str = "kernel",
                 compute_dtype=torch.bfloat16, return_kv: bool = False):
    """Full-sequence attention (prefill).  x: (B, L, D); ``kv_src`` (B, S,
    Dkv) the encoder states of cross-attention (default x); positions:
    (L,) absolute positions for RoPE (default arange).  ``impl="kernel"``
    runs causal self-attention through ``kernels.ops.flash_attention``;
    ``impl="chunked"`` any self-attention through ``chunked_attention``;
    ``impl="plain"``, and cross-attention always, through the score
    matrix."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, not {impl!r}")
    B, L, _ = x.shape
    kv_in = x if kv_src is None else kv_src
    S = kv_in.shape[1]
    q = _split_heads(linear(p["q"], x, compute_dtype=compute_dtype),
                     cfg.n_heads, cfg.d_head)
    k = _split_heads(linear(p["k"], kv_in, compute_dtype=compute_dtype),
                     cfg.n_kv_heads, cfg.d_head)
    v = _split_heads(linear(p["v"], kv_in, compute_dtype=compute_dtype),
                     cfg.n_kv_heads, cfg.d_head)
    k, v = constrain(k, _heads_spec()), constrain(v, _heads_spec())
    # the local region: this rank's heads, from here to the output's
    # constrain
    reg = Region(q)
    q = reg.open(q, _heads_spec())
    k_pl, v_pl = getattr(k, "placements", None), getattr(v, "placements",
                                                          None)
    k, v = reg.take(k), reg.take(v)
    if cfg.qk_norm:
        q = rmsnorm({"scale": reg.take(p["q_norm"]["scale"])}, q)
        k = rmsnorm({"scale": reg.take(p["k_norm"]["scale"])}, k)
    if cfg.rope and not cfg.cross:
        if positions is None:
            positions = torch.arange(L, device=q.device)
        cos, sin = rope_cos_sin(positions, cfg.d_head, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    kq, vq = reg.groups_of_heads((k, v), 2, cfg.n_heads, cfg.n_kv_heads,
                                 q.shape[2])

    scale = 1.0 / math.sqrt(cfg.d_head)
    if impl == "kernel" and cfg.causal and not cfg.cross:
        out = kops.flash_attention(q.contiguous(), kq.contiguous(),
                                   vq.contiguous(), causal=True,
                                   window=cfg.window)
    elif impl == "chunked" and not cfg.cross:
        out = chunked_attention(q, kq, vq, causal=cfg.causal,
                                window=cfg.window, scale=scale)
    else:
        scores = _gqa_scores(q, kq, scale)
        if cfg.cross:
            probs = torch.softmax(scores, dim=-1)
        else:
            probs = _masked_softmax(scores, causal_window_mask(
                L, S, causal=cfg.causal, window=cfg.window, device=q.device))
        out = _gqa_out(probs, vq).to(compute_dtype)
    y = linear(p["o"], _leave(reg, out), compute_dtype=compute_dtype)
    if reg.active and return_kv:
        k, v = reg.give(k, k_pl), reg.give(v, v_pl)
    if return_kv:
        return y, (k, v)
    return y


def init_kv_cache(B: int, S: int, cfg: AttnCfg, dtype=torch.bfloat16,
                  device=None) -> dict:
    if cfg.ring and cfg.window is not None:
        S = min(S, cfg.window)
    shape = (B, S, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def kv_cache_spec(cfg: AttnCfg) -> dict:
    # batch over data axes, kv heads over model.
    return {"k": batch_spec(None, "model", None),
            "v": batch_spec(None, "model", None)}


def _row_positions(pos, B: int, device, reg: Region = None) -> torch.Tensor:
    """A scalar or (B,) position -> (B,) int64 on ``device``; in an
    active region, this rank's rows of it."""
    pos = torch.as_tensor(pos, device=device).to(torch.int64)
    pos = pos.expand(B) if pos.dim() == 0 else pos.reshape(B)
    return pos if reg is None else reg.rows(pos)


def attn_decode(p: dict, cfg: AttnCfg, x: torch.Tensor, cache: dict, pos, *,
                compute_dtype=torch.bfloat16):
    """One-token decode.  x: (B, 1, D); cache {"k","v"}: (B, S, Hkv, Dh);
    pos: scalar or (B,) int — the absolute position of each row's new
    token.  Returns (y, new_cache); the cache passed in is not changed.

    A position at or past S writes the last slot (the clamp of the JAX
    ``dynamic_update_slice``); a ring cache writes slot ``pos % S``.  For
    cross-attention the cache holds the encoder's (static) K/V: it is read
    whole, unmasked, and returned as it is (``pos`` is not used)."""
    B = x.shape[0]
    q = _split_heads(linear(p["q"], x, compute_dtype=compute_dtype),
                     cfg.n_heads, cfg.d_head)
    reg = Region(q)

    def leave(out):
        return linear(p["o"], _leave(reg, out), compute_dtype=compute_dtype)

    if cfg.cross:
        q = reg.open(q, _heads_spec())
        kc = reg.take(gather_dim(cache["k"], 1), _heads_spec())
        vc = reg.take(gather_dim(cache["v"], 1), _heads_spec())
        if cfg.qk_norm:
            q = rmsnorm({"scale": reg.take(p["q_norm"]["scale"])}, q)
        kc, vc = reg.groups_of_heads((kc, vc), 2, cfg.n_heads,
                                     cfg.n_kv_heads, q.shape[2])
        probs = torch.softmax(_gqa_scores(q, kc, 1.0 / math.sqrt(
            cfg.d_head)), dim=-1)
        return leave(_gqa_out(probs, vc).to(compute_dtype)), cache
    k_new = _split_heads(linear(p["k"], x, compute_dtype=compute_dtype),
                         cfg.n_kv_heads, cfg.d_head)
    v_new = _split_heads(linear(p["v"], x, compute_dtype=compute_dtype),
                         cfg.n_kv_heads, cfg.d_head)
    # the cache in the heads layout (a sequence-sharded one gathered), the
    # write and the read on this rank's heads
    kc = constrain(gather_dim(cache["k"], 1), _heads_spec())
    vc = constrain(gather_dim(cache["v"], 1), _heads_spec())
    kc_pl = getattr(kc, "placements", None)
    q = reg.open(q, _heads_spec())
    k_new = reg.take(k_new, _heads_spec())
    v_new = reg.take(v_new, _heads_spec())
    k, v = reg.take(kc), reg.take(vc)
    dev = q.device
    pos = _row_positions(pos, B, dev, reg if reg.active else None)
    if cfg.qk_norm:
        q = rmsnorm({"scale": reg.take(p["q_norm"]["scale"])}, q)
        k_new = rmsnorm({"scale": reg.take(p["k_norm"]["scale"])}, k_new)
    if cfg.rope:
        cos, sin = rope_cos_sin(pos[:, None], cfg.d_head, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k_new = apply_rope(k_new, cos, sin)

    S = k.shape[1]
    ring = cfg.ring and cfg.window is not None
    write_at = torch.remainder(pos, S) if ring else pos.clamp(0, S - 1)
    rows = torch.arange(k.shape[0], device=dev)
    k = k.clone()
    v = v.clone()
    k[rows, write_at] = k_new[:, 0].to(k.dtype)
    v[rows, write_at] = v_new[:, 0].to(v.dtype)

    kq, vq = reg.groups_of_heads((k, v), 2, cfg.n_heads, cfg.n_kv_heads,
                                 q.shape[2])
    scores = _gqa_scores(q, kq, 1.0 / math.sqrt(cfg.d_head))  # (B,Hkv,G,1,S)
    kpos = torch.arange(S, device=dev)[None, :]
    if ring:
        # slot s holds global position pos - ((pos - s) mod S); only slots
        # not yet written (global position < 0) are masked
        valid = pos[:, None] - torch.remainder(pos[:, None] - kpos, S) >= 0
    else:
        valid = kpos <= pos[:, None]
        if cfg.window is not None:
            valid &= kpos > pos[:, None] - cfg.window
    probs = _masked_softmax(scores, valid[:, None, None, None, :])
    y = leave(_gqa_out(probs, vq).to(compute_dtype))
    if reg.active:
        k = like(reg.give(k, kc_pl), cache["k"])
        v = like(reg.give(v, kc_pl), cache["v"])
    return y, {"k": k, "v": v}
