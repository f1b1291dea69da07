"""Grouped-query attention with optional QKV bias, qk-norm, sliding
window, cross-attention, and KV-cache decode (port of
``repro.nn.attention``).

``attn_forward`` sends causal self-attention through the hand-written
``flash_attention`` kernel (``impl="kernel"``, the default) or through the
plain score-matrix path (``impl="plain"``, the JAX ``impl="xla"``).
Non-causal attention (whisper's encoder) and cross-attention take the
plain path whatever ``impl`` says, as the reference's do.  Cross-attention
reads its K/V from encoder states (``kv_src``) and applies no RoPE; its
decode cache holds those static K/V and is never written.  Decode takes
one position per batch row, so a continuous-batching engine decodes all
its slots in one call.  The training-only ``chunked_attention`` is not
ported yet (ROADMAP A.11, its training half).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.kernels import ops as kops

from .core import linear, linear_init, rmsnorm, rmsnorm_init
from .rotary import apply_rope, rope_cos_sin

NEG_INF = -1e30


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


def _split_heads(x, n, d):
    return x.reshape(x.shape[:-1] + (n, d))


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


def attn_forward(p: dict, cfg: AttnCfg, x: torch.Tensor, *, kv_src=None,
                 positions=None, impl: str = "kernel",
                 compute_dtype=torch.bfloat16, return_kv: bool = False):
    """Full-sequence attention (prefill).  x: (B, L, D); ``kv_src`` (B, S,
    Dkv) the encoder states of cross-attention (default x); positions:
    (L,) absolute positions for RoPE (default arange).  ``impl="kernel"``
    runs causal self-attention through ``kernels.ops.flash_attention``;
    ``impl="plain"``, non-causal and cross-attention through the score
    matrix."""
    if impl not in ("kernel", "plain"):
        raise ValueError(f"impl must be 'kernel' or 'plain', not {impl!r}")
    B, L, _ = x.shape
    kv_in = x if kv_src is None else kv_src
    S = kv_in.shape[1]
    q = _split_heads(linear(p["q"], x, compute_dtype=compute_dtype),
                     cfg.n_heads, cfg.d_head)
    k = _split_heads(linear(p["k"], kv_in, compute_dtype=compute_dtype),
                     cfg.n_kv_heads, cfg.d_head)
    v = _split_heads(linear(p["v"], kv_in, compute_dtype=compute_dtype),
                     cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    if cfg.rope and not cfg.cross:
        if positions is None:
            positions = torch.arange(L, device=x.device)
        cos, sin = rope_cos_sin(positions, cfg.d_head, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    if impl == "kernel" and cfg.causal and not cfg.cross:
        out = kops.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=True,
                                   window=cfg.window)
    else:
        scores = _gqa_scores(q, k, 1.0 / math.sqrt(cfg.d_head))
        if cfg.cross:
            probs = torch.softmax(scores, dim=-1)
        else:
            probs = _masked_softmax(scores, causal_window_mask(
                L, S, causal=cfg.causal, window=cfg.window, device=x.device))
        out = _gqa_out(probs, v).to(compute_dtype)
    y = linear(p["o"], _merge_heads(out), compute_dtype=compute_dtype)
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


def _row_positions(pos, B: int, device) -> torch.Tensor:
    """A scalar or (B,) position -> (B,) int64 on ``device``."""
    pos = torch.as_tensor(pos, device=device).to(torch.int64)
    return pos.expand(B) if pos.dim() == 0 else pos.reshape(B)


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
    dev = x.device
    q = _split_heads(linear(p["q"], x, compute_dtype=compute_dtype),
                     cfg.n_heads, cfg.d_head)
    if cfg.cross:
        if cfg.qk_norm:
            q = rmsnorm(p["q_norm"], q)
        probs = torch.softmax(_gqa_scores(q, cache["k"], 1.0 / math.sqrt(
            cfg.d_head)), dim=-1)
        out = _gqa_out(probs, cache["v"]).to(compute_dtype)
        return linear(p["o"], _merge_heads(out),
                      compute_dtype=compute_dtype), cache
    pos = _row_positions(pos, B, dev)
    k_new = _split_heads(linear(p["k"], x, compute_dtype=compute_dtype),
                         cfg.n_kv_heads, cfg.d_head)
    v_new = _split_heads(linear(p["v"], x, compute_dtype=compute_dtype),
                         cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k_new = rmsnorm(p["k_norm"], k_new)
    if cfg.rope:
        cos, sin = rope_cos_sin(pos[:, None], cfg.d_head, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k_new = apply_rope(k_new, cos, sin)

    S = cache["k"].shape[1]
    ring = cfg.ring and cfg.window is not None
    write_at = torch.remainder(pos, S) if ring else pos.clamp(0, S - 1)
    rows = torch.arange(B, device=dev)
    k = cache["k"].clone()
    v = cache["v"].clone()
    k[rows, write_at] = k_new[:, 0].to(k.dtype)
    v[rows, write_at] = v_new[:, 0].to(v.dtype)

    scores = _gqa_scores(q, k, 1.0 / math.sqrt(cfg.d_head))  # (B,Hkv,G,1,S)
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
    out = _gqa_out(probs, v).to(compute_dtype)
    y = linear(p["o"], _merge_heads(out), compute_dtype=compute_dtype)
    return y, {"k": k, "v": v}
