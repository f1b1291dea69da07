"""Multi-head Latent Attention (DeepSeek-V2/V3), port of ``repro.nn.mla``.

Prefill uses the expanded formulation: ``kv_up`` expands the compressed
``c_kv`` into per-head K (no RoPE part) and V, and the scores are plain
products, as the reference's einsums are (no Pallas kernel there).
Decode uses the absorbed formulation: ``W_uk`` folded into the query and
``W_uv`` applied after the weighted sum, so the per-token cache is just
``c_kv`` (kv_lora_rank) and the shared RoPE key ``k_rope``.  The cache
``{"c_kv": (B, S, C), "k_rope": (B, S, d_rope)}`` leads with the batch
like the attention cache, and decode takes one position per batch row.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .attention import _masked_softmax, _row_positions, causal_window_mask
from .core import linear, linear_init, rmsnorm, rmsnorm_init
from .rotary import apply_rope, rope_cos_sin


@dataclasses.dataclass(frozen=True)
class MLACfg:
    d_model: int
    n_heads: int
    q_lora_rank: int = 0          # 0 -> direct q projection
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0
    causal: bool = True
    window: Optional[int] = None


def mla_init(generator: torch.Generator, cfg: MLACfg, *,
             dtype=torch.float32) -> dict:
    H = cfg.n_heads
    qd = cfg.qk_nope_dim + cfg.qk_rope_dim
    dev = generator.device
    p = {}
    if cfg.q_lora_rank:
        p["q_down"] = linear_init(generator, cfg.d_model, cfg.q_lora_rank,
                                  dtype=dtype)
        p["q_norm"] = rmsnorm_init(cfg.q_lora_rank, dtype, dev)
        p["q_up"] = linear_init(generator, cfg.q_lora_rank, H * qd,
                                dtype=dtype)
    else:
        p["q_proj"] = linear_init(generator, cfg.d_model, H * qd,
                                  dtype=dtype)
    p["kv_down"] = linear_init(generator, cfg.d_model,
                               cfg.kv_lora_rank + cfg.qk_rope_dim,
                               dtype=dtype)
    p["kv_norm"] = rmsnorm_init(cfg.kv_lora_rank, dtype, dev)
    p["kv_up"] = linear_init(generator, cfg.kv_lora_rank,
                             H * (cfg.qk_nope_dim + cfg.v_head_dim),
                             dtype=dtype)
    p["o"] = linear_init(generator, H * cfg.v_head_dim, cfg.d_model,
                         dtype=dtype)
    return p


def _project_q(p, cfg: MLACfg, x, compute_dtype):
    if cfg.q_lora_rank:
        qc = rmsnorm(p["q_norm"], linear(p["q_down"], x,
                                         compute_dtype=compute_dtype))
        q = linear(p["q_up"], qc, compute_dtype=compute_dtype)
    else:
        q = linear(p["q_proj"], x, compute_dtype=compute_dtype)
    q = q.reshape(x.shape[:-1] + (cfg.n_heads,
                                  cfg.qk_nope_dim + cfg.qk_rope_dim))
    return q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]


def _compress_kv(p, cfg: MLACfg, x, positions, compute_dtype):
    """(c_kv normalised (B, S, C), k_rope roped (B, S, 1, d_rope))."""
    ckr = linear(p["kv_down"], x, compute_dtype=compute_dtype)
    c_kv = rmsnorm(p["kv_norm"], ckr[..., :cfg.kv_lora_rank])
    k_rope = ckr[..., cfg.kv_lora_rank:][..., None, :]  # one shared head
    cos, sin = rope_cos_sin(positions, cfg.qk_rope_dim, cfg.rope_theta)
    return c_kv, apply_rope(k_rope, cos, sin)


def _scale(cfg: MLACfg) -> float:
    return 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)


def mla_forward(p, cfg: MLACfg, x, *, positions=None,
                compute_dtype=torch.bfloat16, return_kv: bool = False):
    """Full-sequence MLA (prefill), expanded formulation.  x: (B, L, D).
    With ``return_kv`` also (c_kv (B, L, C), k_rope (B, L, d_rope)), what
    the decode cache holds."""
    B, L, _ = x.shape
    H = cfg.n_heads
    if positions is None:
        positions = torch.arange(L, device=x.device)
    q_nope, q_rope = _project_q(p, cfg, x, compute_dtype)
    cos, sin = rope_cos_sin(positions, cfg.qk_rope_dim, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    c_kv, k_rope = _compress_kv(p, cfg, x, positions, compute_dtype)
    kv = linear(p["kv_up"], c_kv, compute_dtype=compute_dtype)
    kv = kv.reshape(B, L, H, cfg.qk_nope_dim + cfg.v_head_dim)
    k_nope, v = kv[..., :cfg.qk_nope_dim], kv[..., cfg.qk_nope_dim:]
    # bf16 operands, f32 products and sums (preferred_element_type=f32)
    scores = (torch.einsum("blhd,bshd->bhls", q_nope.float(), k_nope.float())
              + torch.einsum("blhd,bsd->bhls", q_rope.float(),
                             k_rope[:, :, 0].float())) * _scale(cfg)
    mask = causal_window_mask(L, L, causal=cfg.causal, window=cfg.window,
                              device=x.device)
    probs = _masked_softmax(scores, mask)
    out = torch.einsum("bhls,bshd->blhd", probs, v.float())
    out = out.to(compute_dtype).reshape(B, L, H * cfg.v_head_dim)
    y = linear(p["o"], out, compute_dtype=compute_dtype)
    if return_kv:
        return y, (c_kv, k_rope[:, :, 0, :])
    return y


def init_mla_cache(B: int, S: int, cfg: MLACfg, dtype=torch.bfloat16,
                   device=None) -> dict:
    return {"c_kv": torch.zeros((B, S, cfg.kv_lora_rank), dtype=dtype,
                                device=device),
            "k_rope": torch.zeros((B, S, cfg.qk_rope_dim), dtype=dtype,
                                  device=device)}


def mla_decode(p, cfg: MLACfg, x, cache, pos, *,
               compute_dtype=torch.bfloat16):
    """One-token absorbed-MLA decode.  x: (B, 1, D); cache ``{"c_kv",
    "k_rope"}``; pos: scalar or (B,) int, each row's absolute position (a
    position at or past S writes the last slot, the reference's clamp).
    Returns (y, new_cache); the cache passed in is not changed."""
    B = x.shape[0]
    H, C = cfg.n_heads, cfg.kv_lora_rank
    dev = x.device
    pos = _row_positions(pos, B, dev)
    q_nope, q_rope = _project_q(p, cfg, x, compute_dtype)    # (B, 1, H, *)
    cos, sin = rope_cos_sin(pos[:, None], cfg.qk_rope_dim, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    c_new, kr_new = _compress_kv(p, cfg, x, pos[:, None], compute_dtype)
    S = cache["c_kv"].shape[1]
    rows = torch.arange(B, device=dev)
    write_at = pos.clamp(0, S - 1)
    c_kv, k_rope = cache["c_kv"].clone(), cache["k_rope"].clone()
    c_kv[rows, write_at] = c_new[:, 0].to(c_kv.dtype)
    k_rope[rows, write_at] = kr_new[:, 0, 0].to(k_rope.dtype)

    W = p["kv_up"]["w"].to(compute_dtype).reshape(
        C, H, cfg.qk_nope_dim + cfg.v_head_dim)
    W_uk, W_uv = W[..., :cfg.qk_nope_dim], W[..., cfg.qk_nope_dim:]
    q_lat = torch.einsum("blhd,chd->blhc", q_nope, W_uk)     # absorbed
    scores = (torch.einsum("blhc,bsc->bhls", q_lat.float(), c_kv.float())
              + torch.einsum("blhd,bsd->bhls", q_rope.float(),
                             k_rope.float())) * _scale(cfg)
    kpos = torch.arange(S, device=dev)[None, :]
    valid = kpos <= pos[:, None]
    if cfg.window is not None:
        valid &= kpos > pos[:, None] - cfg.window
    probs = _masked_softmax(scores, valid[:, None, None, :])
    ctx = torch.einsum("bhls,bsc->blhc", probs, c_kv.float())
    out = torch.einsum("blhc,chv->blhv", ctx.to(compute_dtype), W_uv)
    y = linear(p["o"], out.reshape(B, 1, H * cfg.v_head_dim),
               compute_dtype=compute_dtype)
    return y, {"c_kv": c_kv, "k_rope": k_rope}
