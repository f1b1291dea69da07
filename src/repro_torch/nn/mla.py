"""Multi-head Latent Attention (DeepSeek-V2/V3), port of ``repro.nn.mla``.

Prefill uses the expanded formulation: ``kv_up`` expands the compressed
``c_kv`` into per-head K (no RoPE part) and V.  With ``impl="plain"`` the
scores are plain products, as the reference's einsums are (no Pallas
kernel there); with ``impl="kernel"`` (the engine's prefill) q is
(q_nope, q_rope) and k is (k_nope, the shared k_rope on every head),
and the causal attention runs in ``kernels.ops.flash_attention`` at the
head pair (nope + rope, v) where the kernel is built for it
(``ops.FLASH_HEAD_PAIRS``: (192, 128), DeepSeek-V2/V3's widths), with
MLA's own scale; at other widths (the smoke configs) the plain products
run, and ``ops.PLAIN_PREFILLS["mla"]`` counts the prefill.
Decode uses the absorbed formulation: ``W_uk`` folded into the query and
``W_uv`` applied after the weighted sum, so the per-token cache is just
``c_kv`` (kv_lora_rank) and the shared RoPE key ``k_rope``.  The cache
``{"c_kv": (B, S, C), "k_rope": (B, S, d_rope)}`` leads with the batch
like the attention cache, and decode takes one position per batch row.

Under a mesh (DTensor parameters and inputs) the projections run as
DTensor products and the attention runs on this rank's heads in a local
region (``sharding.Region``) opened at the reference's ``constrain`` of
k and v (q, its heads sharded as ``q_up``/``q_proj`` are, crosses with
them); the shared RoPE key and the tables are made there.  The cache,
sequence-sharded by ``mla_cache_spec``, is gathered for decode, as the
reference's GSPMD does, and handed back in its own layout.

``rope_scaling`` (a ``rotary.YaRN``, DeepSeek-V3's) stretches the RoPE
part's frequencies and multiplies the softmax scale by
``yarn_mscale(factor, mscale_all_dim)`` squared, in prefill and in the
absorbed decode alike.  Spans (``obs.profiling``): ``mla.prefill`` over
``mla_forward``, ``mla.decode`` over ``mla_decode``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.obs import profiling

from .attention import _masked_softmax, _row_positions, causal_window_mask
from .core import linear, linear_init, rmsnorm, rmsnorm_init
from .rotary import YaRN, apply_rope, rope_cos_sin, yarn_mscale
from .sharding import P, Region, batch_spec, constrain, gather_dim, like, \
    split_last


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
    rope_scaling: Optional[YaRN] = None


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


def mla_spec(cfg: MLACfg) -> dict:
    s = {"kv_down": {"w": P(None, None)},
         "kv_norm": {"scale": P(None)},
         "kv_up": {"w": P(None, "model")},
         "o": {"w": P("model", None)}}
    if cfg.q_lora_rank:
        s["q_down"] = {"w": P(None, None)}
        s["q_norm"] = {"scale": P(None)}
        s["q_up"] = {"w": P(None, "model")}
    else:
        s["q_proj"] = {"w": P(None, "model")}
    return s


def _heads_spec() -> P:
    return batch_spec(None, "model", None)


def _project_q(p, cfg: MLACfg, x, compute_dtype):
    """q (B, L, H, nope + rope), heads last but one."""
    if cfg.q_lora_rank:
        qc = rmsnorm(p["q_norm"], linear(p["q_down"], x,
                                         compute_dtype=compute_dtype))
        q = linear(p["q_up"], qc, compute_dtype=compute_dtype)
    else:
        q = linear(p["q_proj"], x, compute_dtype=compute_dtype)
    return split_last(q, cfg.n_heads, cfg.qk_nope_dim + cfg.qk_rope_dim)


def _compress_kv(p, cfg: MLACfg, x, compute_dtype):
    """(c_kv normalised (B, S, C), the shared RoPE key before RoPE (B, S,
    1, d_rope))."""
    ckr = linear(p["kv_down"], x, compute_dtype=compute_dtype)
    c_kv = rmsnorm(p["kv_norm"], ckr[..., :cfg.kv_lora_rank])
    return c_kv, ckr[..., cfg.kv_lora_rank:][..., None, :]


def _rope(cfg: MLACfg, t, positions):
    cos, sin = rope_cos_sin(positions, cfg.qk_rope_dim, cfg.rope_theta,
                            cfg.rope_scaling)
    return apply_rope(t, cos, sin)


def _scale(cfg: MLACfg) -> float:
    """The softmax scale: 1 / sqrt(nope + rope), times YaRN's mscale
    squared where the config stretches the context."""
    s = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    y = cfg.rope_scaling
    if y is not None and y.mscale_all_dim:
        s *= yarn_mscale(y.factor, y.mscale_all_dim) ** 2
    return s


def _flash(cfg: MLACfg, q_nope, q_rope, k_nope, k_rope, v):
    """The causal attention of the expanded formulation through
    ``flash_attention`` at (nope + rope, v): (B, L, H, v)."""
    H = q_nope.shape[2]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(-1, -1, H, -1)], dim=-1)
    return kops.flash_attention(q, k, v.contiguous(), causal=cfg.causal,
                                window=cfg.window, scale=_scale(cfg))


def _uses_flash(cfg: MLACfg, impl: str) -> bool:
    return impl == "kernel" and (cfg.qk_nope_dim + cfg.qk_rope_dim,
                                 cfg.v_head_dim) in kops.FLASH_HEAD_PAIRS


def mla_forward(p, cfg: MLACfg, x, *, positions=None, impl: str = "plain",
                compute_dtype=torch.bfloat16, return_kv: bool = False):
    """Full-sequence MLA (prefill), expanded formulation.  x: (B, L, D).
    ``impl``: ``"kernel"`` sends the attention through ``flash_attention``
    where it is built for the head pair (module docstring; elsewhere the
    plain products, counted in ``ops.PLAIN_PREFILLS["mla"]``); anything
    else runs the plain products.  With ``return_kv`` also (c_kv (B, L, C),
    k_rope (B, L, d_rope)), what the decode cache holds."""
    with profiling.span("mla.prefill"):
        return _mla_forward(p, cfg, x, positions, impl, compute_dtype,
                            return_kv)


def _mla_forward(p, cfg: MLACfg, x, positions, impl, compute_dtype,
                 return_kv):
    B, L, _ = x.shape
    H = cfg.n_heads
    q = _project_q(p, cfg, x, compute_dtype)
    c_kv, kr = _compress_kv(p, cfg, x, compute_dtype)
    kv = split_last(linear(p["kv_up"], c_kv, compute_dtype=compute_dtype),
                    H, cfg.qk_nope_dim + cfg.v_head_dim)
    kv = constrain(kv, _heads_spec())
    # the local region: this rank's heads
    reg = Region(q)
    q = reg.open(q, _heads_spec())
    kr_pl = getattr(kr, "placements", None)
    kv, kr = reg.take(kv), reg.take(kr)
    if positions is None:
        positions = torch.arange(L, device=q.device)
    q_nope = q[..., :cfg.qk_nope_dim]
    q_rope = _rope(cfg, q[..., cfg.qk_nope_dim:], positions)
    k_rope = _rope(cfg, kr, positions)
    k_nope, v = kv[..., :cfg.qk_nope_dim], kv[..., cfg.qk_nope_dim:]
    if _uses_flash(cfg, impl):
        out = _flash(cfg, q_nope, q_rope, k_nope, k_rope, v)
    else:
        if impl == "kernel":
            kops.PLAIN_PREFILLS["mla"] += 1
        # bf16 operands, f32 products and sums (preferred_element_type=f32)
        scores = (torch.einsum("blhd,bshd->bhls", q_nope.float(),
                               k_nope.float())
                  + torch.einsum("blhd,bsd->bhls", q_rope.float(),
                                 k_rope[:, :, 0].float())) * _scale(cfg)
        mask = causal_window_mask(L, L, causal=cfg.causal,
                                  window=cfg.window, device=q.device)
        probs = _masked_softmax(scores, mask)
        out = torch.einsum("bhls,bshd->blhd", probs, v.float())
    out = out.to(compute_dtype).reshape(out.shape[:2] + (-1,))
    k_rope = k_rope[:, :, 0, :]
    if reg.active:
        out = reg.give_spec(out, reg.spec(None, "model"))
        k_rope = reg.give(k_rope, kr_pl)
    y = linear(p["o"], out, compute_dtype=compute_dtype)
    if return_kv:
        return y, (c_kv, k_rope)
    return y


def init_mla_cache(B: int, S: int, cfg: MLACfg, dtype=torch.bfloat16,
                   device=None) -> dict:
    return {"c_kv": torch.zeros((B, S, cfg.kv_lora_rank), dtype=dtype,
                                device=device),
            "k_rope": torch.zeros((B, S, cfg.qk_rope_dim), dtype=dtype,
                                  device=device)}


def mla_cache_spec(cfg: MLACfg) -> dict:
    # no head dim -> shard sequence over "model" so huge contexts fit.
    return {"c_kv": batch_spec("model", None),
            "k_rope": batch_spec("model", None)}


def mla_decode(p, cfg: MLACfg, x, cache, pos, *,
               compute_dtype=torch.bfloat16):
    """One-token absorbed-MLA decode.  x: (B, 1, D); cache ``{"c_kv",
    "k_rope"}``; pos: scalar or (B,) int, each row's absolute position (a
    position at or past S writes the last slot, the reference's clamp).
    Returns (y, new_cache); the cache passed in is not changed."""
    with profiling.span("mla.decode"):
        return _mla_decode(p, cfg, x, cache, pos, compute_dtype)


def _mla_decode(p, cfg: MLACfg, x, cache, pos, compute_dtype):
    B = x.shape[0]
    C = cfg.kv_lora_rank
    q = _project_q(p, cfg, x, compute_dtype)                # (B, 1, H, *)
    c_new, kr_new = _compress_kv(p, cfg, x, compute_dtype)
    # the local region: this rank's heads over the whole (gathered) cache
    reg = Region(q)
    q = reg.open(q, _heads_spec())
    cache_l = {k: gather_dim(c, 1) for k, c in cache.items()}
    pls = {k: getattr(c, "placements", None) for k, c in cache_l.items()}
    c_kv, k_rope = reg.take(cache_l["c_kv"]), reg.take(cache_l["k_rope"])
    c_new, kr_new = reg.take(c_new), reg.take(kr_new)
    W = reg.take(p["kv_up"]["w"], P(None, "model" if reg.sharded("model")
                                    else None))
    dev = q.device
    pos = _row_positions(pos, B, dev, reg if reg.active else None)
    q_nope = q[..., :cfg.qk_nope_dim]
    q_rope = _rope(cfg, q[..., cfg.qk_nope_dim:], pos[:, None])
    kr_new = _rope(cfg, kr_new, pos[:, None])
    S = c_kv.shape[1]
    rows = torch.arange(c_kv.shape[0], device=dev)
    write_at = pos.clamp(0, S - 1)
    c_kv, k_rope = c_kv.clone(), k_rope.clone()
    c_kv[rows, write_at] = c_new[:, 0].to(c_kv.dtype)
    k_rope[rows, write_at] = kr_new[:, 0, 0].to(k_rope.dtype)

    W = W.to(compute_dtype).reshape(C, -1, cfg.qk_nope_dim + cfg.v_head_dim)
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
    out = out.reshape(out.shape[:2] + (-1,))
    if reg.active:
        out = reg.give_spec(out, reg.spec(None, "model"))
        c_kv = like(reg.give(c_kv, pls["c_kv"]), cache["c_kv"])
        k_rope = like(reg.give(k_rope, pls["k_rope"]), cache["k_rope"])
    y = linear(p["o"], out, compute_dtype=compute_dtype)
    return y, {"c_kv": c_kv, "k_rope": k_rope}
