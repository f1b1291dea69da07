"""Composable blocks (port of ``repro.models.blocks``): an optional
sequence mixer (GQA attention, MLA or Mamba2-SSD), an optional
cross-attention over encoder states, and an optional FFN (dense SwiGLU or
GELU, or MoE), each pre-normed with a residual.  Blocks are assembled into
groups by :mod:`repro_torch.models.lm`; a MoE FFN's load-balance loss
comes back as the block's aux, as in the reference.  ``block_spec`` and
``block_cache_spec`` are the reference's PartitionSpec trees; under a
mesh the residual stream crosses the reference's ``constrain`` after
each full-sequence block.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.nn import core
from repro_torch.nn.attention import (AttnCfg, attn_decode, attn_forward,
                                      attn_init, attn_spec, init_kv_cache,
                                      kv_cache_spec)
from repro_torch.nn.mla import (MLACfg, init_mla_cache, mla_cache_spec,
                                mla_decode, mla_forward, mla_init, mla_spec)
from repro_torch.nn.mlp import MLPCfg, mlp_apply, mlp_init, mlp_spec
from repro_torch.nn.moe import MoECfg, moe_apply, moe_init, moe_spec
from repro_torch.nn.sharding import (batch_spec, constrain, gather_dim,
                                     is_dtensor, like)
from repro_torch.nn.ssm import (SSMCfg, init_ssm_state, ssm_decode,
                                ssm_forward, ssm_init, ssm_spec,
                                ssm_state_spec)


@dataclasses.dataclass(frozen=True)
class BlockCfg:
    d_model: int
    mixer: str = "attn"            # "attn" | "mla" | "ssm" | "none"
    ffn: str = "mlp"               # "mlp" | "moe" | "none"
    norm: str = "rms"              # "rms" | "ln" | "ln_np" (OLMo)
    attn: Optional[AttnCfg] = None
    mla: Optional[MLACfg] = None
    ssm: Optional[SSMCfg] = None
    mlp: Optional[MLPCfg] = None
    moe: Optional[MoECfg] = None
    cross: Optional[AttnCfg] = None  # cross-attention (enc-dec decoder)
    shared: bool = False           # one parameter set for every repeat


# -- norms ----------------------------------------------------------------------

def _norm_init(kind: str, d: int, dtype, device):
    if kind == "rms":
        return core.rmsnorm_init(d, dtype, device)
    if kind in ("ln", "ln_np"):
        return core.layernorm_init(d, elementwise=kind == "ln", dtype=dtype,
                                   device=device)
    raise ValueError(kind)


def _norm_spec(kind: str) -> dict:
    if kind == "rms":
        return core.rmsnorm_spec()
    if kind in ("ln", "ln_np"):
        return core.layernorm_spec(elementwise=kind == "ln")
    raise ValueError(kind)


def _norm_apply(kind: str, p, x):
    if kind == "rms":
        return core.rmsnorm(p, x)
    return core.layernorm(p, x)


# -- init -------------------------------------------------------------------------

MIXERS = ("attn", "mla", "ssm", "none")
FFNS = ("mlp", "moe", "none")


def block_init(generator: torch.Generator, cfg: BlockCfg, *,
               dtype=torch.float32) -> dict:
    if cfg.mixer not in MIXERS or cfg.ffn not in FFNS:
        raise ValueError(f"block of mixer {cfg.mixer!r} and ffn {cfg.ffn!r}:"
                         f" mixer must be one of {MIXERS}, ffn one of {FFNS}")
    dev = generator.device
    p = {}
    if cfg.mixer != "none":
        p["norm1"] = _norm_init(cfg.norm, cfg.d_model, dtype, dev)
    if cfg.mixer == "attn":
        p["mixer"] = attn_init(generator, cfg.attn, dtype=dtype)
    elif cfg.mixer == "mla":
        p["mixer"] = mla_init(generator, cfg.mla, dtype=dtype)
    elif cfg.mixer == "ssm":
        p["mixer"] = ssm_init(generator, cfg.ssm, dtype=dtype)
    if cfg.cross is not None:
        p["norm_cross"] = _norm_init(cfg.norm, cfg.d_model, dtype, dev)
        p["cross"] = attn_init(generator, cfg.cross, dtype=dtype)
    if cfg.ffn != "none":
        p["norm2"] = _norm_init(cfg.norm, cfg.d_model, dtype, dev)
    if cfg.ffn == "mlp":
        p["ffn"] = mlp_init(generator, cfg.mlp, dtype=dtype)
    elif cfg.ffn == "moe":
        p["ffn"] = moe_init(generator, cfg.moe, dtype=dtype)
    return p


def block_spec(cfg: BlockCfg) -> dict:
    s = {}
    if cfg.mixer != "none":
        s["norm1"] = _norm_spec(cfg.norm)
    if cfg.mixer == "attn":
        s["mixer"] = attn_spec(cfg.attn)
    elif cfg.mixer == "mla":
        s["mixer"] = mla_spec(cfg.mla)
    elif cfg.mixer == "ssm":
        s["mixer"] = ssm_spec(cfg.ssm)
    if cfg.cross is not None:
        s["norm_cross"] = _norm_spec(cfg.norm)
        s["cross"] = attn_spec(cfg.cross)
    if cfg.ffn != "none":
        s["norm2"] = _norm_spec(cfg.norm)
    if cfg.ffn == "mlp":
        s["ffn"] = mlp_spec(cfg.mlp)
    elif cfg.ffn == "moe":
        s["ffn"] = moe_spec(cfg.moe)
    return s


# -- forward (full sequence) -----------------------------------------------------

def _cross_and_ffn(p, cfg: BlockCfg, x, enc, compute_dtype, *,
                   cross_cache=None, route_rows: bool = False):
    """The cross-attention (over ``enc``, or the static K/V of
    ``cross_cache`` in decode) and the FFN.  Returns (x, aux, cross K/V
    when ``enc`` is given)."""
    aux = x.new_zeros((), dtype=torch.float32)
    kv = None
    if cfg.cross is not None:
        xn = _norm_apply(cfg.norm, p["norm_cross"], x)
        if cross_cache is not None:
            y, _ = attn_decode(p["cross"], cfg.cross, xn, cross_cache, 0,
                               compute_dtype=compute_dtype)
        else:
            y, kv = attn_forward(p["cross"], cfg.cross, xn, kv_src=enc,
                                 compute_dtype=compute_dtype, return_kv=True)
        x = x + y
    if cfg.ffn == "mlp":
        x = x + mlp_apply(p["ffn"], cfg.mlp,
                          _norm_apply(cfg.norm, p["norm2"], x),
                          compute_dtype=compute_dtype)
    elif cfg.ffn == "moe":
        y, a = moe_apply(p["ffn"], cfg.moe,
                         _norm_apply(cfg.norm, p["norm2"], x),
                         compute_dtype=compute_dtype, route_rows=route_rows)
        x = x + y
        aux = aux + a
    return x, aux, kv


def block_forward(p, cfg: BlockCfg, x, *, positions=None, enc=None,
                  impl: str = "kernel", compute_dtype=torch.bfloat16):
    """x: (B, L, D) -> (x, aux_loss); ``enc`` the encoder states of a
    cross-attention block; aux is 0 without MoE."""
    if cfg.mixer == "attn":
        x = x + attn_forward(p["mixer"], cfg.attn,
                             _norm_apply(cfg.norm, p["norm1"], x),
                             positions=positions, impl=impl,
                             compute_dtype=compute_dtype)
    elif cfg.mixer == "mla":
        x = x + mla_forward(p["mixer"], cfg.mla,
                            _norm_apply(cfg.norm, p["norm1"], x),
                            positions=positions, impl=impl,
                            compute_dtype=compute_dtype)
    elif cfg.mixer == "ssm":
        x = x + ssm_forward(p["mixer"], cfg.ssm,
                            _norm_apply(cfg.norm, p["norm1"], x),
                            impl=impl, compute_dtype=compute_dtype)
    x, aux, _ = _cross_and_ffn(p, cfg, x, enc, compute_dtype)
    return constrain(x, batch_spec(None, None)), aux


# -- cache / prefill / decode -------------------------------------------------------

def block_init_cache(cfg: BlockCfg, B: int, S: int, *, enc_len: int = 0,
                     dtype=torch.bfloat16, device=None) -> dict:
    c = {}
    if cfg.mixer == "attn":
        c["mixer"] = init_kv_cache(B, S, cfg.attn, dtype, device)
    elif cfg.mixer == "mla":
        c["mixer"] = init_mla_cache(B, S, cfg.mla, dtype, device)
    elif cfg.mixer == "ssm":
        c["mixer"] = init_ssm_state(B, cfg.ssm, dtype, device)
    if cfg.cross is not None:
        c["cross"] = init_kv_cache(B, enc_len, cfg.cross, dtype, device)
    return c


def block_cache_spec(cfg: BlockCfg, *, seq_shard=None) -> dict:
    """seq_shard: mesh axis to shard the cache *sequence* dim over (used
    when kv-heads cannot fill the model axis, e.g. long-context
    decode)."""
    c = {}
    if cfg.mixer == "attn":
        if seq_shard is not None:
            c["mixer"] = {"k": batch_spec(seq_shard, None, None),
                          "v": batch_spec(seq_shard, None, None)}
        else:
            c["mixer"] = kv_cache_spec(cfg.attn)
    elif cfg.mixer == "mla":
        c["mixer"] = mla_cache_spec(cfg.mla)
    elif cfg.mixer == "ssm":
        c["mixer"] = ssm_state_spec(cfg.ssm)
    if cfg.cross is not None:
        c["cross"] = kv_cache_spec(cfg.cross)
    return c


def _write_prefix(cache: dict, new: dict) -> dict:
    """Each leaf of ``cache`` (B, S, ...) with its first L positions set to
    ``new``'s (B, L, ...) leaf; the cache passed in is not changed.  A
    DTensor cache is written on its local shards with the sequence
    gathered, and comes back in its own layout."""
    out = {}
    for k, c in cache.items():
        L = new[k].shape[1]
        if L > c.shape[1]:
            raise ValueError(f"prefill of {L} tokens into a cache of "
                             f"{c.shape[1]}")
        if is_dtensor(c):
            from torch.distributed.tensor import DTensor
            whole = gather_dim(c, 1)
            loc = whole.to_local().clone()
            loc[:, :L] = like(new[k].to(c.dtype), whole).to_local()
            out[k] = like(DTensor.from_local(loc, whole.device_mesh,
                                             whole.placements,
                                             run_check=False), c)
            continue
        c = c.clone()
        c[:, :L] = new[k].to(c.dtype)
        out[k] = c
    return out


def block_prefill(p, cfg: BlockCfg, x, cache, *, positions=None, enc=None,
                  impl: str = "kernel", compute_dtype=torch.bfloat16):
    """Full-sequence forward that also fills the cache at positions
    [0, L) (and a cross-attention block's cache with the encoder's K/V).
    Returns (x, new_cache, aux)."""
    new = dict(cache)
    xn = (_norm_apply(cfg.norm, p["norm1"], x) if cfg.mixer != "none"
          else None)
    if cfg.mixer == "attn":
        y, (k, v) = attn_forward(p["mixer"], cfg.attn, xn,
                                 positions=positions, impl=impl,
                                 compute_dtype=compute_dtype, return_kv=True)
        x = x + y
        new["mixer"] = _write_prefix(cache["mixer"], {"k": k, "v": v})
    elif cfg.mixer == "mla":
        y, (c_kv, k_rope) = mla_forward(p["mixer"], cfg.mla, xn,
                                        positions=positions, impl=impl,
                                        compute_dtype=compute_dtype,
                                        return_kv=True)
        x = x + y
        new["mixer"] = _write_prefix(cache["mixer"],
                                     {"c_kv": c_kv, "k_rope": k_rope})
    elif cfg.mixer == "ssm":
        y, st = ssm_forward(p["mixer"], cfg.ssm, xn, impl=impl,
                            compute_dtype=compute_dtype, return_state=True)
        x = x + y
        new["mixer"] = {
            "conv": like(st["conv"].to(cache["mixer"]["conv"].dtype),
                         cache["mixer"]["conv"]),
            "ssm": like(st["ssm"], cache["mixer"]["ssm"])}
    x, aux, kv = _cross_and_ffn(p, cfg, x, enc, compute_dtype)
    if kv is not None:
        new["cross"] = {k: like(t.to(cache["cross"][k].dtype),
                                cache["cross"][k])
                        for k, t in zip(("k", "v"), kv)}
    return constrain(x, batch_spec(None, None)), new, aux


def block_decode(p, cfg: BlockCfg, x, cache, pos, *,
                 compute_dtype=torch.bfloat16, route_rows: bool = False):
    """One-token step.  x: (B, 1, D); pos: scalar or (B,) int.
    ``route_rows``: a MoE FFN routes each row on its own (the reference's
    engine maps its decode over the rows)."""
    new = dict(cache)
    if cfg.mixer == "attn":
        y, new["mixer"] = attn_decode(p["mixer"], cfg.attn,
                                      _norm_apply(cfg.norm, p["norm1"], x),
                                      cache["mixer"], pos,
                                      compute_dtype=compute_dtype)
        x = x + y
    elif cfg.mixer == "mla":
        y, new["mixer"] = mla_decode(p["mixer"], cfg.mla,
                                     _norm_apply(cfg.norm, p["norm1"], x),
                                     cache["mixer"], pos,
                                     compute_dtype=compute_dtype)
        x = x + y
    elif cfg.mixer == "ssm":
        y, new["mixer"] = ssm_decode(p["mixer"], cfg.ssm,
                                     _norm_apply(cfg.norm, p["norm1"], x),
                                     cache["mixer"],
                                     compute_dtype=compute_dtype)
        x = x + y
    x, _, _ = _cross_and_ffn(p, cfg, x, None, compute_dtype,
                             cross_cache=cache.get("cross"),
                             route_rows=route_rows)
    return x, new
