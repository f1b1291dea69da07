"""Composable blocks (port of ``repro.models.blocks``): an optional
sequence mixer (GQA attention or Mamba2-SSD) and an optional dense FFN,
each pre-normed with a residual.  Blocks are assembled into groups by
:mod:`repro_torch.models.lm`.

MLA, MoE and cross-attention are not ported yet and raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.nn import core
from repro_torch.nn.attention import (AttnCfg, attn_decode, attn_forward,
                                      attn_init, init_kv_cache)
from repro_torch.nn.mlp import MLPCfg, mlp_apply, mlp_init
from repro_torch.nn.ssm import (SSMCfg, init_ssm_state, ssm_decode,
                                ssm_forward, ssm_init)

_TODO = {
    "mla": "MLA mixers are not ported yet (ROADMAP queue A: MLA/MoE)",
    "moe": "MoE FFNs are not ported yet (ROADMAP queue A: MLA/MoE)",
    "cross": ("cross-attention blocks are not ported yet (ROADMAP queue A: "
              "whisper)"),
}


@dataclasses.dataclass(frozen=True)
class BlockCfg:
    d_model: int
    mixer: str = "attn"            # "attn" | "mla" | "ssm" | "none"
    ffn: str = "mlp"               # "mlp" | "moe" | "none"
    norm: str = "rms"              # "rms" | "ln" | "ln_np" (OLMo)
    attn: Optional[AttnCfg] = None
    mla: Optional[Any] = None
    ssm: Optional[SSMCfg] = None
    mlp: Optional[MLPCfg] = None
    moe: Optional[Any] = None
    cross: Optional[AttnCfg] = None
    shared: bool = False           # one parameter set for every repeat


def check_ported(cfg: BlockCfg) -> None:
    """Raise ``NotImplementedError`` for the parts that are not ported."""
    for part in ("mla", "moe"):
        if part in (cfg.mixer, cfg.ffn):
            raise NotImplementedError(_TODO[part])
    if cfg.cross is not None:
        raise NotImplementedError(_TODO["cross"])
    if cfg.mixer not in ("attn", "ssm", "none") \
            or cfg.ffn not in ("mlp", "none"):
        raise ValueError(f"unknown mixer/ffn {cfg.mixer}/{cfg.ffn}")


# -- norms ----------------------------------------------------------------------

def _norm_init(kind: str, d: int, dtype, device):
    if kind == "rms":
        return core.rmsnorm_init(d, dtype, device)
    if kind in ("ln", "ln_np"):
        return core.layernorm_init(d, elementwise=kind == "ln", dtype=dtype,
                                   device=device)
    raise ValueError(kind)


def _norm_apply(kind: str, p, x):
    if kind == "rms":
        return core.rmsnorm(p, x)
    return core.layernorm(p, x)


# -- init -------------------------------------------------------------------------

def block_init(generator: torch.Generator, cfg: BlockCfg, *,
               dtype=torch.float32) -> dict:
    check_ported(cfg)
    dev = generator.device
    p = {}
    if cfg.mixer != "none":
        p["norm1"] = _norm_init(cfg.norm, cfg.d_model, dtype, dev)
    if cfg.mixer == "attn":
        p["mixer"] = attn_init(generator, cfg.attn, dtype=dtype)
    elif cfg.mixer == "ssm":
        p["mixer"] = ssm_init(generator, cfg.ssm, dtype=dtype)
    if cfg.ffn != "none":
        p["norm2"] = _norm_init(cfg.norm, cfg.d_model, dtype, dev)
        p["ffn"] = mlp_init(generator, cfg.mlp, dtype=dtype)
    return p


# -- forward (full sequence) -----------------------------------------------------

def _ffn(p, cfg: BlockCfg, x, compute_dtype):
    if cfg.ffn == "mlp":
        x = x + mlp_apply(p["ffn"], cfg.mlp,
                          _norm_apply(cfg.norm, p["norm2"], x),
                          compute_dtype=compute_dtype)
    return x


def block_forward(p, cfg: BlockCfg, x, *, positions=None,
                  impl: str = "kernel", compute_dtype=torch.bfloat16):
    """x: (B, L, D) -> (x, aux_loss); aux is 0 without MoE."""
    check_ported(cfg)
    if cfg.mixer == "attn":
        x = x + attn_forward(p["mixer"], cfg.attn,
                             _norm_apply(cfg.norm, p["norm1"], x),
                             positions=positions, impl=impl,
                             compute_dtype=compute_dtype)
    elif cfg.mixer == "ssm":
        x = x + ssm_forward(p["mixer"], cfg.ssm,
                            _norm_apply(cfg.norm, p["norm1"], x),
                            impl=impl, compute_dtype=compute_dtype)
    return _ffn(p, cfg, x, compute_dtype), torch.zeros((), device=x.device)


# -- cache / prefill / decode -------------------------------------------------------

def block_init_cache(cfg: BlockCfg, B: int, S: int, *, dtype=torch.bfloat16,
                     device=None) -> dict:
    check_ported(cfg)
    c = {}
    if cfg.mixer == "attn":
        c["mixer"] = init_kv_cache(B, S, cfg.attn, dtype, device)
    elif cfg.mixer == "ssm":
        c["mixer"] = init_ssm_state(B, cfg.ssm, dtype, device)
    return c


def block_prefill(p, cfg: BlockCfg, x, cache, *, positions=None,
                  impl: str = "kernel", compute_dtype=torch.bfloat16):
    """Full-sequence forward that also fills the cache at positions
    [0, L).  Returns (x, new_cache, aux)."""
    check_ported(cfg)
    new = dict(cache)
    if cfg.mixer == "attn":
        y, (k, v) = attn_forward(p["mixer"], cfg.attn,
                                 _norm_apply(cfg.norm, p["norm1"], x),
                                 positions=positions, impl=impl,
                                 compute_dtype=compute_dtype, return_kv=True)
        x = x + y
        L = k.shape[1]
        ck, cv = cache["mixer"]["k"], cache["mixer"]["v"]
        if L > ck.shape[1]:
            raise ValueError(f"prefill of {L} tokens into a cache of "
                             f"{ck.shape[1]}")
        ck, cv = ck.clone(), cv.clone()
        ck[:, :L] = k.to(ck.dtype)
        cv[:, :L] = v.to(cv.dtype)
        new["mixer"] = {"k": ck, "v": cv}
    elif cfg.mixer == "ssm":
        y, st = ssm_forward(p["mixer"], cfg.ssm,
                            _norm_apply(cfg.norm, p["norm1"], x),
                            impl=impl, compute_dtype=compute_dtype,
                            return_state=True)
        x = x + y
        new["mixer"] = {"conv": st["conv"].to(cache["mixer"]["conv"].dtype),
                        "ssm": st["ssm"]}
    return _ffn(p, cfg, x, compute_dtype), new, \
        torch.zeros((), device=x.device)


def block_decode(p, cfg: BlockCfg, x, cache, pos, *,
                 compute_dtype=torch.bfloat16):
    """One-token step.  x: (B, 1, D); pos: scalar or (B,) int."""
    check_ported(cfg)
    new = dict(cache)
    if cfg.mixer == "attn":
        y, new["mixer"] = attn_decode(p["mixer"], cfg.attn,
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
    return _ffn(p, cfg, x, compute_dtype), new
