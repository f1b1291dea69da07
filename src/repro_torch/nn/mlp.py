"""Feed-forward blocks: SwiGLU and GELU (port of ``repro.nn.mlp``)."""
from __future__ import annotations

import dataclasses

import torch

from .core import gelu, linear, linear_init, silu
from .sharding import P, batch_spec, constrain


@dataclasses.dataclass(frozen=True)
class MLPCfg:
    d_model: int
    d_ff: int
    gated: bool = True            # SwiGLU if True, GELU otherwise
    act: str = "silu"


def mlp_init(generator: torch.Generator, cfg: MLPCfg, *,
             dtype=torch.float32) -> dict:
    p = {"up": linear_init(generator, cfg.d_model, cfg.d_ff, dtype=dtype),
         "down": linear_init(generator, cfg.d_ff, cfg.d_model, dtype=dtype)}
    if cfg.gated:
        p["gate"] = linear_init(generator, cfg.d_model, cfg.d_ff, dtype=dtype)
    return p


def mlp_spec(cfg: MLPCfg) -> dict:
    s = {"up": {"w": P(None, "model")}, "down": {"w": P("model", None)}}
    if cfg.gated:
        s["gate"] = {"w": P(None, "model")}
    return s


def mlp_apply(p: dict, cfg: MLPCfg, x: torch.Tensor, *,
              compute_dtype=torch.bfloat16) -> torch.Tensor:
    act = silu if cfg.act == "silu" else gelu
    h = linear(p["up"], x, compute_dtype=compute_dtype)
    if cfg.gated:
        h = act(linear(p["gate"], x, compute_dtype=compute_dtype)) * h
    else:
        h = act(h)
    h = constrain(h, batch_spec(None, "model"))
    return linear(p["down"], h, compute_dtype=compute_dtype)
