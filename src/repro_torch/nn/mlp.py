"""Feed-forward blocks: SwiGLU and GELU (port of ``repro.nn.mlp``)."""
from __future__ import annotations

import dataclasses

import torch

from .core import gelu, linear, linear_init, silu


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


def mlp_apply(p: dict, cfg: MLPCfg, x: torch.Tensor, *,
              compute_dtype=torch.bfloat16) -> torch.Tensor:
    act = silu if cfg.act == "silu" else gelu
    h = linear(p["up"], x, compute_dtype=compute_dtype)
    if cfg.gated:
        h = act(linear(p["gate"], x, compute_dtype=compute_dtype)) * h
    else:
        h = act(h)
    return linear(p["down"], h, compute_dtype=compute_dtype)
