"""Rotary position embeddings (port of ``repro.nn.rotary``): f32 math,
cast back to the input dtype."""
from __future__ import annotations

import torch


def rope_freqs(d_head: int, theta: float = 10000.0, device=None):
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / (theta ** exps)


def rope_cos_sin(positions: torch.Tensor, d_head: int,
                 theta: float = 10000.0):
    """positions: (..., L) int -> cos/sin (..., L, d_head//2) f32."""
    freqs = rope_freqs(d_head, theta, positions.device)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., L, H, D); cos/sin: (..., L, D//2), broadcast over heads."""
    xf = x.float()
    x1, x2 = torch.chunk(xf, 2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)
