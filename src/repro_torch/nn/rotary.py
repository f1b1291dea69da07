"""Rotary position embeddings (port of ``repro.nn.rotary``): f32 math,
cast back to the input dtype.

``YaRN`` is the ``rope_scaling`` of DeepSeek-V2/V3's configs (type
``yarn``, arXiv:2309.00071), as their published modelling code applies
it: the frequencies whose wavelength exceeds the original context
(``original_max_position_embeddings``) are divided by ``factor``, those
that turn more than ``beta_fast`` times in it are kept, and a linear ramp
over the dims between ``beta_slow`` and ``beta_fast`` rotations mixes the
two; cos and sin are multiplied by ``yarn_mscale(factor, mscale) /
yarn_mscale(factor, mscale_all_dim)``.  The attention that uses it also
multiplies its softmax scale by ``yarn_mscale(factor, mscale_all_dim)``
squared (``nn.mla``).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch


@dataclasses.dataclass(frozen=True)
class YaRN:
    factor: float
    original_max_positions: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


def yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    """YaRN's attention factor: 0.1 mscale ln(scale) + 1 (1 where the
    context is not stretched)."""
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def _correction_dim(rotations: float, d: int, theta: float,
                    max_pos: int) -> float:
    """The dim whose frequency turns ``rotations`` times over
    ``max_pos`` positions."""
    return d * math.log(max_pos / (rotations * 2 * math.pi)) \
        / (2 * math.log(theta))


def rope_freqs(d_head: int, theta: float = 10000.0, device=None):
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / (theta ** exps)


@functools.lru_cache(maxsize=None)
def yarn_freqs(d_head: int, theta: float, yarn: YaRN, device=None):
    """(d_head // 2,) f32 YaRN frequencies, made once per device."""
    extra = rope_freqs(d_head, theta, device)
    inter = extra / yarn.factor
    low = max(math.floor(_correction_dim(
        yarn.beta_fast, d_head, theta, yarn.original_max_positions)), 0)
    high = min(math.ceil(_correction_dim(
        yarn.beta_slow, d_head, theta, yarn.original_max_positions)),
        d_head - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(d_head // 2, dtype=torch.float32, device=device)
             - low) / (high - low)).clamp(0, 1)
    return inter * ramp + extra * (1 - ramp)


def rope_cos_sin(positions: torch.Tensor, d_head: int,
                 theta: float = 10000.0, yarn: YaRN = None):
    """positions: (..., L) int -> cos/sin (..., L, d_head//2) f32."""
    if yarn is None:
        freqs = rope_freqs(d_head, theta, positions.device)
    else:
        freqs = yarn_freqs(d_head, theta, yarn, positions.device)
    ang = positions.float()[..., None] * freqs
    if yarn is None:
        return torch.cos(ang), torch.sin(ang)
    m = yarn_mscale(yarn.factor, yarn.mscale) \
        / yarn_mscale(yarn.factor, yarn.mscale_all_dim)
    return torch.cos(ang) * m, torch.sin(ang) * m


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., L, H, D); cos/sin: (..., L, D//2), broadcast over heads."""
    xf = x.float()
    x1, x2 = torch.chunk(xf, 2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)
