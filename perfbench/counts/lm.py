"""Operations and bytes of a served language model's work, from shapes.

``flash_bound_s`` is a frozen copy of the bound arithmetic that
``chip_smoke.py`` applies to the attention kernel (``flash_bound_ms``),
in seconds: q, k, v read once and the output written once over HBM,
against the operations at the input type's peak (bf16 tensor cores for
bf16 attention, f32 CUDA cores otherwise).

``token_body``, ``head_flops`` and ``prompt_flops`` count the model's
operations for a configuration file's ``port`` group: every matrix
product of the projections, the MLP and the tied head, and attention's
two products over the keys a token sees. Norms, gates, RoPE and the
other elementwise work are left out (under 0.1% of a token's operations
at qwen3-4b's widths). Only real tokens count: a prompt's padding to its
bucket and a slot without a request are work the model did not need.
"""
from __future__ import annotations

import numpy as np

from perfbench.counts import F32_FLOPS, HBM_BYTES_PER_S

BF16_FLOPS = 989e12     # bf16 on tensor cores, dense (NVIDIA data sheet)


def flash_bound_s(B, L, S, H, Hkv, D, itemsize: int, causal: bool = True,
                  window=None) -> float:
    """Least seconds for one attention call: q, k, v read once and out
    written once, against 4 D flops for each (query, key) pair the mask
    keeps, at the peak of the input type."""
    i = np.arange(L)
    hi = np.minimum(S - 1, i) if causal else np.full(L, S - 1)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(L, np.int64)
    pairs = int(np.maximum(0, hi - lo + 1).sum())
    t_bytes = itemsize * (2 * B * L * H * D + 2 * B * S * Hkv * D) \
        / HBM_BYTES_PER_S
    peak = BF16_FLOPS if itemsize == 2 else F32_FLOPS
    return max(t_bytes, 4 * D * B * H * pairs / peak)


def attn_layers(port: dict) -> int:
    return sum(g["repeats"] * len(g["cycle"]) for g in port["groups"])


def prefill_launches(port: dict, bucket: int) -> list:
    """``(kernel, count, bound seconds)`` of one prefill at ``bucket``
    positions: each attention layer one ``flash_attention`` over the
    bucket."""
    a = port["attn"]
    return [("flash_attention", attn_layers(port),
             flash_bound_s(1, bucket, bucket, a["n_heads"], a["n_kv_heads"],
                           a["d_head"], 2))]


def token_body(port: dict) -> tuple:
    """Flops a token takes through every layer apart from attention's
    products over its keys, and the flops of those products per key."""
    d, a, m = port["d_model"], port["attn"], port["mlp"]
    n = attn_layers(port)
    hd, kvd = a["n_heads"] * a["d_head"], a["n_kv_heads"] * a["d_head"]
    layer = 2 * d * (2 * hd + 2 * kvd) \
        + 2 * d * m["d_ff"] * (3 if m["gated"] else 2)
    return n * layer, 4 * a["d_head"] * a["n_heads"] * n


def head_flops(port: dict) -> int:
    """The tied head over one position: d_model x vocab products."""
    return 2 * port["d_model"] * port["vocab"]


def prompt_flops(port: dict, length: int) -> int:
    """One prompt of ``length`` real tokens: every token through the
    layers, token t's attention over t + 1 keys, and the head at the last
    position."""
    body, per_key = token_body(port)
    return length * body + per_key * length * (length + 1) // 2 \
        + head_flops(port)
