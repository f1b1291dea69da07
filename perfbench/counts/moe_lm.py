"""Operations and bytes of a served MLA/MoE language model's work
(DeepSeek-V2/V3's layout at an expert share), from shapes.

``flash_bound_s`` is the least time of one ``flash_attention`` launch at
MLA's head pair (q and k of ``d_qk``, v and the output of ``d_v``): q, k,
v read once and the output written once over HBM, against 2 (d_qk + d_v)
flops for each (query, key) pair the causal mask keeps, on the bf16
tensor cores.

``decode_token``, ``head_flops`` and ``prompt_flops`` count the model's
operations for a configuration file's ``port`` group, as the program
computes them: every matrix product of MLA's projections, the dense
SwiGLU, the router, the shared experts and the held experts, and the
head.  A prompt runs MLA expanded (``kv_up`` on every position; per key
the q.k products over nope + rope and the weighted sum of v); a decode
step runs it absorbed (``W_uk`` folded into the query and ``W_uv`` after
the sum, per token; per key the products over the latent and the rope
key and the weighted sum of the latent).  The held experts count at the
rate a uniform router gives them, ``top_k * n_held / n_experts``
assignments a token (the counter ``moe.held`` reads the real one).
Norms, RoPE, the routing's sort and the other elementwise work are left
out.  Only real tokens count: a prompt's padding to its bucket and a slot
without a request are work the model did not need.
"""
from __future__ import annotations

import numpy as np

from perfbench.counts import HBM_BYTES_PER_S

BF16_FLOPS = 989e12     # bf16 on tensor cores, dense (NVIDIA data sheet)


def flash_bound_s(B, L, S, H, Hkv, d_qk, d_v, itemsize: int = 2) -> float:
    """Least seconds for one causal attention call at (d_qk, d_v)."""
    i = np.arange(L)
    pairs = int((np.minimum(S - 1, i) + 1).sum())
    t_bytes = itemsize * (B * L * H * (d_qk + d_v)
                          + B * S * Hkv * (d_qk + d_v)) / HBM_BYTES_PER_S
    return max(t_bytes, 2 * (d_qk + d_v) * B * H * pairs / BF16_FLOPS)


def layers(port: dict) -> int:
    return port["dense_layers"] + port["moe_layers"]


def prefill_launches(port: dict, bucket: int) -> list:
    """``(kernel, count, bound seconds)`` of one prefill at ``bucket``
    positions: each layer one ``flash_attention`` at (nope + rope, v)
    over the bucket, 128 query heads over as many key heads."""
    a = port["mla"]
    return [("flash_mla", layers(port),
             flash_bound_s(1, bucket, bucket, a["n_heads"], a["n_heads"],
                           a["qk_nope_dim"] + a["qk_rope_dim"],
                           a["v_head_dim"]))]


def _ffn(port: dict) -> int:
    """Flops a token takes through every layer's FFN."""
    d, e = port["d_model"], port["moe"]
    expert = 6 * d * e["d_ff"]
    routed = e["top_k"] * e["n_held"] / e["n_experts"]
    moe = 2 * d * e["n_experts"] + expert * (e["n_shared"] + routed)
    return port["dense_layers"] * 6 * d * port["mlp"]["d_ff"] \
        + port["moe_layers"] * moe


def _projections(port: dict) -> int:
    """MLA's projections a token takes in one layer, both forms."""
    d, a = port["d_model"], port["mla"]
    H, C, dr = a["n_heads"], a["kv_lora_rank"], a["qk_rope_dim"]
    return 2 * (d * a["q_lora_rank"]
                + a["q_lora_rank"] * H * (a["qk_nope_dim"] + dr)
                + d * (C + dr) + H * a["v_head_dim"] * d)


def decode_token(port: dict) -> tuple:
    """Flops one decoded token takes through every layer apart from the
    products over its keys, and the flops of those products per key, in
    the absorbed form."""
    a = port["mla"]
    H, C = a["n_heads"], a["kv_lora_rank"]
    absorb = 2 * H * C * (a["qk_nope_dim"] + a["v_head_dim"])
    per_key = 2 * H * (C + a["qk_rope_dim"]) + 2 * H * C
    n = layers(port)
    return n * (_projections(port) + absorb) + _ffn(port), n * per_key


def head_flops(port: dict) -> int:
    """The untied head over one position: d_model x vocab products."""
    return 2 * port["d_model"] * port["vocab"]


def prompt_flops(port: dict, length: int) -> int:
    """One prompt of ``length`` real tokens, in the expanded form: every
    token through the layers, token t's attention over t + 1 keys, and
    the head at the last position."""
    a = port["mla"]
    H = a["n_heads"]
    dqk, dv = a["qk_nope_dim"] + a["qk_rope_dim"], a["v_head_dim"]
    expand = 2 * a["kv_lora_rank"] * H * (a["qk_nope_dim"] + dv)
    n = layers(port)
    body = n * (_projections(port) + expand) + _ffn(port)
    per_key = n * 2 * H * (dqk + dv)
    return length * body + per_key * length * (length + 1) // 2 \
        + head_flops(port)
