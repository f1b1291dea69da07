"""A plain float32 forward of a Qwen3 dense decoder, for the output check
of the serving cells.

Written from the model's published definition (Qwen3ForCausalLM), in
plain PyTorch, with nothing of the program: a configuration file's
``port`` group gives the layout and widths, and the weights are the
benchmark's own tree (the layout the program takes, made by
``perfbench/lib/lm.py``).  Every layer runs in float32 with TF32 off,
its bf16 weights upcast one layer at a time; attention runs with its
whole score matrix.

A layer: ``h = x + o(attn(rmsnorm(x)))``, then ``h + down(silu(gate(g))
* up(g))`` with ``g = rmsnorm(h)``.  Attention: q, k, v projections
without bias; an RMS norm over each head's ``d_head`` on q and on k
(``qk_norm``), then RoPE (rotate-half, base ``rope_theta``) at positions
0..T-1; each of ``n_kv_heads`` key and value heads serves ``n_heads /
n_kv_heads`` query heads; causal softmax of q.k / sqrt(d_head).  Then the
final RMS norm and the tied embedding as the head.  Every RMS norm has
``norm_eps``.

``forward(weights, port, seqs, wants, mm)`` runs every sequence through
one layer before the next and returns each sequence's logits at its
wanted positions.  ``mm`` is every matrix product's function:
``torch.matmul``, or ``fp8_matmul`` for the control.
"""
from __future__ import annotations

import contextlib
import math

import torch

FP8_MAX = 448.0          # float8_e4m3fn's largest finite value


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8_e4m3fn under one scale for the tensor (its
    largest magnitude onto 448), back in float32."""
    s = t.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


def fp8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The control's product: both inputs rounded to float8_e4m3fn, the
    product and its sums in float32."""
    return torch.matmul(fp8(a), fp8(b))


@contextlib.contextmanager
def f32_products():
    """Float32 products as stated: no TF32 inside."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.float()


def _at(tree, r):
    if isinstance(tree, dict):
        return {k: _at(v, r) for k, v in tree.items()}
    return tree[r]


def layers(weights: dict, port: dict):
    """Each layer's weights in order, still bf16."""
    for gw, g in zip(weights["groups"], port["groups"]):
        for r in range(g["repeats"]):
            for i in range(len(g["cycle"])):
                key = str(i)
                yield (gw["shared"][key] if key in gw["shared"]
                       else _at(gw["stacked"][key], r))


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def silu(x):
    return x * torch.sigmoid(x)


def rope(x, theta: float):
    """x (T, heads, d): rotate-half RoPE at positions 0..T-1."""
    T, _, d = x.shape
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                         device=x.device) / d)
    ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] \
        * freqs
    c, s = torch.cos(ang).float()[:, None], torch.sin(ang).float()[:, None]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def layer(w, x, port, mm):
    a, eps = port["attn"], port["norm_eps"]
    T = x.shape[0]
    H, Hkv, dh = a["n_heads"], a["n_kv_heads"], a["d_head"]
    m = w["mixer"]
    h = rmsnorm(x, w["norm1"]["scale"], eps)
    q = mm(h, m["q"]["w"]).reshape(T, H, dh)
    k = mm(h, m["k"]["w"]).reshape(T, Hkv, dh)
    v = mm(h, m["v"]["w"]).reshape(T, Hkv, dh)
    if a["qk_norm"]:
        q = rmsnorm(q, m["q_norm"]["scale"], eps)
        k = rmsnorm(k, m["k_norm"]["scale"], eps)
    q, k = rope(q, a["rope_theta"]), rope(k, a["rope_theta"])
    k = k.repeat_interleave(H // Hkv, dim=1)
    v = v.repeat_interleave(H // Hkv, dim=1)
    past = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device))
    o = torch.empty(T, H, dh, device=x.device)
    for h0 in range(0, H, 8):         # 8 heads' scores at a time
        hs = slice(h0, h0 + 8)
        scores = mm(q[:, hs].transpose(0, 1), k[:, hs].permute(1, 2, 0)) \
            / math.sqrt(dh)
        probs = torch.softmax(scores.masked_fill(~past, -math.inf), dim=-1)
        o[:, hs] = mm(probs, v[:, hs].transpose(0, 1)).transpose(0, 1)
        del scores, probs
    x = x + mm(o.reshape(T, H * dh), m["o"]["w"])
    f = w["ffn"]
    h = rmsnorm(x, w["norm2"]["scale"], eps)
    return x + mm(silu(mm(h, f["gate"]["w"])) * mm(h, f["up"]["w"]),
                  f["down"]["w"])


def forward(weights: dict, port: dict, seqs: list, wants: list,
            mm=torch.matmul) -> list:
    """Logits (len(want), vocab) of each token sequence ``seqs[i]`` (T,)
    at the positions ``wants[i]``, each position seeing itself and every
    earlier one."""
    with f32_products(), torch.no_grad():
        table = weights["embed"]["table"]
        xs = [table[s].float() for s in seqs]
        for w in layers(weights, port):
            w = _f32(w)
            xs = [layer(w, x, port, mm) for x in xs]
        scale = weights["final_norm"]["scale"].float()
        table = table.float()
        return [mm(rmsnorm(x[want], scale, port["norm_eps"]), table.t())
                for x, want in zip(xs, wants)]
