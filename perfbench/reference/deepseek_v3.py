"""A plain float32 forward of DeepSeek-V3 at an expert share, for the
output check of the MLA/MoE serving cells (and the port's CPU tests,
``tests/test_torch_deepseek_v3.py``).

Written from the model's published definition (DeepseekV3ForCausalLM,
huggingface.co/deepseek-ai/DeepSeek-V3: config.json and
modeling_deepseek.py; arXiv:2412.19437), in plain PyTorch, with nothing
of the program: a configuration file's ``port`` group gives the layout
and widths, and the weights are the benchmark's own tree (the layout the
program takes, made by ``perfbench/lib/moe_lm.py``).  Every layer runs
in float32 with TF32 off, its bf16 weights upcast one layer at a time.

A layer: ``h = x + o(mla(rmsnorm(x)))``, then ``h + ffn(rmsnorm(h))``,
the FFN a SwiGLU MLP in the first ``dense_layers`` layers and the MoE in
the others.  Every RMS norm has ``norm_eps``.

MLA, expanded: ``q = q_up(rmsnorm(q_down(x)))`` split per head into
nope and rope parts; ``kv_down(x)`` gives the latent ``c`` (normed) and
the shared rope key; ``kv_up(c)`` gives each head's nope key and value.
RoPE (rotate-half, base ``rope_theta``) on the rope parts at positions
0..T-1, its frequencies under YaRN where ``mla.yarn`` is given
(DeepseekV3YarnRotaryEmbedding: the ramp between ``beta_fast`` and
``beta_slow`` rotations over the original context, cos and sin times
mscale(factor, mscale) / mscale(factor, mscale_all_dim)).  The published
checkpoint keeps its rope dims interleaved in pairs and the published
code de-interleaves them before rotating halves; with seeded weights
that is a fixed permutation of the rope columns of ``q_up`` and
``kv_down``, so rotate-half is the same law.  Causal softmax of (q_nope .
k_nope + q_rope . k_rope) times 1/sqrt(nope + rope) times
mscale(factor, mscale_all_dim)^2, queries in blocks of ``Q_BLOCK`` so
that a 6,143-position sequence's scores fit.

The MoE (``topk_method: noaux_tc``): sigmoid scores of the router over
all ``n_experts``; the correction bias added for the choice only; the
experts in ``n_group`` groups, a group scored by the sum of its two best
corrected scores, the ``topk_group`` best groups kept, the ``top_k``
best experts among theirs; the weights the chosen experts' sigmoid
scores, renormalised, times ``routed_scaling``.  The expert share: the
tree holds experts [``first_expert``, ``first_expert + n_held``) and only
they contribute; the shared experts (one SwiGLU of ``n_shared * d_ff``)
run for every token.  Then the final RMS norm and the untied head.

``forward(weights, port, seqs, wants, mm)`` runs every sequence through
one layer before the next and returns each sequence's logits at its
wanted positions.  ``mm`` is every matrix product's function:
``torch.matmul``, or ``fp8_matmul`` for the control.  With a list
``margins`` it also appends, for each sequence, the router's closest
call at each position over the MoE layers (``held_margin``): how far a
corrected score would have to move to change which held experts the
token reaches, so that a gap between the program's bf16 and this f32
can be put down to a choice near a tie.  With ``force`` (for each
sequence, (MoE layers, T, top_k) expert ids, such as the program's own)
the router takes those ids in place of its choice, its weights still
its own scores at them, so that what remains between program and
reference is all but the choice.
"""
from __future__ import annotations

import contextlib
import math

import torch

FP8_MAX = 448.0          # float8_e4m3fn's largest finite value
Q_BLOCK = 512            # queries whose scores are held at once


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
    """(weights still bf16, moe?) of each layer in order."""
    for gi, n in enumerate((port["dense_layers"], port["moe_layers"])):
        for r in range(n):
            yield _at(weights["groups"][gi]["stacked"]["0"], r), gi == 1


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def silu(x):
    return x * torch.sigmoid(x)


def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def rope_tables(T: int, mla: dict, device):
    """cos, sin (T, d_rope / 2) of the RoPE part, YaRN's where given."""
    d, theta = mla["qk_rope_dim"], mla["rope_theta"]
    extra = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                         device=device) / d)
    mult = 1.0
    y = mla.get("yarn")
    if y:
        def dim_of(rot):
            return d * math.log(y["original_max_positions"]
                                / (rot * 2 * math.pi)) / (2 * math.log(theta))
        low = max(math.floor(dim_of(y["beta_fast"])), 0)
        high = min(math.ceil(dim_of(y["beta_slow"])), d - 1)
        high = high + 0.001 if low == high else high
        ramp = ((torch.arange(d // 2, dtype=torch.float64, device=device)
                 - low) / (high - low)).clamp(0, 1)
        freqs = extra / y["factor"] * ramp + extra * (1 - ramp)
        mult = yarn_mscale(y["factor"], y["mscale"]) \
            / yarn_mscale(y["factor"], y["mscale_all_dim"])
    else:
        freqs = extra
    ang = torch.arange(T, dtype=torch.float64, device=device)[:, None] * freqs
    return (torch.cos(ang) * mult).float(), (torch.sin(ang) * mult).float()


def rope(x, cos, sin):
    """x (T, heads, d): rotate-half RoPE."""
    h = x.shape[-1] // 2
    c, s = cos[:, None], sin[:, None]
    x1, x2 = x[..., :h], x[..., h:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def softmax_scale(mla: dict) -> float:
    s = 1.0 / math.sqrt(mla["qk_nope_dim"] + mla["qk_rope_dim"])
    y = mla.get("yarn")
    if y and y["mscale_all_dim"]:
        s *= yarn_mscale(y["factor"], y["mscale_all_dim"]) ** 2
    return s


def attention(w, x, port, mm):
    a, eps = port["mla"], port["norm_eps"]
    T = x.shape[0]
    H, dn, dr, dv = (a["n_heads"], a["qk_nope_dim"], a["qk_rope_dim"],
                     a["v_head_dim"])
    C = a["kv_lora_rank"]
    q = mm(rmsnorm(mm(x, w["q_down"]["w"]), w["q_norm"]["scale"], eps),
           w["q_up"]["w"]).reshape(T, H, dn + dr)
    ckr = mm(x, w["kv_down"]["w"])
    c = rmsnorm(ckr[:, :C], w["kv_norm"]["scale"], eps)
    kv = mm(c, w["kv_up"]["w"]).reshape(T, H, dn + dv)
    cos, sin = rope_tables(T, a, x.device)
    q_nope, q_rope = q[..., :dn], rope(q[..., dn:], cos, sin)
    k_rope = rope(ckr[:, None, C:], cos, sin)[:, 0]          # (T, dr)
    k_nope, v = kv[..., :dn].transpose(0, 1), kv[..., dn:].transpose(0, 1)
    scale = softmax_scale(a)
    o = torch.empty(T, H, dv, device=x.device)
    for q0 in range(0, T, Q_BLOCK):
        q1 = min(T, q0 + Q_BLOCK)
        scores = (mm(q_nope[q0:q1].transpose(0, 1), k_nope.transpose(1, 2))
                  + mm(q_rope[q0:q1].transpose(0, 1), k_rope.t())) * scale
        past = torch.arange(T, device=x.device)[None, :] \
            <= torch.arange(q0, q1, device=x.device)[:, None]
        probs = torch.softmax(scores.masked_fill(~past, -math.inf), dim=-1)
        o[q0:q1] = mm(probs, v).transpose(0, 1)
        del scores, probs
    return mm(o.reshape(T, H * dv), w["o"]["w"])


def swiglu(f, x, mm):
    return mm(silu(mm(x, f["gate"]["w"])) * mm(x, f["up"]["w"]),
              f["down"]["w"])


def held_margin(corrected, best, keep, ids, moe: dict):
    """(T,): the least distance of a corrected score from the choice's
    edge that decides a held expert: a held expert in a kept group
    against the ``top_k``-th or the next choice there (whichever it is
    not beyond); where a held expert's group is kept, the
    ``topk_group``-th group score against the next (a change of the kept
    groups changes the field), else each held group's score against the
    ``topk_group``-th."""
    held = torch.arange(moe["first_expert"], moe["first_expert"]
                        + moe["n_held"], device=corrected.device)
    per = corrected.shape[1] // moe["n_group"]
    masked = corrected.masked_fill(~keep.repeat_interleave(per, dim=1),
                                   -math.inf)
    top = torch.topk(masked, moe["top_k"] + 1, dim=-1).values
    c = corrected[:, held]
    chosen = (ids[:, :, None] == held).any(dim=1)
    m = torch.where(chosen, c - top[:, -1:], top[:, -2:-1] - c)
    m = m.masked_fill(~keep[:, held // per], math.inf).amin(dim=1)
    if moe["topk_group"] < moe["n_group"]:
        gtop = torch.topk(best, moe["topk_group"] + 1, dim=-1).values
        hg = torch.unique(held // per)
        gm = torch.where(keep[:, hg].any(dim=1), gtop[:, -2] - gtop[:, -1],
                         (gtop[:, -2:-1] - best[:, hg]).amin(dim=1))
        m = torch.minimum(m, gm)
    return m


def route(f, x, moe: dict, mm, margin=None, ids=None):
    """(weights (T, top_k), expert ids (T, top_k)) of DeepSeek-V3's
    router (module docstring); ``margin`` (T,), where given, is lowered
    to this layer's ``held_margin``; ``ids`` (T, top_k), where given,
    replace the choice."""
    T = x.shape[0]
    scores = torch.sigmoid(mm(x, f["router"]["w"]))
    corrected = scores + f["router"]["correction"]
    g = corrected.reshape(T, moe["n_group"], -1)
    best = torch.topk(g, 2, dim=-1).values.sum(dim=-1)
    kept = torch.topk(best, moe["topk_group"], dim=-1).indices
    keep = torch.zeros_like(best, dtype=torch.bool).scatter_(1, kept, True)
    choice = g.masked_fill(~keep[..., None], -math.inf).reshape(T, -1)
    if ids is None:
        ids = torch.topk(choice, moe["top_k"], dim=-1).indices
    if margin is not None:
        torch.minimum(margin, held_margin(corrected, best, keep, ids, moe),
                      out=margin)
    wts = torch.gather(scores, 1, ids)
    return wts / wts.sum(dim=-1, keepdim=True) * moe["routed_scaling"], ids


def moe_ffn(f, x, port, mm, margin=None, ids=None):
    moe = port["moe"]
    wts, ids = route(f, x, moe, mm, margin, ids)
    y = swiglu(f["shared"], x, mm)
    for e in range(moe["n_held"]):
        rows, k = torch.nonzero(ids == moe["first_expert"] + e,
                                as_tuple=True)
        if rows.numel():
            h = x[rows]
            out = mm(silu(mm(h, f["gate"][e])) * mm(h, f["up"][e]),
                     f["down"][e])
            y = y.index_add(0, rows, out * wts[rows, k][:, None])
    return y


def layer(w, moe: bool, x, port, mm, margin=None, ids=None):
    eps = port["norm_eps"]
    x = x + attention(w["mixer"], rmsnorm(x, w["norm1"]["scale"], eps),
                      port, mm)
    h = rmsnorm(x, w["norm2"]["scale"], eps)
    return x + (moe_ffn(w["ffn"], h, port, mm, margin, ids) if moe
                else swiglu(w["ffn"], h, mm))


def forward(weights: dict, port: dict, seqs: list, wants: list,
            mm=torch.matmul, margins=None, force=None) -> list:
    """Logits (len(want), vocab) of each token sequence ``seqs[i]`` (T,)
    at the positions ``wants[i]``, each position seeing itself and every
    earlier one; with a list ``margins``, each sequence's (T,) router
    margins appended to it; with ``force``, each sequence's expert ids
    (module docstring)."""
    with f32_products(), torch.no_grad():
        table = weights["embed"]["table"]
        xs = [table[s].float() for s in seqs]
        ms = [torch.full((len(s),), math.inf, device=s.device)
              for s in seqs]
        if margins is not None:
            margins.extend(ms)
        n_moe = 0
        for w, moe in layers(weights, port):
            w = _f32(w)
            xs = [layer(w, moe, x, port, mm,
                        m if margins is not None else None,
                        f[n_moe].long() if moe and force is not None
                        else None)
                  for x, m, f in zip(xs, ms, force or [None] * len(xs))]
            n_moe += moe
        scale = weights["final_norm"]["scale"].float()
        head = weights["lm_head"]["w"].float()
        return [mm(rmsnorm(x[want], scale, port["norm_eps"]), head)
                for x, want in zip(xs, wants)]
