"""A served MLA/MoE language model (DeepSeek-V2/V3's layout) at an
expert share: its weights and the program's configuration of it, from a
configuration file's ``port`` group.

``weights(port, seed, device)`` makes the tree the program's
``lm_prefill``/``lm_decode`` take, on the device, from one seeded
generator in one standard normal draw in bf16 for every matrix, norm
scale and router correction of the model, each then scaled in place: a
matrix by 1/sqrt(fan in), the embedding by 1/sqrt(d_model), a norm scale
(the blocks', MLA's q and kv norms, the final one) to 1 + 0.1 z, a
router's correction bias to 0.1 z.  The expert leaves hold the share's
``n_held`` experts; the router keeps every expert's column.  The
benchmark hands the same tensors to the program and to the plain
reference.

``program_cfg(file)`` is the program's own ``LMCfg`` of the model that
``file["program"]`` names (``module``, ``make``), refused where its
layout or widths differ from the file's ``port`` group.
"""
from __future__ import annotations

import importlib
import math

import torch

from perfbench.lib.lm import _put


def _leaves(port: dict) -> list:
    """Every leaf as (path, shape, kind), in one fixed order."""
    d, V, a = port["d_model"], port["vocab"], port["mla"]
    m, e = port["mlp"], port["moe"]
    H, C, dr = a["n_heads"], a["kv_lora_rank"], a["qk_rope_dim"]
    qd, kvd = a["qk_nope_dim"] + dr, a["qk_nope_dim"] + a["v_head_dim"]
    Q, hv = a["q_lora_rank"], H * a["v_head_dim"]
    out = [(("embed", "table"), (V, d), ("fan", d))]

    def swiglu(pre, lead, f):
        out.extend([(pre + ("up", "w"), lead + (d, f), ("fan", d)),
                    (pre + ("gate", "w"), lead + (d, f), ("fan", d)),
                    (pre + ("down", "w"), lead + (f, d), ("fan", f))])

    for gi, n in enumerate((port["dense_layers"], port["moe_layers"])):
        pre, lead = ("groups", gi, "stacked", "0"), (n,)
        mix = pre + ("mixer",)
        out.extend([
            (pre + ("norm1", "scale"), lead + (d,), ("norm",)),
            (mix + ("q_down", "w"), lead + (d, Q), ("fan", d)),
            (mix + ("q_norm", "scale"), lead + (Q,), ("norm",)),
            (mix + ("q_up", "w"), lead + (Q, H * qd), ("fan", Q)),
            (mix + ("kv_down", "w"), lead + (d, C + dr), ("fan", d)),
            (mix + ("kv_norm", "scale"), lead + (C,), ("norm",)),
            (mix + ("kv_up", "w"), lead + (C, H * kvd), ("fan", C)),
            (mix + ("o", "w"), lead + (hv, d), ("fan", hv)),
            (pre + ("norm2", "scale"), lead + (d,), ("norm",))])
        ffn = pre + ("ffn",)
        if gi == 0:
            swiglu(ffn, lead, m["d_ff"])
            continue
        E, n_e, f = e["n_experts"], e["n_held"], e["d_ff"]
        out.extend([
            (ffn + ("router", "w"), lead + (d, E), ("fan", d)),
            (ffn + ("router", "correction"), lead + (E,), ("bias",)),
            (ffn + ("up",), lead + (n_e, d, f), ("fan", d)),
            (ffn + ("gate",), lead + (n_e, d, f), ("fan", d)),
            (ffn + ("down",), lead + (n_e, f, d), ("fan", f))])
        swiglu(ffn + ("shared",), lead, f * e["n_shared"])
    out.extend([(("final_norm", "scale"), (d,), ("norm",)),
                (("lm_head", "w"), (d, V), ("fan", d))])
    return out


def weights(port: dict, seed: int, device) -> dict:
    """The model's weights from ``seed``, on ``device`` (see the module's
    docstring)."""
    leaves = _leaves(port)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    n = sum(math.prod(shape) for _, shape, _ in leaves)
    flat = torch.randn(n, generator=g, device=device, dtype=torch.bfloat16)
    tree: dict = {"groups": [{"shared": {}, "stacked": {}}
                             for _ in range(2)]}
    at = 0
    for path, shape, kind in leaves:
        leaf = flat[at: at + math.prod(shape)].view(shape)
        at += leaf.numel()
        if kind[0] == "fan":
            leaf.mul_(1.0 / math.sqrt(kind[1]))
        elif kind[0] == "bias":
            leaf.mul_(0.1)
        else:
            leaf.mul_(0.1).add_(1.0)
        _put(tree, path, leaf)
    return tree


# -- the program's configuration ----------------------------------------------

def describe(cfg) -> tuple:
    """The layout and widths of the program's ``LMCfg`` in the terms of a
    configuration file's ``port`` group, and whether it is of the form
    the reference computes: two groups of one MLA block each (a dense
    SwiGLU FFN, then the MoE), RMS norms, causal attention without a
    window, an untied head, no MTP and no other input."""
    dense, moe = (cfg.groups + (None, None))[:2]
    if len(cfg.groups) != 2 or len(dense.cycle) != 1 \
            or len(moe.cycle) != 1:
        return {"groups": [[b.mixer for b in g.cycle] for g in cfg.groups]
                }, False
    db, mb = dense.cycle[0], moe.cycle[0]
    a, e = db.mla, mb.moe
    y = a.rope_scaling if a is not None else None
    out = {"d_model": cfg.d_model, "vocab": cfg.vocab,
           "tie_embeddings": cfg.tie_embeddings,
           "dense_layers": dense.repeats, "moe_layers": moe.repeats}
    if a is not None:
        out["mla"] = {
            "n_heads": a.n_heads, "q_lora_rank": a.q_lora_rank,
            "kv_lora_rank": a.kv_lora_rank, "qk_nope_dim": a.qk_nope_dim,
            "qk_rope_dim": a.qk_rope_dim, "v_head_dim": a.v_head_dim,
            "rope_theta": a.rope_theta,
            "yarn": None if y is None else {
                "factor": y.factor,
                "original_max_positions": y.original_max_positions,
                "beta_fast": y.beta_fast, "beta_slow": y.beta_slow,
                "mscale": y.mscale, "mscale_all_dim": y.mscale_all_dim}}
    if db.mlp is not None:
        out["mlp"] = {"d_ff": db.mlp.d_ff, "gated": db.mlp.gated,
                      "act": db.mlp.act}
    if e is not None:
        out["moe"] = {"n_experts": e.n_experts, "top_k": e.top_k,
                      "d_ff": e.d_ff, "n_shared": e.n_shared,
                      "score_func": e.score_func,
                      "score_correction": e.score_correction,
                      "n_group": e.n_group, "topk_group": e.topk_group,
                      "routed_scaling": e.routed_scaling,
                      "first_expert": e.first_expert, "n_held": e.n_held}
    plain = (cfg.final_norm == "rms" and cfg.pos_embed == "none"
             and not cfg.tie_embeddings and not cfg.prefix_embed_dim
             and not cfg.mtp and a is not None and e is not None
             and (db.mixer, db.ffn, mb.mixer, mb.ffn)
             == ("mla", "mlp", "mla", "moe")
             and db.mla == mb.mla and a.causal and a.window is None
             and a.q_lora_rank > 0
             and all(b.norm == "rms" and b.cross is None and not b.shared
                     for b in (db, mb))
             and e.score_func == "sigmoid" and e.score_correction
             and e.n_held > 0 and db.mlp.gated and db.mlp.act == "silu")
    return out, plain


def program_cfg(file: dict):
    """The program's ``LMCfg`` of the model that ``file["program"]`` names
    (``module``, ``make``), refused where it is not the file's
    ``port``."""
    prog = file["program"]
    cfg = getattr(importlib.import_module(prog["module"]), prog["make"])()
    got, plain = describe(cfg)
    want = {k: file["port"].get(k) for k in got}
    if got != want or not plain:
        raise ValueError(f"the program builds another model than the "
                         f"configuration states: program {got} (plain "
                         f"blocks: {plain}), file {want}")
    return cfg
