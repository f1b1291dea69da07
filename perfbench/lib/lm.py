"""A served language model's weights and the program's configuration of
it, from a configuration file's ``port`` group.

``weights(port, seed, device)`` makes the tree the program's
``lm_prefill``/``lm_decode`` take, on the device, from one seeded
generator in one standard normal draw in bf16 for every matrix and norm
scale of the model, each then scaled in place: a matrix by 1/sqrt(fan
in), the embedding by 1/sqrt(d_model), a norm scale (the blocks', the
final one, and the per-head q and k norms) to 1 + 0.1 z.  The benchmark
hands the same tensors to the program and to the plain reference.

``program_cfg(file)`` is the program's own ``LMCfg`` for the model the
file names, refused where its layout or widths differ from the file's
``port`` group.
"""
from __future__ import annotations

import math

import torch


def _leaves(port: dict) -> list:
    """Every leaf as (path, shape, kind), in one fixed order."""
    d, V, a, m = port["d_model"], port["vocab"], port["attn"], port["mlp"]
    hd, kvd = a["n_heads"] * a["d_head"], a["n_kv_heads"] * a["d_head"]
    out = [(("embed", "table"), (V, d), ("fan", d))]

    def attn(pre, lead):
        out.extend([
            (pre + ("norm1", "scale"), lead + (d,), ("norm",)),
            (pre + ("mixer", "q", "w"), lead + (d, hd), ("fan", d)),
            (pre + ("mixer", "k", "w"), lead + (d, kvd), ("fan", d)),
            (pre + ("mixer", "v", "w"), lead + (d, kvd), ("fan", d)),
            (pre + ("mixer", "o", "w"), lead + (hd, d), ("fan", hd)),
            (pre + ("norm2", "scale"), lead + (d,), ("norm",)),
            (pre + ("ffn", "up", "w"), lead + (d, m["d_ff"]), ("fan", d)),
            (pre + ("ffn", "down", "w"), lead + (m["d_ff"], d),
             ("fan", m["d_ff"]))])
        if m["gated"]:
            out.append((pre + ("ffn", "gate", "w"), lead + (d, m["d_ff"]),
                        ("fan", d)))
        if a["qk_norm"]:
            out.extend([(pre + ("mixer", n, "scale"), lead + (a["d_head"],),
                         ("norm",)) for n in ("q_norm", "k_norm")])

    for gi, g in enumerate(port["groups"]):
        for i, kind in enumerate(g["cycle"]):
            if kind != "attn":
                raise ValueError(f"no weights for a block of kind {kind!r}")
            if a["shared"]:
                attn(("groups", gi, "shared", str(i)), ())
            else:
                attn(("groups", gi, "stacked", str(i)), (g["repeats"],))
    out.append((("final_norm", "scale"), (d,), ("norm",)))
    return out


def _put(tree, path: tuple, leaf) -> None:
    for k in path[:-1]:
        tree = tree[k] if isinstance(tree, list) else tree.setdefault(k, {})
    tree[path[-1]] = leaf


def weights(port: dict, seed: int, device) -> dict:
    """The model's weights from ``seed``, on ``device`` (see the module's
    docstring)."""
    leaves = _leaves(port)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    n = sum(math.prod(shape) for _, shape, _ in leaves)
    flat = torch.randn(n, generator=g, device=device, dtype=torch.bfloat16)
    tree: dict = {"groups": [{"shared": {}, "stacked": {}}
                             for _ in port["groups"]]}
    at = 0
    for path, shape, kind in leaves:
        leaf = flat[at: at + math.prod(shape)].view(shape)
        at += leaf.numel()
        if kind[0] == "fan":
            leaf.mul_(1.0 / math.sqrt(kind[1]))
        else:
            leaf.mul_(0.1).add_(1.0)
        _put(tree, path, leaf)
    return tree


# -- the program's configuration ----------------------------------------------

def describe(cfg) -> tuple:
    """The layout and widths of the program's ``LMCfg`` in the terms of a
    configuration file's ``port`` group, and whether every block is of
    the plain kinds the reference computes (RMS norms, RoPE, causal
    attention without bias or window, a SwiGLU MLP, no cross-attention)."""
    blocks = [b for g in cfg.groups for b in g.cycle]
    att = blocks[0]
    out = {"d_model": cfg.d_model, "vocab": cfg.vocab,
           "tie_embeddings": cfg.tie_embeddings,
           "groups": [{"cycle": [b.mixer for b in g.cycle],
                       "repeats": g.repeats} for g in cfg.groups],
           "attn": {"n_heads": att.attn.n_heads,
                    "n_kv_heads": att.attn.n_kv_heads,
                    "d_head": att.attn.d_head,
                    "rope_theta": att.attn.rope_theta,
                    "qk_norm": att.attn.qk_norm, "shared": att.shared},
           "mlp": {"d_ff": att.mlp.d_ff, "gated": att.mlp.gated,
                   "act": att.mlp.act}}
    plain = (cfg.final_norm == "rms" and cfg.pos_embed == "none"
             and cfg.tie_embeddings and not cfg.prefix_embed_dim
             and not cfg.mtp
             and all(b.mixer == "attn" and b.ffn == "mlp" and b.norm == "rms"
                     and b.cross is None and b.attn.rope and b.attn.causal
                     and not (b.attn.qkv_bias or b.attn.window
                              or b.attn.cross)
                     and (b.attn, b.mlp, b.shared)
                     == (att.attn, att.mlp, att.shared)
                     for b in blocks))
    return out, plain


def program_cfg(file: dict):
    """The program's ``LMCfg`` of the model that ``file["program"]`` names
    (``arch``, ``make``), refused where it is not the file's ``port``."""
    from repro_torch.configs import get_arch
    prog = file["program"]
    cfg = getattr(get_arch(prog["arch"]), prog["make"])()
    got, plain = describe(cfg)
    want = {k: file["port"].get(k) for k in got}
    if got != want or not plain:
        raise ValueError(f"the program builds another model than the "
                         f"configuration states: program {got} (plain "
                         f"blocks: {plain}), file {want}")
    return cfg
