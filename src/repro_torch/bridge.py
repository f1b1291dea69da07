"""Carry weights and states across between the JAX package and the port,
through numpy.

The caller converts a JAX tree with ``jax.tree.map(np.asarray, tree)``;
the ``*_from_numpy`` functions take those numpy trees (or anything with
the same attributes) and build the port's objects.  The way back,
``train_state_to_numpy``, ``policy_to_numpy`` and
``lm_train_state_to_numpy``, gives the JAX package's layout as numpy
arrays, which is what the port's checkpoints hold, so either package
reads the other's (an LM training checkpoint resumes in either).  The
bridge never imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.buffers import stack_buffers
from repro_torch.core.d3pg import stack_d3pg
from repro_torch.core.ddqn import stack_ddqn
from repro_torch.core.env import EnvState, ModelParams
from repro_torch.core.networks import MLP, StackedMLP
from repro_torch.device import resolve_device
from repro_torch.diffusion.denoiser import (TIME_DIM, Denoiser,
                                            StackedDenoiser)
from repro_torch.models.lm import LMCfg, tree_leaves, tree_map, tree_unflatten


def _f32(a, device):
    return torch.tensor(np.asarray(a, np.float32), device=device)


def mlp_from_numpy(layers, device=None):
    """``[{"w": (in, out), "b": (out,)}, ...]`` -> ``MLP``; B stacked
    learners' layers (``mlp_init_stacked``: ``w`` (B, in, out), ``b``
    (B, out)) -> ``StackedMLP``."""
    dev = resolve_device(device)
    cls = StackedMLP if np.asarray(layers[0]["w"]).ndim == 3 else MLP
    return cls([_f32(l["w"], dev) for l in layers],
               [_f32(l["b"], dev) for l in layers])


def denoiser_from_numpy(tree, device=None, time_dim: int = TIME_DIM):
    """``{"layers": [...]}`` (``repro.diffusion.denoiser_init``) ->
    ``Denoiser``; stacked layers -> ``StackedDenoiser``."""
    net = mlp_from_numpy(tree["layers"], device)
    cls = StackedDenoiser if isinstance(net, StackedMLP) else Denoiser
    return cls(net, time_dim)


def actor_from_numpy(tree, device=None):
    """``{"layers": [...]}`` (D3PG denoiser) -> ``Denoiser``, ``[...]``
    (DDPG MLP) -> ``MLP``."""
    return (denoiser_from_numpy(tree, device) if isinstance(tree, dict)
            else mlp_from_numpy(tree, device))


def policy_from_numpy(tree, device=None) -> dict:
    """An ``export_policy`` tree -> the port's policy dict.

    ``{"actor": {"layers": [...]}}`` (D3PG denoiser) or ``{"actor":
    [...]}`` (DDPG MLP), ``{"ddqn": {"q": [...]}}``, and a classical
    cacher's ``{"cache": {"rho": (M,)}}``."""
    pol = {}
    if "actor" in tree:
        pol["actor"] = actor_from_numpy(tree["actor"], device)
    if "ddqn" in tree:
        pol["ddqn"] = {"q": mlp_from_numpy(tree["ddqn"]["q"], device)}
    if "cache" in tree:
        pol["cache"] = {"rho": _f32(tree["cache"]["rho"],
                                    resolve_device(device))}
    return pol


def _adam_state_from_numpy(opt, to_module) -> dict:
    """A JAX ``adam_init``/``adam_update`` state -> the port's: ``mu`` and
    ``nu`` as lists in the port module's parameter order (each moment tree
    is built into a module by ``to_module`` and its parameters taken),
    ``step`` a host int."""
    def leaves(tree):
        return [p.detach() for p in to_module(tree).parameters()]
    return {"mu": leaves(opt["mu"]), "nu": leaves(opt["nu"]),
            "step": int(np.asarray(opt["step"]))}


def _buffer_from_numpy(buf, dev) -> dict:
    def leaf(a):
        a = np.asarray(a)
        return torch.tensor(a.astype(np.int64) if a.dtype.kind in "iu"
                            else a.astype(np.float32), device=dev)
    return {"data": {k: leaf(v) for k, v in buf["data"].items()},
            "ptr": int(np.asarray(buf["ptr"])),
            "size": int(np.asarray(buf["size"]))}


def _learners_from_numpy(d3, dq, dev) -> dict:
    actor = lambda t: actor_from_numpy(t, dev)  # noqa: E731
    mlp = lambda t: mlp_from_numpy(t, dev)  # noqa: E731
    return {
        "d3pg": {"actor": actor(d3["actor"]),
                 "actor_t": actor(d3["actor_t"]).requires_grad_(False),
                 "critic": mlp(d3["critic"]),
                 "critic_t": mlp(d3["critic_t"]).requires_grad_(False),
                 "opt_a": _adam_state_from_numpy(d3["opt_a"], actor),
                 "opt_c": _adam_state_from_numpy(d3["opt_c"], mlp)},
        "ddqn": {"q": mlp(dq["q"]),
                 "q_target": mlp(dq["q_target"]).requires_grad_(False),
                 "opt": _adam_state_from_numpy(dq["opt"], mlp)}}


def _cache_from_numpy(cache, dev) -> dict:
    """The classical cachers' state: bool masks and int32 clocks as they
    are, (M,) leaves or (B, M) for B cells."""
    return {k: torch.tensor(np.asarray(v), device=dev)
            for k, v in cache.items()}


def _cell(tree, b: int):
    """Entry b of every leaf of a numpy tree (dicts, lists, NamedTuples)."""
    if isinstance(tree, dict):
        return {k: _cell(v, b) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_cell(v, b) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cell(v, b) for v in tree)
    return np.asarray(tree)[b]


def train_state_from_numpy(ts, cfg, device=None) -> dict:
    """A JAX train state with numpy leaves -> the port's: model zoo, D3PG
    networks, targets and Adam states, DDQN networks, target and Adam
    state, and both replay buffers (integer leaves as int64).  ``cfg`` is
    the port's ``T2DRLCfg``.

    A single-cell state (``t2drl_init``) gives ``t2drl_init``'s layout.  A
    batched one (``t2drl_init_batch``, or trained with ``num_envs > 1``)
    gives ``t2drl_init_batch``'s: (B,)-leading models and buffers (per-cell
    ``ptr``/``size`` lists) and, for ``cfg.policy == "independent"``,
    stacked learners (every leaf of the JAX agents carries the B axis);
    a shared state's agents are unbatched in both.  The classical cachers'
    ``cache`` state is carried as it is (per cell in either mode)."""
    dev = resolve_device(device)
    cache = _cache_from_numpy(ts["cache"], dev)
    if np.asarray(ts["models"].a1).ndim == 1:
        return {"models": models_from_numpy(ts["models"], dev),
                **_learners_from_numpy(ts["d3pg"], ts["ddqn"], dev),
                "ebuf": _buffer_from_numpy(ts["ebuf"], dev),
                "fbuf": _buffer_from_numpy(ts["fbuf"], dev), "cache": cache}
    B = np.asarray(ts["models"].a1).shape[0]
    out = {"models": models_from_numpy(ts["models"], dev), "cache": cache}
    for k in ("ebuf", "fbuf"):
        out[k] = stack_buffers(_buffer_from_numpy(_cell(ts[k], b), dev)
                               for b in range(B))
    if cfg.policy == "shared":
        out.update(_learners_from_numpy(ts["d3pg"], ts["ddqn"], dev))
    else:
        cells = [_learners_from_numpy(_cell(ts["d3pg"], b),
                                      _cell(ts["ddqn"], b), dev)
                 for b in range(B)]
        out["d3pg"] = stack_d3pg(c["d3pg"] for c in cells)
        out["ddqn"] = stack_ddqn(c["ddqn"] for c in cells)
    return out


# -- the way back: the port's objects in the JAX package's layout ------------

def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _sorted(tree):
    """Dicts with their keys sorted, at every level, as ``jax.tree.map``
    rebuilds them."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_sorted(v) for v in tree]
    return tree


def _layers(ws, bs) -> list:
    return [{"b": _np(b), "w": _np(w)} for w, b in zip(ws, bs)]


def _net_tree(module, leaves=None):
    """An MLP or denoiser (single or stacked) as the JAX tree: ``[{"b",
    "w"}, ...]``, or ``{"layers": [...]}`` for a denoiser.  ``leaves``
    (Adam moments, in the module's parameter order: every ``w``, then
    every ``b``) replace the parameters."""
    net = getattr(module, "net", module)
    n = len(net.w)
    ps = list(net.w) + list(net.b) if leaves is None else list(leaves)
    tree = _layers(ps[:n], ps[n:])
    return {"layers": tree} if net is not module else tree


def _adam_to_numpy(opt, module, lead: tuple) -> dict:
    """An Adam state as the JAX ``adam_init`` tree: ``mu`` and ``nu`` in
    the module's tree, ``step`` int32 (B learners: (B,), all equal)."""
    return {"mu": _net_tree(module, opt["mu"]),
            "nu": _net_tree(module, opt["nu"]),
            "step": np.full(lead, opt["step"], np.int32)}


def _learners_to_numpy(d3: dict, dq: dict, lead: tuple) -> dict:
    return {
        "d3pg": {k: _net_tree(d3[k])
                 for k in ("actor", "actor_t", "critic", "critic_t")}
        | {"opt_a": _adam_to_numpy(d3["opt_a"], d3["actor"], lead),
           "opt_c": _adam_to_numpy(d3["opt_c"], d3["critic"], lead)},
        "ddqn": {"q": _net_tree(dq["q"]),
                 "q_target": _net_tree(dq["q_target"]),
                 "opt": _adam_to_numpy(dq["opt"], dq["q"], lead)}}


def _buffer_to_numpy(buf: dict) -> dict:
    """A replay buffer in the JAX layout: integer leaves int32, ``ptr`` and
    ``size`` int32 (lists of B cells' -> (B,))."""
    def leaf(t):
        a = _np(t)
        return a.astype(np.int32) if a.dtype.kind in "iu" else a
    return {"data": {k: leaf(v) for k, v in buf["data"].items()},
            "ptr": np.asarray(buf["ptr"], np.int32),
            "size": np.asarray(buf["size"], np.int32)}


def models_to_numpy(mp: ModelParams) -> ModelParams:
    return ModelParams(*(_np(getattr(mp, f)) for f in ModelParams._fields))


def train_state_to_numpy(ts: dict, cfg=None) -> dict:
    """The port's train state (``t2drl_init``'s or ``t2drl_init_batch``'s
    layout) -> the JAX package's, numpy leaves: the keys, leaf order,
    shapes and dtypes of ``jax.tree.map(np.asarray, t2drl_init(...))``
    (or of its batched state), ``ModelParams`` a NamedTuple of arrays.
    Integer buffer leaves become int32, Adam steps and the buffers'
    ``ptr``/``size`` int32 arrays; stacked learners (a batched
    independent state) lead every agent leaf with (B,), a shared state's
    agents are unbatched.  The layout follows the state; ``cfg``, when
    given, must agree with it (``cfg.policy``)."""
    stacked = isinstance(ts["ddqn"]["q"], StackedMLP)
    batched = ts["models"].a1.dim() == 2
    if cfg is not None and batched and stacked != (cfg.policy != "shared"):
        kind = "stacked" if stacked else "shared"
        raise ValueError(f"a batched state with {kind} learners under "
                         f"policy={cfg.policy!r}")
    lead = (ts["models"].a1.shape[0],) if stacked else ()
    out = {"models": models_to_numpy(ts["models"]),
           **_learners_to_numpy(ts["d3pg"], ts["ddqn"], lead),
           "ebuf": _buffer_to_numpy(ts["ebuf"]),
           "fbuf": _buffer_to_numpy(ts["fbuf"]),
           "cache": {k: _np(v) for k, v in ts["cache"].items()}}
    return _sorted(out)


def policy_to_numpy(policy: dict) -> dict:
    """An ``export_policy`` dict -> the JAX package's policy tree (numpy
    leaves): ``{"actor": ...}``, ``{"ddqn": {"q": ...}}``, ``{"cache":
    {"rho": ...}}``."""
    out = {}
    if "actor" in policy:
        out["actor"] = _net_tree(policy["actor"])
    if "ddqn" in policy:
        out["ddqn"] = {"q": _net_tree(policy["ddqn"]["q"])}
    if "cache" in policy:
        out["cache"] = {"rho": _np(policy["cache"]["rho"])}
    return _sorted(out)


def models_from_numpy(mp, device=None) -> ModelParams:
    """A JAX ``ModelParams`` (numpy leaves, (M,) or B cells' (B, M)) ->
    the port's ``ModelParams``."""
    dev = resolve_device(device)
    return ModelParams(*(_f32(getattr(mp, f), dev)
                         for f in ModelParams._fields))


def env_state_from_numpy(st, generator: torch.Generator) -> EnvState:
    """A JAX ``EnvState`` (numpy leaves) -> ``EnvState`` on the generator's
    device; the JAX key is dropped and ``generator`` takes its place."""
    dev = generator.device

    def idx(a):
        return torch.tensor(np.asarray(a, np.int64), device=dev)

    return EnvState(generator=generator, gamma_idx=idx(st.gamma_idx),
                    lambda_idx=idx(st.lambda_idx), pos=_f32(st.pos, dev),
                    h=_f32(st.h, dev), req=idx(st.req),
                    d_in=_f32(st.d_in, dev), rho=_f32(st.rho, dev))


def _lin(bias: bool = False) -> dict:
    return {"w": None, "b": None} if bias else {"w": None}


def _norm_keys(kind: str) -> dict:
    return {"rms": {"scale": None}, "ln": {"scale": None, "bias": None},
            "ln_np": {}}[kind]


def _attn_keys(a) -> dict:
    k = {n: _lin(a.qkv_bias) for n in ("q", "k", "v")} | {"o": _lin()}
    if a.qk_norm:
        k.update(q_norm={"scale": None}, k_norm={"scale": None})
    return k


def _mixer_keys(b) -> dict:
    if b.mixer == "attn":
        return _attn_keys(b.attn)
    if b.mixer == "mla":
        q = ({"q_down": _lin(), "q_norm": {"scale": None}, "q_up": _lin()}
             if b.mla.q_lora_rank else {"q_proj": _lin()})
        return q | {"kv_down": _lin(), "kv_norm": {"scale": None},
                    "kv_up": _lin(), "o": _lin()}
    return {"in_proj": _lin(), "conv_w": None, "conv_b": None,
            "A_log": None, "D": None, "dt_bias": None,
            "norm": {"scale": None}, "out_proj": _lin()}


def _mlp_keys(m) -> dict:
    k = {"up": _lin(), "down": _lin()}
    return k | {"gate": _lin()} if m.gated else k


def _block_keys(b) -> dict:
    """The parameter keys ``block_init`` gives a block of config ``b``
    (``None`` marks a leaf)."""
    k = {}
    if b.mixer != "none":
        k.update(norm1=_norm_keys(b.norm), mixer=_mixer_keys(b))
    if b.cross is not None:
        k.update(norm_cross=_norm_keys(b.norm), cross=_attn_keys(b.cross))
    if b.ffn != "none":
        k["norm2"] = _norm_keys(b.norm)
    if b.ffn == "mlp":
        k["ffn"] = _mlp_keys(b.mlp)
    elif b.ffn == "moe":
        k["ffn"] = {"router": {"w": None}, "up": None, "gate": None,
                    "down": None}
        if b.moe.n_shared:
            k["ffn"]["shared"] = {"up": _lin(), "down": _lin(),
                                  "gate": _lin()}
    return k


def _group_keys(g) -> dict:
    return {kind: {str(i): _block_keys(b) for i, b in enumerate(g.cycle)
                   if b.shared == (kind == "shared")}
            for kind in ("shared", "stacked")}


def _lm_keys(cfg: LMCfg) -> dict:
    k = {"embed": {"table": None},
         "groups": [_group_keys(g) for g in cfg.groups],
         "final_norm": _norm_keys(cfg.final_norm)}
    if cfg.pos_embed == "learned":
        k["pos"] = None
    if not cfg.tie_embeddings:
        k["lm_head"] = _lin()
    if cfg.prefix_embed_dim:
        k["proj"] = _lin(bias=True)
    if cfg.mtp:
        k["mtp"] = {"norm_h": {"scale": None}, "norm_e": {"scale": None},
                    "proj": _lin(), "block": _block_keys(
                        cfg.groups[-1].cycle[-1])}
    return k


def _check_fits(tree, keys, name: str, path: str = "") -> None:
    """Raise unless ``tree`` has exactly the dicts, lists and leaves of the
    key skeleton ``keys``."""
    if keys is None:
        if isinstance(tree, (dict, list, tuple)):
            raise ValueError(f"the tree does not fit {name}: {path} is a "
                             "subtree, not a leaf")
        return
    if isinstance(keys, list):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(keys):
            raise ValueError(f"the tree does not fit {name}: {path} holds "
                             f"{len(tree) if isinstance(tree, list) else tree!r}"
                             f" groups, not {len(keys)}")
        for i, (t, k) in enumerate(zip(tree, keys)):
            _check_fits(t, k, name, f"{path}[{i}]")
        return
    if not isinstance(tree, dict) or set(tree) != set(keys):
        have = sorted(tree) if isinstance(tree, dict) else type(tree)
        raise ValueError(f"the tree does not fit {name}: {path or 'root'} "
                         f"has {have}, expected {sorted(keys)}")
    for k, sub in keys.items():
        _check_fits(tree[k], sub, name, f"{path}.{k}")


def _check_repeats(tree_groups, groups, name: str) -> None:
    for gt, g in zip(tree_groups, groups):
        for block in gt["stacked"].values():
            lead = {np.asarray(a).shape[0] for a in tree_leaves(block)}
            if lead != {g.repeats}:
                raise ValueError(f"stacked leaves of {name} lead with "
                                 f"{sorted(lead)}, not {g.repeats} repeats")


def lm_params_from_numpy(tree, cfg: LMCfg, device=None) -> dict:
    """``jax.tree.map(np.asarray, repro.models.lm.lm_init(...))`` -> the
    port's parameter tree: the same nested dicts and lists
    (``embed.table``, ``groups[i].shared / .stacked`` with the leading
    repeat axis, ``final_norm``, ``pos``, ``lm_head``, ``proj``, ``mtp``,
    and every block's attention, MLA, SSM, MLP and MoE leaves), each leaf
    a tensor of its numpy dtype on ``device``.  Raises if the tree does
    not fit ``cfg``: other keys, another embedding shape, or stacked
    leaves that do not lead with the group's repeats."""
    dev = resolve_device(device)
    _check_fits(tree, _lm_keys(cfg), cfg.name)
    table = np.asarray(tree["embed"]["table"])
    if table.shape != (cfg.vocab, cfg.d_model):
        raise ValueError(f"the tree does not fit {cfg.name}: embed "
                         f"{table.shape}")
    _check_repeats(tree["groups"], cfg.groups, cfg.name)
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=dev), tree)


def whisper_params_from_numpy(tree, cfg, device=None) -> dict:
    """``jax.tree.map(np.asarray, repro.models.whisper.whisper_init(...))``
    -> the port's whisper tree (``embed``, ``pos``, ``enc``/``dec`` groups
    with the layer axis, ``enc_norm``, ``dec_norm``; the decoder blocks'
    cross-attention leaves), checked against ``cfg`` (a ``WhisperCfg``)
    as ``lm_params_from_numpy`` checks an LM's."""
    dev = resolve_device(device)
    keys = {"embed": {"table": None}, "pos": None,
            "enc": _group_keys(cfg.enc_group()), "enc_norm": _norm_keys("ln"),
            "dec": _group_keys(cfg.dec_group()), "dec_norm": _norm_keys("ln")}
    _check_fits(tree, keys, cfg.name)
    if np.asarray(tree["pos"]).shape != (cfg.max_positions, cfg.d_model):
        raise ValueError(f"the tree does not fit {cfg.name}: pos "
                         f"{np.asarray(tree['pos']).shape}")
    _check_repeats([tree["enc"], tree["dec"]],
                   [cfg.enc_group(), cfg.dec_group()], cfg.name)
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=dev), tree)


def _lm_or_whisper_params(tree, cfg, device) -> dict:
    if hasattr(cfg, "dec_group"):
        return whisper_params_from_numpy(tree, cfg, device)
    return lm_params_from_numpy(tree, cfg, device)


def lm_train_state_from_numpy(tree, cfg, device=None) -> dict:
    """A JAX LM (or whisper) train state ``{"params", "opt": {"mu", "nu",
    "step"}}`` (numpy leaves, ``adam_init``'s layout: the moments in the
    parameters' tree) -> the port's: the parameter tree as
    ``lm_params_from_numpy`` builds it (``whisper_params_from_numpy`` for
    a ``WhisperCfg``), the moments as f32 lists in ``tree_leaves`` order
    (``make_train_fns``'s Adam state) and ``step`` a host int."""
    dev = resolve_device(device)
    params = _lm_or_whisper_params(tree["params"], cfg, dev)
    shapes = [tuple(t.shape) for t in tree_leaves(params)]
    opt = {}
    for k in ("mu", "nu"):
        ms = [torch.tensor(np.asarray(a, np.float32), device=dev)
              for a in tree_leaves(tree["opt"][k])]
        if [tuple(m.shape) for m in ms] != shapes:
            raise ValueError(f"opt.{k} does not fit the parameters of "
                             f"{cfg.name}")
        opt[k] = ms
    opt["step"] = int(np.asarray(tree["opt"]["step"]))
    return {"params": params, "opt": opt}


def _np32(t) -> np.ndarray:
    """A tensor as numpy, bf16 as f32 (numpy has no bfloat16; the
    reference's ``bf16_safe_cast``)."""
    t = t.detach()
    return _np(t.float() if t.dtype == torch.bfloat16 else t)


def lm_train_state_to_numpy(state: dict) -> dict:
    """The port's LM train state ``{"params", "opt"}`` -> the JAX
    package's layout, numpy leaves: the parameter tree, ``opt.mu`` and
    ``opt.nu`` in that tree, ``opt.step`` int32; bf16 leaves as f32."""
    params = state["params"]
    opt = state["opt"]
    return _sorted({
        "params": tree_map(_np32, params),
        "opt": {"mu": tree_unflatten(params, [_np32(m) for m in opt["mu"]]),
                "nu": tree_unflatten(params, [_np32(v) for v in opt["nu"]]),
                "step": np.asarray(opt["step"], np.int32)}})
