"""Carry weights and states across from the JAX package, through numpy.

The caller converts a JAX tree with ``jax.tree.map(np.asarray, tree)``;
these functions take those numpy trees (or anything with the same
attributes) and build the port's objects.  The bridge never imports JAX.
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
from repro_torch.models.lm import LMCfg, check_ported, tree_map


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
    [...]}`` (DDPG MLP), and ``{"ddqn": {"q": [...]}}``.  A classical
    cacher's ``{"cache": ...}`` raises until that cacher is ported."""
    if "cache" in tree:
        raise NotImplementedError("classical cachers are not ported yet "
                                  "(ROADMAP queue A, item 7)")
    pol = {}
    if "actor" in tree:
        pol["actor"] = actor_from_numpy(tree["actor"], device)
    if "ddqn" in tree:
        pol["ddqn"] = {"q": mlp_from_numpy(tree["ddqn"]["q"], device)}
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
    ``cache`` state is not carried (ROADMAP A.7)."""
    dev = resolve_device(device)
    if np.asarray(ts["models"].a1).ndim == 1:
        return {"models": models_from_numpy(ts["models"], dev),
                **_learners_from_numpy(ts["d3pg"], ts["ddqn"], dev),
                "ebuf": _buffer_from_numpy(ts["ebuf"], dev),
                "fbuf": _buffer_from_numpy(ts["fbuf"], dev), "cache": {}}
    B = np.asarray(ts["models"].a1).shape[0]
    out = {"models": models_from_numpy(ts["models"], dev), "cache": {}}
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


def lm_params_from_numpy(tree, cfg: LMCfg, device=None) -> dict:
    """``jax.tree.map(np.asarray, repro.models.lm.lm_init(...))`` -> the
    port's parameter tree: the same nested dicts and lists
    (``embed.table``, ``groups[i].shared / .stacked`` with the leading
    repeat axis, ``final_norm``, the per-block attention, SSM and MLP
    leaves), each leaf a tensor of its numpy dtype on ``device``.  Raises
    if ``cfg`` is not ported or the tree does not fit it."""
    check_ported(cfg)
    dev = resolve_device(device)
    table = np.asarray(tree["embed"]["table"])
    if table.shape != (cfg.vocab, cfg.d_model) \
            or len(tree["groups"]) != len(cfg.groups):
        raise ValueError(f"the tree does not fit {cfg.name}: embed "
                         f"{table.shape}, {len(tree['groups'])} groups")
    for gt, g in zip(tree["groups"], cfg.groups):
        for block in gt["stacked"].values():
            lead = {np.asarray(a).shape[0] for a in _leaves(block)}
            if lead != {g.repeats}:
                raise ValueError(f"stacked leaves of {cfg.name} lead with "
                                 f"{sorted(lead)}, not {g.repeats} repeats")
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=dev), tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]
