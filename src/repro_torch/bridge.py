"""Carry weights and states across from the JAX package, through numpy.

The caller converts a JAX tree with ``jax.tree.map(np.asarray, tree)``;
these functions take those numpy trees (or anything with the same
attributes) and build the port's objects.  The bridge never imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.env import EnvState, ModelParams
from repro_torch.core.networks import MLP
from repro_torch.device import resolve_device
from repro_torch.diffusion.denoiser import TIME_DIM, Denoiser
from repro_torch.models.lm import LMCfg, check_ported, tree_map


def _f32(a, device):
    return torch.tensor(np.asarray(a, np.float32), device=device)


def mlp_from_numpy(layers, device=None) -> MLP:
    """``[{"w": (in, out), "b": (out,)}, ...]`` -> ``MLP``."""
    dev = resolve_device(device)
    return MLP([_f32(l["w"], dev) for l in layers],
               [_f32(l["b"], dev) for l in layers])


def denoiser_from_numpy(tree, device=None,
                        time_dim: int = TIME_DIM) -> Denoiser:
    """``{"layers": [...]}`` (``repro.diffusion.denoiser_init``) ->
    ``Denoiser``."""
    return Denoiser(mlp_from_numpy(tree["layers"], device), time_dim)


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


def train_state_from_numpy(ts, cfg, device=None) -> dict:
    """A JAX ``t2drl_init`` (or trained, single-cell) train state with
    numpy leaves -> the port's (``repro_torch.core.t2drl.t2drl_init``
    layout): model zoo, D3PG networks, targets and Adam states, DDQN
    networks, target and Adam state, and both replay buffers (integer
    leaves as int64).  ``cfg`` is the port's ``T2DRLCfg``.  The classical
    cachers' ``cache`` state is not carried (ROADMAP A.7)."""
    dev = resolve_device(device)
    d3, dq = ts["d3pg"], ts["ddqn"]
    actor = lambda t: actor_from_numpy(t, dev)  # noqa: E731
    mlp = lambda t: mlp_from_numpy(t, dev)  # noqa: E731
    return {
        "models": models_from_numpy(ts["models"], dev),
        "d3pg": {"actor": actor(d3["actor"]),
                 "actor_t": actor(d3["actor_t"]).requires_grad_(False),
                 "critic": mlp(d3["critic"]),
                 "critic_t": mlp(d3["critic_t"]).requires_grad_(False),
                 "opt_a": _adam_state_from_numpy(d3["opt_a"], actor),
                 "opt_c": _adam_state_from_numpy(d3["opt_c"], mlp)},
        "ddqn": {"q": mlp(dq["q"]),
                 "q_target": mlp(dq["q_target"]).requires_grad_(False),
                 "opt": _adam_state_from_numpy(dq["opt"], mlp)},
        "ebuf": _buffer_from_numpy(ts["ebuf"], dev),
        "fbuf": _buffer_from_numpy(ts["fbuf"], dev),
        "cache": {}}


def models_from_numpy(mp, device=None) -> ModelParams:
    """A JAX ``ModelParams`` (numpy leaves) -> the port's ``ModelParams``."""
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
