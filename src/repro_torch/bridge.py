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


def policy_from_numpy(tree, device=None) -> dict:
    """An ``export_policy`` tree -> the port's policy dict.

    ``{"actor": {"layers": [...]}}`` (D3PG denoiser) or ``{"actor":
    [...]}`` (DDPG MLP), and ``{"ddqn": {"q": [...]}}``.  A classical
    cacher's ``{"cache": ...}`` raises until that cacher is ported."""
    if "cache" in tree:
        raise NotImplementedError("classical cachers are not ported yet "
                                  "(ROADMAP queue A, item 4)")
    pol = {}
    if "actor" in tree:
        a = tree["actor"]
        pol["actor"] = (denoiser_from_numpy(a, device) if isinstance(a, dict)
                        else mlp_from_numpy(a, device))
    if "ddqn" in tree:
        pol["ddqn"] = {"q": mlp_from_numpy(tree["ddqn"]["q"], device)}
    return pol


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
