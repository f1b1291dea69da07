"""Step pieces of the training path (port of ``repro.launch.steps``): the
performance options that configure a train step
(``launch.train.make_train_fns``) and their tags, the ring-cache and
expert-parallel transforms of a config, the loss a step differentiates,
and the parameter shapes of a config without allocating them.

``PerfOpts(moe_shardmap=True)`` switches every MoE block to the
expert-parallel dispatch (``_apply_moe_shardmap``), which runs where a
mesh is current (``repro_torch.nn.sharding.use_mesh``, around the step or
the forward) and is the global path without one.  The rest of the mesh
half (``batch_spec_for``, ``spec_to_sharding``, FSDP, ``build_step``)
comes with the parameter specs and the dry run (ROADMAP A.12 step 4);
``PerfOpts`` refuses ``fsdp`` naming it.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import lm as lm_mod
from repro_torch.models import whisper as wh_mod

IMPLS = ("plain", "chunked", "kernel")
FSDP_TODO = ("needs the parameter specs over a device mesh: ROADMAP A.12 "
             "step 4, with launch/dryrun.py")


@dataclasses.dataclass(frozen=True)
class PerfOpts:
    """Performance options of a step (the reference's ``PerfOpts``),
    the one way ``make_train_fns`` is configured.

    fsdp         — shard params and Adam moments over the data axes
                   (ZeRO-3); refused here (A.12 step 4).
    bf16_moments — keep Adam mu/nu in bf16 (halves optimizer bytes).
    impl         — attention for train/prefill: 'plain' (materialised
                   scores), 'chunked' (online softmax, O(bq·bk) working
                   set), 'kernel' (the forward-only kernels: refused
                   under grad).
    ring         — sliding-window decode caches become ring buffers of
                   ``window`` slots instead of full-sequence buffers
                   (``_apply_ring``); a train step builds no cache, so
                   ``make_train_fns`` refuses it.
    moe_shardmap — expert-parallel MoE dispatch: each rank of the
                   current mesh's ``"model"`` dimension runs its share of
                   the experts and one all-reduce combines them
                   (``_apply_moe_shardmap``).
    """
    fsdp: bool = False
    bf16_moments: bool = False
    impl: str = "plain"
    ring: bool = False
    moe_shardmap: bool = False

    def __post_init__(self):
        if self.impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, not "
                             f"{self.impl!r}")
        if self.fsdp:
            raise NotImplementedError(f"PerfOpts(fsdp=True) {FSDP_TODO}")

    @property
    def moment_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.bf16_moments else torch.float32

    @property
    def tag(self) -> str:
        parts = []
        if self.bf16_moments:
            parts.append("bf16m")
        if self.impl != "plain":
            parts.append(self.impl)
        if self.ring:
            parts.append("ring")
        if self.moe_shardmap:
            parts.append("moesm")
        return "-".join(parts) or "base"


def _apply_ring(cfg):
    """Flip ring=True on every windowed attention block of a CompositeLM."""
    new_groups = []
    for g in cfg.groups:
        cycle = []
        for b in g.cycle:
            if b.mixer == "attn" and b.attn and b.attn.window:
                b = dataclasses.replace(
                    b, attn=dataclasses.replace(b.attn, ring=True))
            cycle.append(b)
        new_groups.append(dataclasses.replace(g, cycle=tuple(cycle)))
    return dataclasses.replace(cfg, groups=tuple(new_groups))


def _apply_moe_shardmap(cfg):
    """Switch every MoE block of a CompositeLM to the expert-parallel
    dispatch."""
    new_groups = []
    for g in cfg.groups:
        cycle = []
        for b in g.cycle:
            if b.ffn == "moe" and b.moe:
                b = dataclasses.replace(
                    b, moe=dataclasses.replace(b.moe, dispatch="shardmap"))
            cycle.append(b)
        new_groups.append(dataclasses.replace(g, cycle=tuple(cycle)))
    return dataclasses.replace(cfg, groups=tuple(new_groups))


def _loss_fn(arch, cfg, impl: str = "plain", compute_dtype=torch.bfloat16):
    """``loss(params, batch) -> (loss, metrics)``: whisper's (its plain
    path) or the LM's through ``impl``."""
    if arch.kind == "whisper":
        return lambda p, batch: wh_mod.whisper_loss(
            p, cfg, batch, compute_dtype=compute_dtype)
    return lambda p, batch: lm_mod.lm_loss(
        p, cfg, batch, impl=impl, compute_dtype=compute_dtype)


class _MetaGenerator(torch.Generator):
    """A generator whose draws land on the meta device: an init through it
    gives every leaf's shape and dtype and allocates nothing."""

    @property
    def device(self):
        return torch.device("meta")


def param_shapes(arch, cfg) -> dict:
    """The parameter tree of ``cfg`` as meta tensors (shapes and dtypes,
    no storage): the shape half of the reference's ``params_and_specs``;
    its PartitionSpecs come with the mesh half (A.12 step 4)."""
    g = _MetaGenerator()
    if arch.kind == "whisper":
        return wh_mod.whisper_init(g, cfg)
    return lm_mod.lm_init(g, cfg)
