"""Step pieces of the single-device training path (port of the
single-device part of ``repro.launch.steps``): the performance options
that configure a train step (``launch.train.make_train_fns``) and their
tags, the ring-cache transform, the loss a step differentiates, and the
parameter shapes of a config without allocating them.

The mesh and sharding half (``batch_spec_for``, ``spec_to_sharding``,
FSDP, the shard_map MoE dispatch and ``build_step``) belongs to the
multi-device work with the dry run (ROADMAP A.12); ``PerfOpts`` refuses
``fsdp`` and ``moe_shardmap`` naming it.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import lm as lm_mod
from repro_torch.models import whisper as wh_mod

IMPLS = ("plain", "chunked", "kernel")
MESH_TODO = ("needs a device mesh: the multi-device slice (ROADMAP A.12, "
             "with launch/dryrun.py)")


@dataclasses.dataclass(frozen=True)
class PerfOpts:
    """Performance options of a step (the reference's ``PerfOpts``),
    the one way ``make_train_fns`` is configured.

    fsdp         — shard params and Adam moments over the data axes
                   (ZeRO-3); refused here (A.12).
    bf16_moments — keep Adam mu/nu in bf16 (halves optimizer bytes).
    impl         — attention for train/prefill: 'plain' (materialised
                   scores), 'chunked' (online softmax, O(bq·bk) working
                   set), 'kernel' (the forward-only kernels: refused
                   under grad).
    ring         — sliding-window decode caches become ring buffers of
                   ``window`` slots instead of full-sequence buffers
                   (``_apply_ring``); a train step builds no cache, so
                   ``make_train_fns`` refuses it.
    moe_shardmap — expert-parallel dispatch over a mesh; refused here
                   (A.12).
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
        for name in ("fsdp", "moe_shardmap"):
            if getattr(self, name):
                raise NotImplementedError(f"PerfOpts({name}=True) "
                                          f"{MESH_TODO}")

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
    its PartitionSpecs wait for the mesh (A.12)."""
    g = _MetaGenerator()
    if arch.kind == "whisper":
        return wh_mod.whisper_init(g, cfg)
    return lm_mod.lm_init(g, cfg)
