"""Step builders (port of ``repro.launch.steps``): train / prefill /
decode steps of the LM and of whisper, the performance options that
configure them and their tags, the ring-cache and expert-parallel
transforms of a config, and the placements (DTensor's counterpart of the
reference's shardings) of parameters, optimizer state and inputs.

Used by the dry run (``launch.dryrun``: the step traced once on a fake
process group, its arguments DTensors of meta shards) and by the real
training driver (``launch.train.make_train_fns(..., mesh=)``).  A spec
tree becomes placements through ``repro_torch.nn.sharding``; a step runs
under ``use_mesh(mesh)``, where the model's ``constrain`` points
redistribute its activations and its mixers run on local shards.
``PerfOpts(fsdp=True)`` adds the data (and pod) axes to each parameter's
largest unsharded dim (ZeRO-3): Adam's moments follow, and a train
step's gradients come back in the parameters' placements
(reduce-scatter).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.configs import SHAPES, input_specs, make_cfg
from repro_torch.models import lm as lm_mod
from repro_torch.models import whisper as wh_mod
from repro_torch.nn import sharding as shlib
from repro_torch.nn.sharding import P
from repro_torch.optim import adam_init, adam_update

IMPLS = ("plain", "chunked", "kernel")


# -- sharding helpers ---------------------------------------------------------------

def batch_spec_for(mesh, *rest) -> P:
    ba = shlib.batch_axes(mesh)
    lead = ba if len(ba) != 1 else ba[0]
    return P(lead if ba else None, *rest)


def spec_to_sharding(mesh, spec_tree, sds_tree=None):
    """PartitionSpec tree -> tree of placements on ``mesh``.  With
    ``sds_tree`` (tensors, meta or not, of the same layout) each spec is
    shape-fitted first: mesh axes that do not divide their dim are
    dropped."""
    if sds_tree is None:
        return shlib.tree_map_specs(lambda s: shlib.placements(s, mesh),
                                    spec_tree)
    return shlib.tree_map_specs(
        lambda s, x: shlib.placements(shlib.fit_spec(s, x.shape, mesh),
                                      mesh), spec_tree, sds_tree)


def opt_spec(param_spec_tree):
    """Adam state mirrors the param specs, leaf for leaf in the port's
    state layout (``mu``/``nu`` lists in ``tree_leaves`` order); step
    counter replicated."""
    leaves = lm_mod.tree_leaves(param_spec_tree)
    return {"mu": list(leaves), "nu": list(leaves), "step": P()}


def _needs_seq_shard(cfg, mesh) -> Optional[str]:
    """Shard decode KV caches over the sequence dim instead of kv-heads when
    kv-heads cannot fill the model axis (e.g. GQA kv=2 on a 16-way axis)."""
    if "model" not in shlib.axis_names(mesh):
        return None
    msize = shlib.axis_sizes(mesh)["model"]
    try:
        groups = cfg.groups
    except AttributeError:
        return None
    for g in groups:
        for b in g.cycle:
            if b.mixer == "attn" and b.attn.n_kv_heads % msize != 0:
                return "model"
    return None


# -- options ---------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PerfOpts:
    """Performance options of a step (the reference's ``PerfOpts``),
    the one way ``build_step`` and ``make_train_fns`` are configured.

    fsdp         — additionally shard params + Adam moments over the
                   data (and pod) axes, ZeRO-3 style (``fsdp_spec``).
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

    @property
    def moment_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.bf16_moments else torch.float32

    @property
    def tag(self) -> str:
        parts = []
        if self.fsdp:
            parts.append("fsdp")
        if self.bf16_moments:
            parts.append("bf16m")
        if self.impl != "plain":
            parts.append(self.impl)
        if self.ring:
            parts.append("ring")
        if self.moe_shardmap:
            parts.append("moesm")
        return "-".join(parts) or "base"


def fsdp_spec(spec, shape, mesh) -> P:
    """Add the data(+pod) axes to the largest still-unsharded dim of a param
    (ZeRO-3).  Shape-fitting happens downstream in spec_to_sharding."""
    axes = shlib.batch_axes(mesh)      # the data (and pod) axes
    if not axes:
        return spec
    sizes = shlib.axis_sizes(mesh)
    dprod = 1
    for a in axes:
        dprod *= sizes[a]
    entries = list(spec) + [None] * (len(shape) - len(spec))
    used = set()
    for e in entries:
        for a in (e if isinstance(e, tuple) else (e,)):
            if a:
                used.add(a)
    if used & set(axes):
        return spec
    best, best_size = None, 0
    for i, (e, s) in enumerate(zip(entries, shape)):
        if e is None and s % dprod == 0 and s > best_size:
            best, best_size = i, s
    if best is None:
        return spec
    entries[best] = axes if len(axes) > 1 else axes[0]
    return P(*entries)


def apply_fsdp(spec_tree, sds_tree, mesh):
    return shlib.tree_map_specs(lambda s, x: fsdp_spec(s, x.shape, mesh),
                                spec_tree, sds_tree)


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
    no storage)."""
    g = _MetaGenerator()
    if arch.kind == "whisper":
        return wh_mod.whisper_init(g, cfg)
    return lm_mod.lm_init(g, cfg)


def param_specs(arch, cfg) -> dict:
    """The PartitionSpec tree of ``cfg``'s parameters."""
    if arch.kind == "whisper":
        return wh_mod.whisper_spec(cfg)
    return lm_mod.lm_spec(cfg)


def params_and_specs(arch, cfg):
    """(meta parameter tree, PartitionSpec tree) of ``cfg``."""
    return param_shapes(arch, cfg), param_specs(arch, cfg)


def mesh_param_specs(arch, cfg, mesh, fsdp: bool = False,
                     shapes=None) -> dict:
    """The parameter specs on ``mesh``, FSDP's added where ``fsdp``
    (``shapes``: the meta tree, made when not given)."""
    spec = param_specs(arch, cfg)
    if fsdp:
        spec = apply_fsdp(spec, param_shapes(arch, cfg) if shapes is None
                          else shapes, mesh)
    return spec


def shard_tree(tree, spec_tree, mesh):
    """A tree of whole tensors, which every rank holds alike, as DTensors
    with the placements of their fitted specs (each rank keeps its
    shard)."""
    return shlib.tree_map_specs(lambda s, t: shlib.distribute(t, s, mesh),
                                spec_tree, tree)


def meta_tree(tree, spec_tree, mesh):
    """A tree of meta tensors as DTensors of meta shards, the placements
    of their fitted specs."""
    return shlib.tree_map_specs(
        lambda s, t: shlib.meta_dtensor(t.shape, t.dtype, s, mesh),
        spec_tree, tree)


def shard_batch(batch: dict, mesh) -> dict:
    """A batch dict (each leaf batch-leading) as DTensors on ``mesh``'s
    batch axes; DTensors pass through."""
    spec = batch_spec_for(mesh)
    return {k: v if shlib.is_dtensor(v) else shlib.distribute(v, spec, mesh)
            for k, v in batch.items()}


def make_step(loss_fn, lr_schedule, mesh=None, *, max_norm: float = 1.0):
    """``step(params, opt, batch) -> (params, opt, metrics)``: the loss's
    gradient by autograd and the port's Adam with the global norm clipped
    to ``max_norm``, in place; under ``mesh`` the step runs on the mesh,
    plain batch leaves are sharded over its batch axes, and the gradients
    are redistributed to their parameters' placements before Adam.
    Metrics are detached 0-dim tensors (and ``lr``, a float)."""
    def step(params, opt, batch):
        with shlib.use_mesh(mesh):
            if mesh is not None:
                batch = shard_batch(batch, mesh)
            leaves = lm_mod.tree_leaves(params)
            for t in leaves:
                t.requires_grad_(True)
            loss, metrics = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
            grads = [shlib.like(g, t) for g, t in zip(grads, leaves)]
            lr = float(lr_schedule(opt["step"]))
            _, opt, om = adam_update(grads, opt, leaves, lr=lr,
                                     max_norm=max_norm)
            # replicated: a partial DTensor's local value is not its value
            metrics = {k: shlib.constrain(v.detach(), P())
                       for k, v in {**metrics, **om}.items()}
        return params, opt, {**metrics, "lr": lr}
    return step


# -- step builders ------------------------------------------------------------------

@dataclasses.dataclass
class StepBundle:
    """Everything the dry run needs for one (arch, shape): the step, its
    arguments (DTensors of meta shards, positionally), their placements
    and those of its results."""
    step_fn: Callable
    args: Tuple
    in_shardings: Tuple
    out_shardings: Any
    donate_argnums: Tuple = ()


def build_step(arch, shape_name: str, mesh, *, lr: float = 3e-4,
               impl: str = "plain",
               opts: Optional[PerfOpts] = None) -> StepBundle:
    """The (train | prefill | decode) step of ``arch`` at ``shape_name``
    on ``mesh``, with arguments that allocate nothing: parameters,
    moments, inputs and caches are DTensors of meta shards with the
    placements of their fitted specs.  Call ``step_fn(*args)`` under
    ``use_mesh(mesh)``."""
    with shlib.use_mesh(mesh):      # the specs' batch axes are the mesh's
        return _build_step(arch, shape_name, mesh, lr=lr, impl=impl,
                           opts=opts)


def _build_step(arch, shape_name: str, mesh, *, lr, impl, opts):
    opts = opts or PerfOpts(impl=impl)
    impl = opts.impl
    sc = SHAPES[shape_name]
    cfg = make_cfg(arch, shape_name)
    if opts.ring and arch.kind != "whisper":
        cfg = _apply_ring(cfg)
    if opts.moe_shardmap and arch.kind != "whisper":
        cfg = _apply_moe_shardmap(cfg)
    step_kind, inputs = input_specs(arch, shape_name)
    if "cache" in inputs and arch.kind != "whisper":
        # the cache from the (possibly ring-transformed) config
        inputs = dict(inputs)
        inputs["cache"] = lm_mod.lm_init_cache(
            cfg, sc.global_batch, sc.seq_len, dtype=torch.bfloat16,
            device="meta")
    p_sds, p_spec = params_and_specs(arch, cfg)
    if opts.fsdp:
        p_spec = apply_fsdp(p_spec, p_sds, mesh)
    p_shard = spec_to_sharding(mesh, p_spec, p_sds)
    params = meta_tree(p_sds, p_spec, mesh)
    repl = shlib.placements(P(), mesh)

    def bspec(*rest):
        return batch_spec_for(mesh, *rest)

    def binput(name, *rest):
        t = inputs[name]
        spec = shlib.fit_spec(bspec(*rest), t.shape, mesh)
        return shlib.meta_dtensor(t.shape, t.dtype, spec, mesh), \
            shlib.placements(spec, mesh)

    if step_kind == "train":
        opt_sds = adam_init(lm_mod.tree_leaves(p_sds),
                            moment_dtype=opts.moment_dtype)
        o_spec = opt_spec(p_spec)
        opt = {"mu": meta_tree(opt_sds["mu"], o_spec["mu"], mesh),
               "nu": meta_tree(opt_sds["nu"], o_spec["nu"], mesh),
               "step": 0}
        opt_shard = {"mu": spec_to_sharding(mesh, o_spec["mu"],
                                            opt_sds["mu"]),
                     "nu": spec_to_sharding(mesh, o_spec["nu"],
                                            opt_sds["nu"]),
                     "step": repl}
        names = (("frame_embeds", "tokens", "labels")
                 if arch.kind == "whisper" else tuple(inputs))
        batch, batch_shard = {}, {}
        for k in names:
            rest = (None, None) if inputs[k].dim() == 3 else (None,)
            batch[k], batch_shard[k] = binput(k, *rest)
        step = make_step(_loss_fn(arch, cfg, impl), lambda s: lr, mesh)
        return StepBundle(step_fn=step, args=(params, opt, batch),
                          in_shardings=(p_shard, opt_shard, batch_shard),
                          out_shardings=(p_shard, opt_shard, repl),
                          donate_argnums=(0, 1))

    seq_shard = (_needs_seq_shard(cfg, mesh)
                 if step_kind == "decode" else None)
    if arch.kind == "whisper":
        cache_spec = wh_mod.whisper_cache_spec(cfg, seq_shard=seq_shard)
    else:
        cache_spec = lm_mod.lm_cache_spec(cfg, seq_shard=seq_shard)
    cache_shard = spec_to_sharding(mesh, cache_spec, inputs["cache"])
    cache = meta_tree(inputs["cache"], cache_spec, mesh)
    logits_shard = shlib.placements(bspec(None, "model"), mesh)

    if step_kind == "prefill":
        if arch.kind == "whisper":
            def prefill_step(params, frame_embeds, tokens, cache):
                return wh_mod.whisper_prefill(params, cfg, frame_embeds,
                                              tokens, cache, impl=impl)
            ins = (binput("frame_embeds", None, None),
                   binput("tokens", None))
        elif "prefix_embeds" in inputs:
            def prefill_step(params, prefix_embeds, tokens, cache):
                return lm_mod.lm_prefill(params, cfg, tokens, cache,
                                         prefix_embeds=prefix_embeds,
                                         impl=impl)
            ins = (binput("prefix_embeds", None, None),
                   binput("tokens", None))
        else:
            def prefill_step(params, tokens, cache):
                return lm_mod.lm_prefill(params, cfg, tokens, cache,
                                         impl=impl)
            ins = (binput("tokens", None),)
        return StepBundle(
            step_fn=prefill_step,
            args=(params, *(a for a, _ in ins), cache),
            in_shardings=(p_shard, *(s for _, s in ins), cache_shard),
            out_shardings=(logits_shard, cache_shard),
            donate_argnums=(len(ins) + 1,))

    # decode
    if arch.kind == "whisper":
        def decode_step(params, token, cache, pos):
            return wh_mod.whisper_decode(params, cfg, token, cache, pos)
    else:
        def decode_step(params, token, cache, pos):
            return lm_mod.lm_decode(params, cfg, token, cache, pos)
    token, token_shard = binput("token", None)
    return StepBundle(
        step_fn=decode_step, args=(params, token, cache, inputs["pos"]),
        in_shardings=(p_shard, token_shard, cache_shard, repl),
        out_shardings=(logits_shard, cache_shard),
        donate_argnums=(2,))
