"""LM training loop and CLI (port of ``repro.launch.train``): every
architecture of the registry, on the card unless ``--device cpu`` is
given.

Usage:
  python -m repro_torch.launch.train --arch qwen2-0.5b --steps 200
  python -m repro_torch.launch.train --arch mamba2-130m --full --steps 20 \\
      --ckpt build/mamba2.ckpt

A step is the loss (``lm_loss`` through ``impl="plain"`` or ``"chunked"``,
or ``whisper_loss``), its gradient by autograd, the warmup-cosine
learning rate at the optimizer's step, and the port's Adam with the
gradients clipped to a global norm of 1.0.  ``steps.PerfOpts`` configures
it (the CLI sets its ``impl``).  ``impl="kernel"`` is refused
under grad by the kernels, as the reference's ``flash``/``pallas``
cannot be differentiated.  ``--ckpt`` writes ``{"params", "opt"}`` in the
JAX package's layout, bf16 leaves as f32, which its ``load_pytree``
reads (``bridge.lm_train_state_from_numpy`` reads it back).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.bridge import lm_train_state_to_numpy
from repro_torch.checkpoint import save_pytree
from repro_torch.configs import get_arch
from repro_torch.data import make_lm_batch
from repro_torch.device import make_generator, resolve_device
from repro_torch.launch.steps import (IMPLS, PerfOpts, _apply_moe_shardmap,
                                      _loss_fn, make_step, mesh_param_specs,
                                      shard_tree)
from repro_torch.models import lm as lm_mod
from repro_torch.models import whisper as wh_mod
from repro_torch.optim import adam_init, linear_warmup_cosine

def make_train_fns(arch, cfg, *, lr_schedule, opts: PerfOpts = PerfOpts(),
                   compute_dtype=torch.bfloat16, mesh=None):
    """(init_fn(generator) -> (params, opt), train_step(params, opt,
    batch) -> (params, opt, metrics)) of the step ``opts`` configures:
    the loss through ``opts.impl``, Adam's moments in
    ``opts.moment_dtype``.  The loss computes in ``compute_dtype`` (the
    reference's bf16 default; f32 for parity tests).  The step works in
    place: the parameter leaves and Adam's moments are overwritten;
    ``opt`` is ``adam_init``'s state over ``lm_mod.tree_leaves(params)``.
    Metrics are detached 0-dim tensors (``loss``, ``xent``,
    ``aux``/``mtp_xent`` where the loss has them, ``gnorm`` before
    clipping) and ``lr``, a float.  ``opts.moe_shardmap``: the MoE
    blocks dispatch expert-parallel over the mesh.

    ``mesh`` (a ``DeviceMesh`` of every rank): ``init_fn`` shards the
    parameters by their specs (FSDP's added with ``opts.fsdp``), which
    every rank draws alike from its generator, so each keeps its shard;
    Adam's moments follow them; the step runs on the mesh
    (``steps.make_step``): a batch of whole tensors is sharded over its
    batch axes, and metrics are replicated DTensors."""
    if opts.ring:
        raise ValueError("PerfOpts(ring=True) turns decode caches into "
                         "rings; a train step builds no cache")
    if opts.moe_shardmap and arch.kind != "whisper":
        cfg = _apply_moe_shardmap(cfg)
    loss_fn = _loss_fn(arch, cfg, opts.impl, compute_dtype)
    init = wh_mod.whisper_init if arch.kind == "whisper" else lm_mod.lm_init

    def init_fn(generator):
        params = init(generator, cfg)
        if mesh is not None:
            params = shard_tree(params, mesh_param_specs(
                arch, cfg, mesh, opts.fsdp), mesh)
        return params, adam_init(lm_mod.tree_leaves(params),
                                 moment_dtype=opts.moment_dtype)

    return init_fn, make_step(loss_fn, lr_schedule, mesh)


def make_batch_fn(arch, cfg, *, batch: int, seq_len: int, device=None):
    """``fn(generator) -> batch`` (a CPU generator; the batch lands on
    ``device``), matched to the architecture: whisper adds (batch,
    n_frames, d_model) frame embeddings of scale 0.02; a VLM takes
    ``min(n_prefix, seq_len // 2)`` patch slots from the sequence
    (``prefix_embeds`` of scale 0.02, the text shortened to match)."""
    dev = resolve_device(device)
    n_pre = getattr(arch, "n_prefix", 0)

    def fn(generator):
        b = make_lm_batch(generator, vocab=cfg.vocab, batch=batch,
                          seq_len=seq_len, device=dev)
        if arch.kind == "whisper":
            b["frame_embeds"] = (0.02 * torch.randn(
                (batch, cfg.n_frames, cfg.d_model),
                generator=generator)).to(dev)
        elif n_pre and arch.prefix_embed_dim:
            npre = min(n_pre, seq_len // 2)
            b["tokens"] = b["tokens"][:, : seq_len - npre]
            b["prefix_embeds"] = (0.02 * torch.randn(
                (batch, npre, arch.prefix_embed_dim),
                generator=generator)).to(dev)
        return b
    return fn


def train_setup(arch_name: str, *, smoke: bool = True, steps: int = 200,
                batch: int = 8, seq_len: int = 128, lr: float = 3e-4,
                opts: PerfOpts = PerfOpts(), device=None):
    """(arch, cfg, lr schedule, init_fn, train_step, batch_fn) as
    ``train_loop`` uses them; a VLM's smoke config brings its own (small)
    prefix sizes."""
    arch = get_arch(arch_name)
    cfg = arch.make_smoke() if smoke else arch.make_full()
    if getattr(cfg, "prefix_embed_dim", 0):
        arch = arch.__class__(**{**arch.__dict__,
                                 "n_prefix": cfg.n_prefix,
                                 "prefix_embed_dim": cfg.prefix_embed_dim})
    sched = linear_warmup_cosine(lr, warmup=min(20, steps // 10 + 1),
                                 steps=steps)
    init_fn, train_step = make_train_fns(arch, cfg, lr_schedule=sched,
                                         opts=opts)
    batch_fn = make_batch_fn(arch, cfg, batch=batch, seq_len=seq_len,
                             device=device)
    return arch, cfg, sched, init_fn, train_step, batch_fn


def train_loop(arch_name: str, *, smoke: bool = True, steps: int = 200,
               batch: int = 8, seq_len: int = 128, lr: float = 3e-4,
               log_every: int = 20, seed: int = 0,
               opts: PerfOpts = PerfOpts(), ckpt: str = "", device=None):
    """Train ``arch_name`` (its smoke or full config) for ``steps`` steps
    from random f32 weights (``make_generator(seed, device)``), batches
    from a CPU generator seeded by ``seed``.  Returns (params, opt, hist):
    hist has one dict a step, the metrics as floats and ``s``, the step's
    wall seconds (the metrics' read waits for the device)."""
    dev = resolve_device(device)
    _, cfg, _, init_fn, train_step, batch_fn = train_setup(
        arch_name, smoke=smoke, steps=steps, batch=batch, seq_len=seq_len,
        lr=lr, opts=opts, device=dev)
    params, opt = init_fn(make_generator(seed, dev))
    data = torch.Generator().manual_seed(int(seed))
    hist = []
    t0 = time.perf_counter()
    for step in range(steps):
        ts = time.perf_counter()
        params, opt, m = train_step(params, opt, batch_fn(data))
        row = {k: float(v) for k, v in m.items()}
        row["s"] = time.perf_counter() - ts
        hist.append(row)
        if log_every and (step + 1) % log_every == 0:
            print(f"step {step + 1:5d} loss {row['loss']:7.4f} "
                  f"xent {row['xent']:7.4f} gnorm {row['gnorm']:8.3f} "
                  f"({(time.perf_counter() - t0) / (step + 1):.2f} s/step)",
                  flush=True)
    if ckpt:
        save_pytree(ckpt, lm_train_state_to_numpy(
            {"params": params, "opt": opt}))
        print(f"saved checkpoint to {ckpt}")
    return params, opt, hist


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--impl", default="plain", choices=IMPLS)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the host (default: the card)")
    args = ap.parse_args()
    _, _, hist = train_loop(args.arch, smoke=args.smoke, steps=args.steps,
                            batch=args.batch, seq_len=args.seq_len,
                            lr=args.lr, ckpt=args.ckpt,
                            opts=PerfOpts(impl=args.impl),
                            seed=args.seed, device=args.device)
    print(f"final loss {hist[-1]['loss']:.4f} (first {hist[0]['loss']:.4f})")


if __name__ == "__main__":
    main()
