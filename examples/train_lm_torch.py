"""End-to-end driver on the PyTorch port, the twin of ``train_lm.py``:
train a ~100M-param CompositeLM for a few hundred steps on the synthetic
learnable stream, with a checkpoint, through ``repro_torch``'s public
names alone.

  PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] \\
      [--device cpu]

Runs on the card (``cuda:0``) unless ``--device cpu`` is given: f32
weights, bf16 compute, the port's Adam.
"""
import argparse
import time

import torch

from repro_torch.checkpoint import bf16_safe_cast, save_pytree
from repro_torch.configs import Arch
from repro_torch.device import make_generator, resolve_device
from repro_torch.launch.train import make_batch_fn, make_train_fns
from repro_torch.models import BlockCfg, GroupCfg, LMCfg
from repro_torch.nn.attention import AttnCfg
from repro_torch.nn.core import count_params
from repro_torch.nn.mlp import MLPCfg
from repro_torch.optim import linear_warmup_cosine

CKPT = "experiments/lm100m_torch.msgpack"


def make_100m():
    """~100M params: 12L, d_model=640, GQA 10/5 heads, d_ff=2560, 32k
    vocab."""
    blk = BlockCfg(d_model=640, mixer="attn", ffn="mlp",
                   attn=AttnCfg(640, 10, 5, 64, rope_theta=1e6),
                   mlp=MLPCfg(640, 2560))
    return LMCfg(name="lm-100m", vocab=32768, d_model=640,
                 groups=(GroupCfg((blk,), 12),))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the host (default: the card)")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = make_100m()
    # an ad-hoc arch for the generic train step
    arch = Arch(name=cfg.name, family="dense", cite="(example)",
                make_full=lambda **kw: cfg, make_smoke=lambda: cfg)
    lrs = linear_warmup_cosine(3e-4, warmup=30, steps=args.steps)
    init_fn, step_fn = make_train_fns(arch, cfg, lr_schedule=lrs)
    batch_fn = make_batch_fn(arch, cfg, batch=args.batch,
                             seq_len=args.seq_len, device=dev)
    params, opt = init_fn(make_generator(0, dev))
    print(f"model: {cfg.name}  params: {count_params(params) / 1e6:.1f}M")
    data = torch.Generator().manual_seed(0)
    t0 = time.time()
    first = None
    for step in range(args.steps):
        params, opt, m = step_fn(params, opt, batch_fn(data))
        loss = float(m["loss"])
        first = first if first is not None else loss
        if (step + 1) % 25 == 0:
            tps = args.batch * args.seq_len * (step + 1) / (time.time() - t0)
            print(f"step {step + 1:4d}  loss {loss:7.4f}  "
                  f"({tps:,.0f} tok/s)", flush=True)
    print(f"\nloss: {first:.3f} -> {loss:.3f} over {args.steps} steps")
    save_pytree(CKPT, bf16_safe_cast(params))
    print(f"checkpoint saved to {CKPT}")


if __name__ == "__main__":
    main()
