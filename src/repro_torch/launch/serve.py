"""Serving demo — the continuous-batching engine at smoke scale (port
of ``repro.launch.serve``).

Usage (on the card):
  python -m repro_torch.launch.serve --arch qwen2-0.5b --requests 8
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_arch
from repro_torch.device import make_generator, resolve_device
from repro_torch.models.lm import lm_init
from repro_torch.serving import Engine, ServeCfg


def serve_demo(arch_name: str, *, n_requests: int = 8, max_batch: int = 4,
               max_seq: int = 256, seed: int = 0, device=None):
    """Serve ``n_requests`` random prompts (lengths 4-31, budgets 4-23,
    drawn from ``seed`` with numpy as in the JAX demo) through the smoke
    config of ``arch_name`` with random weights from ``seed``."""
    dev = resolve_device(device)
    arch = get_arch(arch_name)
    if arch.kind == "whisper":
        raise SystemExit("whisper serving demo: the engine serves decoder-"
                         "only LMs; drive whisper_prefill/whisper_decode")
    cfg = arch.make_smoke()
    params = lm_init(make_generator(seed, dev), cfg)
    eng = Engine(cfg, params, ServeCfg(max_batch=max_batch, max_seq=max_seq),
                 device=dev)
    rng = np.random.default_rng(seed)
    reqs = [(i, rng.integers(0, cfg.vocab, size=rng.integers(4, 32),
                             dtype=np.int32), int(rng.integers(4, 24)))
            for i in range(n_requests)]
    t0 = time.perf_counter()
    done, stats = eng.run(reqs)
    wall = time.perf_counter() - t0
    total_toks = sum(len(v) for v in done.values())
    print(f"arch={arch.name} (smoke) requests={n_requests} "
          f"generated={total_toks} tokens in {wall:.2f}s "
          f"({total_toks / wall:.1f} tok/s, "
          f"{stats['decode_steps']} batched decode steps) on {dev}")
    return done, stats


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=256)
    args = ap.parse_args()
    serve_demo(args.arch, n_requests=args.requests,
               max_batch=args.max_batch, max_seq=args.max_seq)


if __name__ == "__main__":
    main()
