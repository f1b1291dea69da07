"""Quickstart on the PyTorch port: the paper's T2DRL (DDQN caching +
diffusion-actor D3PG allocation) on the edge-AIGC environment, through
``repro_torch``'s public names alone.  The twin of ``quickstart.py``.

  PYTHONPATH=src python examples/quickstart_torch.py [--episodes 80] \\
      [--device cpu]

Runs on the card (``cuda:0``) unless ``--device cpu`` is given.  B = 4
edge cells train in lockstep, one shared learner fed by all of them; the
cells draw from ``cell_generators(cfg.seed, 4)``.
"""
import argparse

import numpy as np

from repro_torch.core import (EnvCfg, T2DRLCfg, cell_generators,
                              run_eval_batch, t2drl_init_batch, train_t2drl)
from repro_torch.scenarios import build_scenario


def _mean(hist: dict, key: str) -> float:
    """Mean over episodes and cells of a ``run_eval_batch`` history."""
    return float(np.mean(hist[key]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--episodes", type=int, default=80)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the host (default: the card)")
    args = ap.parse_args()

    # 1. the paper's simulation setup (Table 2): 10 users, 10 GenAI
    #    models, 10 frames x 10 slots, 20 GB edge cache.
    cfg = T2DRLCfg(
        env=EnvCfg(U=10, M=10, T=10, K=10, C=20.0),
        allocator="d3pg",       # diffusion-actor DDPG (the paper's D3PG)
        cacher="ddqn",          # long-timescale caching agent
        policy="shared",        # one learner fed by all cells
        L=5,                    # denoising steps (paper Fig. 6a optimum)
        lr_actor=1e-4, lr_critic=1e-3, lr_ddqn=1e-3,  # CI-scale tuned lrs
        episodes=args.episodes,
    )

    # 2. train: 4 heterogeneous edge cells in lockstep
    ts, hist = train_t2drl(cfg, num_envs=4, log_every=20,
                           device=args.device)

    # 3. greedy evaluation (mean over episodes and cells)
    ev = run_eval_batch(ts, cfg, episodes=5, device=args.device)
    print("\n== greedy eval ==")
    print(f"model hit ratio : {_mean(ev, 'hit_ratio'):.3f}")
    print(f"total utility G : {_mean(ev, 'utility'):.2f}  "
          "(lower is better)")
    print(f"mean slot reward: {_mean(ev, 'mean_reward'):.2f}")

    # 4. the random baseline on the SAME per-cell model zoos (the same
    #    cell generators draw the same zoos first).  80 episodes is
    #    quickstart scale; the paper trains 500.
    rcars = T2DRLCfg(env=cfg.env, allocator="rcars", cacher="random")
    base = t2drl_init_batch(cell_generators(cfg.seed, 4, args.device), rcars)
    ev_r = run_eval_batch(base, rcars, episodes=5, device=args.device)
    print(f"\nRCARS baseline  : hit {_mean(ev_r, 'hit_ratio'):.3f} "
          f"reward {_mean(ev_r, 'mean_reward'):.2f}")
    print(f"T2DRL           : hit {_mean(ev, 'hit_ratio'):.3f} "
          f"reward {_mean(ev, 'mean_reward'):.2f}  "
          "(objective: higher reward = lower delay+quality cost w/ "
          "deadlines)")

    # 5. stress the trained policy on a registered workload scenario
    #    (flash crowds pile most users onto one hot model every few
    #    slots); the schedule only modulates the env's draws.
    burst = build_scenario("flash-crowd", cfg.env, num_envs=4,
                           device=args.device)
    ev_b = run_eval_batch(ts, cfg, episodes=5, mods=burst.mods,
                          device=args.device)
    print(f"\nT2DRL under flash-crowd bursts: hit "
          f"{_mean(ev_b, 'hit_ratio'):.3f} "
          f"reward {_mean(ev_b, 'mean_reward'):.2f}")


if __name__ == "__main__":
    main()
