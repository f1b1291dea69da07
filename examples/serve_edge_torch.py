"""Edge AIGC gateway demo on the PyTorch port, the twin of
``serve_edge.py``: the paper's full control loop against real model
execution, through ``repro_torch``'s public names alone.

A trained T2DRL policy drives: the DDQN picks which GenAI models the edge
caches each frame; the D3PG splits bandwidth and compute each slot; the
gateway executes cached requests: diffusion image models run a DDPM
reverse chain with xi*L steps, LM models generate tokens through the
continuous-batching engine.

  PYTHONPATH=src python examples/serve_edge_torch.py [--frames 3 \\
      --slots 4] [--device cpu]

Runs on the card (``cuda:0``) unless ``--device cpu`` is given.
"""
import argparse

from repro_torch.configs import get_arch
from repro_torch.core import (EnvCfg, T2DRLCfg, actor_act, amend_actions,
                              amend_caching, ddqn_act, env_reset,
                              make_actor_schedule, observe, train_t2drl)
from repro_torch.core.env import env_new_frame, env_step_slot
from repro_torch.device import make_generator, resolve_device
from repro_torch.models import lm_init
from repro_torch.serving import CatalogEntry, EdgeGateway, Engine, ServeCfg
from repro_torch.serving.gateway import toy_diffusion_builder


def build_catalogue(models, device):
    """M=6 GenAI models: 4 diffusion image models + 2 smoke LMs from the
    assigned-architecture pool."""
    host = {f: getattr(models, f).tolist()
            for f in ("c", "a1", "a2", "a3", "a4", "b1", "b2")}

    def coef(m):
        return {f: host[f][m] for f in ("a1", "a2", "a3", "a4", "b1", "b2")}

    cat = []
    for m, what in enumerate(("faces", "places", "art", "maps")):
        cat.append(CatalogEntry(
            model_id=m, name=f"repaint-{what}",
            kind="diffusion", size_gb=host["c"][m],
            builder=toy_diffusion_builder(m, 64), **coef(m)))

    def lm_builder(arch_name, seed):
        def build():
            cfg = get_arch(arch_name).make_smoke()
            params = lm_init(make_generator(seed, device), cfg)
            return Engine(cfg, params, ServeCfg(max_batch=2, max_seq=128),
                          device=device)
        return build

    for m, arch_name in ((4, "qwen2-0.5b"), (5, "mamba2-130m")):
        cat.append(CatalogEntry(
            model_id=m, name=f"{arch_name}-smoke", kind="lm",
            size_gb=host["c"][m], builder=lm_builder(arch_name, m),
            **coef(m)))
    return cat


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--train-episodes", type=int, default=30)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the host (default: the card)")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    g = make_generator(0, dev)
    env_cfg = EnvCfg(U=6, M=6, T=args.frames, K=args.slots, C=20.0)
    cfg = T2DRLCfg(env=env_cfg, lr_actor=1e-4, lr_critic=1e-3,
                   lr_ddqn=1e-3, episodes=args.train_episodes, warmup=20)

    print(f"training T2DRL policy ({args.train_episodes} episodes)...")
    ts, _ = train_t2drl(cfg, device=dev)
    models = ts["models"]
    d3 = cfg.d3pg_cfg()
    dq = cfg.ddqn_cfg()
    sched = make_actor_schedule(d3)

    gw = EdgeGateway(build_catalogue(models, dev), capacity_gb=env_cfg.C,
                     image_dim=64, total_steps=100, device=dev)
    env = env_reset(g, env_cfg)

    for t in range(args.frames):
        a_int = ddqn_act(ts["ddqn"], dq, env.gamma_idx, g, 0.0)
        rho = amend_caching(a_int, dq, models.c, env_cfg.C)
        env = env_new_frame(env, env_cfg, rho)
        info = gw.apply_caching(rho.cpu().numpy())
        print(f"\n== frame {t}: gamma={int(env.gamma_idx)} "
              f"cache={rho.nonzero().flatten().tolist()} "
              f"loaded={sorted(gw.loaded)} used={info['used_gb']:.1f}GB "
              f"(load {info['load_s']:.2f}s)")
        for k in range(args.slots):
            s = observe(env, env_cfg, models)
            raw = actor_act(ts["d3pg"]["actor"], d3, sched, s, g)
            b, xi = amend_actions(raw, env.req, env.rho, env_cfg.U)
            results = gw.serve_slot(env.req.tolist(), xi.cpu().numpy(), g)
            env, r, m = env_step_slot(env, env_cfg, models, b, xi)
            served = sum(1 for x in results if x.cached)
            wall = sum(x.measured_wall_s for x in results)
            print(f"  slot {k}: reward {float(r):8.2f} "
                  f"hit {float(m['cached'].float().mean()):.2f} "
                  f"edge-served {served}/{env_cfg.U} "
                  f"(measured exec {wall:.2f}s, modeled "
                  f"{sum(x.modeled_delay for x in results):.1f}s)")
    print("\ndone — the paper's two-timescale control plane drove real "
          "model loading and execution end-to-end.")


if __name__ == "__main__":
    main()
