#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device   — requires CUDA (exits non-zero without it); card name and
               power limit from nvidia-smi.
2. build    — builds every kernel in src/repro_torch/kernels/csrc with nvcc
               for sm_90a, one nvcc per source, all started together.
3. kernel_check  — each kernel against its plain PyTorch version on the card
               (f32 to 2e-5, bf16 to 2e-2), at the serving path's shapes.
4. kernel_timing — CUDA-event times of kernel and plain version, in turns,
               beside the card's bound for the same bytes and flops.
5. control_plane — greedy T2DRL episodes at the paper's EnvCfg() (d3pg/ddqn,
               then rcars/random); checks stats, simplexes, and that the
               ddpm_step kernel ran exactly L*T*K times per d3pg episode.
6. data_plane    — the edge gateway loop of examples/serve_edge.py against the
               port: 10 diffusion models at image_dim=256, total_steps=1000,
               3 frames x 4 slots; checks the kernel ran once per reverse step.

Then a ``kernels`` line (per kernel: route, source, the TPU kernel it
replaces, launches on the serving path, error, times and bound) and, last,
``{"ok": true, "device": {...}}``.  Launch counts are reset just before each
serving path runs and read just after, so comparison and timing launches do
not count.  Phases 5 and 6 take a device, so the CPU tests run them small.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))

import torch  # noqa: E402

from repro_torch.core.d3pg import (amend_actions,  # noqa: E402
                                   make_actor_schedule)
from repro_torch.core.env import (EnvCfg, env_advance_frame,  # noqa: E402
                                  env_reset, env_set_cache, env_step_slot,
                                  make_models, observe)
from repro_torch.core.t2drl import (STAT_KEYS, T2DRLCfg,  # noqa: E402
                                    greedy_frame_cache, greedy_slot_action,
                                    policy_init, run_eval)
from repro_torch.device import make_generator, resolve_device  # noqa: E402
from repro_torch.diffusion import time_embedding  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.serving import (CatalogEntry, EdgeGateway,  # noqa: E402
                                 toy_diffusion_builder)

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

KERNEL_CHECK_SHAPES = [((20,), torch.float32), ((1, 20), torch.float32),
                       ((64, 20), torch.float32), ((2, 3, 40), torch.float32),
                       ((1, 7), torch.float32), ((256,), torch.float32),
                       ((8, 256), torch.bfloat16),
                       ((4096, 256), torch.float32)]
TIMING_SHAPES = [(20,), (256,), (65536, 256)]
DDPM_COEF = (0.9, 0.5, 0.04)          # alpha, alpha_bar, beta_tilde


class SmokeError(RuntimeError):
    pass


def require(cond, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# -- 1. device ----------------------------------------------------------------

def phase_device() -> dict:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    return {"phase": "device", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}


# -- 2. build -----------------------------------------------------------------

def phase_build() -> dict:
    t0 = time.perf_counter()
    info = build.build_all()
    out = {"phase": "build", "seconds": time.perf_counter() - t0}
    for name, r in info.items():
        ptxas = [l.strip() for l in r["log"].splitlines()
                 if "registers" in l or "spill" in l]
        out[name] = {"seconds": r["seconds"], "cached": r["cached"],
                     "ptxas": ptxas}
    return out


# -- 3. kernel vs plain version -------------------------------------------------

def _ddpm_inputs(shape, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(device=device, dtype=dtype)
            for _ in range(3)]


def phase_kernel_check(device) -> dict:
    errs, cases = [], []
    alpha, abar, btilde = DDPM_COEF
    for i, (shape, dtype) in enumerate(KERNEL_CHECK_SHAPES):
        x, e, n = _ddpm_inputs(shape, dtype, device, seed=100 + i)
        for l_rev in (0, 3):
            c1, c2, sigma = ops.ddpm_coefficients(alpha, abar, btilde, l_rev)
            out = ops.ddpm_step(x, e, n, alpha, abar, btilde, l_rev)
            expect = ref.ddpm_step_ref(x, e, n, c1, c2, sigma)
            sync(device)
            require(out.shape == x.shape and out.dtype == dtype,
                    f"ddpm_step output {out.shape} {out.dtype}")
            err = (out.float() - expect.float()).abs().max().item()
            require(err <= TOL[dtype], f"ddpm_step {shape} {dtype} "
                    f"l_rev={l_rev}: max abs err {err} > {TOL[dtype]}")
            errs.append(err)
            cases.append({"shape": list(shape), "dtype": str(dtype),
                          "l_rev": l_rev, "max_abs_err": err})
    # the last step (l_rev == 0) ignores the noise entirely
    x, e, n1 = _ddpm_inputs((4, 16), torch.float32, device, seed=7)
    n2 = torch.randn_like(n1)
    o1 = ops.ddpm_step(x, e, n1, *DDPM_COEF, 0)
    o2 = ops.ddpm_step(x, e, n2, *DDPM_COEF, 0)
    sync(device)
    require(torch.equal(o1, o2), "ddpm_step at l_rev=0 depends on noise")
    return {"phase": "kernel_check", "ddpm_step": {
        "max_abs_err": max(errs), "cases": cases,
        "last_step_deterministic": True}}


# -- 4. kernel timing -----------------------------------------------------------

def _time_ms(fn, iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def ddpm_bound_ms(n: int, itemsize: int):
    """Least time for one update of n elements: 3 reads + 1 write over HBM
    against 5 f32 flops an element; returns (ms, "bytes"|"operations")."""
    t_bytes = 4 * n * itemsize / HBM_BYTES_PER_S
    t_ops = 5 * n / F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def phase_kernel_timing(device) -> dict:
    alpha, abar, btilde = DDPM_COEF
    c1, c2, sigma = ops.ddpm_coefficients(alpha, abar, btilde, 3)
    rows = []
    for shape in TIMING_SHAPES:
        x, e, n = _ddpm_inputs(shape, torch.float32, device, seed=11)
        numel = x.numel()
        iters = 200 if numel > 1 << 20 else 2000

        def kernel():
            ops.ddpm_step(x, e, n, alpha, abar, btilde, 3)

        def plain():
            ref.ddpm_step_ref(x, e, n, c1, c2, sigma)

        for fn in (kernel, plain):       # warm-up
            for _ in range(20):
                fn()
        torch.cuda.synchronize()
        p1, k1, k2, p2 = (_time_ms(plain, iters), _time_ms(kernel, iters),
                          _time_ms(kernel, iters), _time_ms(plain, iters))
        bound, by = ddpm_bound_ms(numel, 4)
        rows.append({"shape": list(shape), "dtype": "float32",
                     "iters": iters, "ms": (k1 + k2) / 2,
                     "ms_runs": [k1, k2], "plain_ms": (p1 + p2) / 2,
                     "plain_ms_runs": [p1, p2], "bound_ms": bound,
                     "bound_by": by, "library_ms": None})
    return {"phase": "kernel_timing", "ddpm_step": rows}


# -- 5. control plane -----------------------------------------------------------

def _plain_chain(p, sched, state, x_L, noises):
    """The reverse chain with the plain ddpm_step (no kernel): the
    reference for the sampler on the card."""
    L = sched.L
    te = time_embedding(torch.arange(1, L + 1, device=state.device),
                        p.time_dim)
    x = x_L
    with torch.no_grad():
        for i in range(L):
            l_rev = L - 1 - i
            eps_hat = p(x, None, state, te=te[l_rev])
            c = ops.ddpm_coefficients(sched.alphas_host[l_rev],
                                      sched.alpha_bars_host[l_rev],
                                      sched.beta_tildes_host[l_rev], l_rev)
            x = ref.ddpm_step_ref(x, eps_hat, noises[i], *c)
    return torch.tanh(x)


def _check_simplexes(b, xi, env) -> None:
    gate = env.rho[env.req]
    require(bool(torch.all(b >= 0)) and abs(b.sum().item() - 1.0) < 1e-5,
            f"b is off the simplex: {b.tolist()}")
    require(bool(torch.all(xi >= 0)) and bool(torch.all(xi[gate == 0] == 0)),
            f"xi is not cache-gated: {xi.tolist()} gate {gate.tolist()}")
    want = 1.0 if bool(torch.any(gate > 0)) else 0.0
    require(abs(xi.sum().item() - want) < 1e-5,
            f"xi sums to {xi.sum().item()}, expected {want}")


def phase_control_plane(device, env_cfg: EnvCfg = EnvCfg(),
                        episodes: int = 3) -> dict:
    dev = resolve_device(device)
    cfg = T2DRLCfg(env=env_cfg)
    models = make_models(make_generator(1, dev), env_cfg)
    policy = policy_init(cfg, seed=0, device=dev)
    per_episode = cfg.L * env_cfg.T * env_cfg.K

    # the serving path: counts reset just before, read just after
    ops.reset_launches()
    sync(dev)
    t0 = time.perf_counter()
    hist = run_eval(policy, models, cfg, episodes=episodes, device=dev)
    sync(dev)
    wall = time.perf_counter() - t0
    launches = ops.LAUNCHES["ddpm_step"]
    base_cfg = T2DRLCfg(env=env_cfg, allocator="rcars", cacher="random")
    ops.reset_launches()
    t1 = time.perf_counter()
    base = run_eval({}, models, base_cfg, episodes=1, device=dev)
    sync(dev)
    base_wall = time.perf_counter() - t1
    base_launches = ops.LAUNCHES["ddpm_step"]

    for name, h in (("d3pg/ddqn", hist), ("rcars/random", base)):
        require(all(math.isfinite(v) for vs in h.values() for v in vs),
                f"{name}: non-finite episode stats {h}")
    if dev.type == "cuda":
        require(launches == per_episode * episodes,
                f"ddpm_step launched {launches} times in {episodes} d3pg "
                f"episodes, expected {per_episode * episodes}")
        require(base_launches == 0, f"rcars launched ddpm_step "
                f"{base_launches} times")

    # simplexes over one frame, and one slot through kernel vs plain chain
    g = make_generator(5, dev)
    env = env_advance_frame(env_reset(g, env_cfg), env_cfg)
    env = env_set_cache(env, greedy_frame_cache(policy, cfg, models,
                                                env.gamma_idx))
    for _ in range(env_cfg.K):
        b, xi = greedy_slot_action(policy, cfg, env, models, g)
        _check_simplexes(b, xi, env)
        env, _, _ = env_step_slot(env, env_cfg, models, b, xi)
    d3 = cfg.d3pg_cfg()
    A = env_cfg.action_dim
    x_L = torch.randn(A, generator=g, device=dev)
    noises = torch.randn((cfg.L, A), generator=g, device=dev)
    b1, xi1 = greedy_slot_action(policy, cfg, env, models, x_L=x_L,
                                 noises=noises)
    raw = 0.5 * (_plain_chain(policy["actor"], make_actor_schedule(d3),
                              observe(env, env_cfg, models), x_L, noises)
                 + 1.0)
    b2, xi2 = amend_actions(raw, env.req, env.rho, env_cfg.U)
    slot_err = max((b1 - b2).abs().max().item(),
                   (xi1 - xi2).abs().max().item())
    require(slot_err <= TOL[torch.float32],
            f"greedy slot action kernel vs plain: max abs err {slot_err}")
    means = {k: sum(hist[k]) / len(hist[k]) for k in STAT_KEYS}
    return {"phase": "control_plane", "env": {"U": env_cfg.U, "M": env_cfg.M,
                                              "T": env_cfg.T, "K": env_cfg.K},
            "episodes": episodes, "wall_s": wall,
            "wall_s_per_episode": wall / episodes, "stats": means,
            "ddpm_step_launches": launches,
            "expected_launches": per_episode * episodes,
            "rcars_random": {"wall_s": base_wall,
                             "stats": {k: base[k][0] for k in STAT_KEYS},
                             "ddpm_step_launches": base_launches},
            "slot_kernel_vs_plain_max_abs_err": slot_err}


# -- 6. data plane --------------------------------------------------------------

def phase_data_plane(device, env_cfg: EnvCfg = EnvCfg(T=3, K=4),
                     image_dim: int = 256, total_steps: int = 1000) -> dict:
    dev = resolve_device(device)
    cfg = T2DRLCfg(env=env_cfg)
    models = make_models(make_generator(2, dev), env_cfg)
    policy = policy_init(cfg, seed=0, device=dev)
    host = {f: getattr(models, f).tolist()
            for f in ("c", "a1", "a2", "a3", "a4", "b1", "b2")}
    catalogue = [CatalogEntry(
        model_id=m, name=f"diffusion-{m}", kind="diffusion",
        size_gb=host["c"][m], builder=toy_diffusion_builder(m, image_dim),
        a1=host["a1"][m], a2=host["a2"][m], a3=host["a3"][m],
        a4=host["a4"][m], b1=host["b1"][m], b2=host["b2"][m])
        for m in range(env_cfg.M)]
    gw = EdgeGateway(catalogue, capacity_gb=env_cfg.C, image_dim=image_dim,
                     total_steps=total_steps, device=dev)
    g = make_generator(3, dev)
    env = env_reset(g, env_cfg)

    slots, frames, steps_run = [], [], 0
    ops.reset_launches()
    sync(dev)
    t0 = time.perf_counter()
    for t in range(env_cfg.T):
        env = env_advance_frame(env, env_cfg)
        rho = greedy_frame_cache(policy, cfg, models, env.gamma_idx)
        env = env_set_cache(env, rho)
        info = gw.apply_caching(rho.cpu().numpy())
        frames.append({"frame": t, "gamma": int(env.gamma_idx),
                       "loaded": sorted(gw.loaded), **info})
        for k in range(env_cfg.K):
            sync(dev)
            ts = time.perf_counter()
            b, xi = greedy_slot_action(policy, cfg, env, models, g)
            results = gw.serve_slot(env.req.tolist(), xi.cpu().numpy(), g)
            env, r, m = env_step_slot(env, env_cfg, models, b, xi)
            r = r.item()
            slot_wall = time.perf_counter() - ts
            served = [x for x in results if x.cached]
            steps_run += sum(x.steps for x in served)
            require(all(x.output_shape == (image_dim,) for x in served),
                    "gateway output shape")
            slots.append({
                "frame": t, "slot": k, "reward": r,
                "edge_served": len(served), "users": env_cfg.U,
                "steps": sum(x.steps for x in served),
                "measured_exec_s": sum(x.measured_wall_s for x in results),
                "modeled_delay_s": sum(x.modeled_delay for x in results),
                "slot_wall_s": slot_wall})
    sync(dev)
    wall = time.perf_counter() - t0
    launches = ops.LAUNCHES["ddpm_step"]
    expected = cfg.L * env_cfg.T * env_cfg.K + steps_run
    if dev.type == "cuda":
        require(launches == expected,
                f"data plane launched ddpm_step {launches} times, expected "
                f"{expected} (actor {cfg.L}/slot + one per image step)")
    require(all(math.isfinite(s["reward"]) for s in slots),
            "non-finite slot reward")

    # one image chain of a loaded model: kernel vs plain on the same draws
    loaded = sorted(gw.loaded)
    chain_err = None
    if loaded:
        n_steps = min(total_steps, 50)
        x_L = torch.randn(image_dim, generator=g, device=dev)
        noises = torch.randn((n_steps, image_dim), generator=g, device=dev)
        out = gw.diffusion_sample(loaded[0], n_steps, x_L=x_L, noises=noises)
        expect = _plain_chain(gw.loaded[loaded[0]], gw._schedule(n_steps),
                              gw._state, x_L, noises)
        require(bool(torch.all(torch.isfinite(out)))
                and float(out.abs().max()) <= 1.0, "image chain output")
        chain_err = (out - expect).abs().max().item()
        require(chain_err <= TOL[torch.float32],
                f"image chain kernel vs plain: max abs err {chain_err}")
    return {"phase": "data_plane", "image_dim": image_dim,
            "total_steps": total_steps, "frames": frames, "slots": slots,
            "wall_s": wall, "image_steps": steps_run,
            "ddpm_step_launches": launches, "expected_launches": expected,
            "measured_exec_s": sum(s["measured_exec_s"] for s in slots),
            "modeled_delay_s": sum(s["modeled_delay_s"] for s in slots),
            "image_chain_kernel_vs_plain_max_abs_err": chain_err}


# -- main -----------------------------------------------------------------------

def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev_info = phase_device()
    emit(dev_info)
    device = resolve_device()
    emit(phase_build())
    check = phase_kernel_check(device)
    emit(check)
    timing = phase_kernel_timing(device)
    emit(timing)
    control = phase_control_plane(device)
    emit(control)
    data = phase_data_plane(device)
    emit(data)
    # the kernels line: times at the gateway's per-step shape (256,), the
    # shape of most launches on the serving path
    row = next(r for r in timing["ddpm_step"] if r["shape"] == [256])
    emit({"kernels": [{
        "name": "ddpm_step", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ddpm_step.cu",
        "replaces": "src/repro/kernels/ddpm_step.py:20",
        "launches": control["ddpm_step_launches"]
        + data["ddpm_step_launches"],
        "max_abs_err": check["ddpm_step"]["max_abs_err"],
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None, "shape": row["shape"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
