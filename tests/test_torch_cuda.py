"""Card-only tests of the port: each hand-written kernel against its plain
version on the card, its launch counter and its rejections, the serving
paths' launch counts (one ddpm_chain per reverse chain, or one ddpm_step
per reverse step with ``impl="step"``; 24 flash_attention or ssd_scan
launches per full-width prefill), and the training path: the step
sampler's gradients through ddpm_step and ddpm_step_bwd, the chain's
through ddpm_chain's record and ddpm_chain_bwd, one d3pg_update on the
card against the CPU with either policy chain, and a two-episode
train_t2drl; the chain kernels' learner axis against the plain stacked
versions and, slice by slice, the single-learner launches; one fused
D3PG update on the card against the CPU; a fused vector-env run whose
first update is held against the same run on the CPU, and a shared
one; LM training's ``chunked_attention`` and one train step on the card
against the CPU.

Run on a machine with an NVIDIA GPU (it has no JAX, so skip the suite's
conftest, which imports it):

    PYTHONPATH=src python -m pytest -m cuda --noconftest tests/test_torch_cuda.py

Card presence is decided inside the ``cuda`` fixture, never at import, so
every worker collects the same tests; without a card they skip.
"""
import pytest
import torch

import numpy as np
import torch.nn.functional as F

from repro_torch.configs import get_arch
from repro_torch.core.env import EnvCfg, make_models
from repro_torch.core.t2drl import T2DRLCfg, policy_init, run_eval
from repro_torch.device import make_generator
from repro_torch.diffusion import (denoiser_init, make_schedule,
                                   reverse_sample, reverse_sample_actions)
from repro_torch.kernels import build, ops, ref
from repro_torch.models.lm import lm_init, lm_init_cache, lm_prefill
from repro_torch.serving import CatalogEntry, EdgeGateway, \
    toy_diffusion_builder

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# ||out - ref|| / ||ref|| of flash_attention (bf16 rounding gives ~1e-3)
FLASH_REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run pytest -m cuda --noconftest "
                    "tests/test_torch_cuda.py on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    return torch.device("cuda", 0)


def _inputs(shape, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(device=device, dtype=dtype)
            for _ in range(3)]


@pytest.mark.parametrize("shape,dtype,l_rev", [
    ((20,), torch.float32, 4), ((4, 20), torch.float32, 0),
    ((4, 20), torch.float32, 3), ((2, 3, 40), torch.float32, 1),
    ((8, 256), torch.bfloat16, 2), ((1, 7), torch.float32, 0),
    ((256,), torch.float32, 999), ((4096, 256), torch.float32, 5),
    ((1000003,), torch.float32, 1)])
def test_ddpm_step_kernel_matches_plain(cuda, shape, dtype, l_rev):
    x, e, n = _inputs(shape, dtype, cuda, seed=len(shape))
    c = ops.ddpm_coefficients(0.9, 0.5, 0.04, l_rev)
    out = ops.ddpm_step(x, e, n, 0.9, 0.5, 0.04, l_rev)
    expect = ref.ddpm_step_ref(x, e, n, *c)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == x.shape
    assert (out.float() - expect.float()).abs().max().item() <= TOL[dtype]
    # and against the plain version on the CPU
    cpu = ref.ddpm_step_ref(x.cpu(), e.cpu(), n.cpu(), *c)
    assert (out.cpu().float() - cpu.float()).abs().max().item() <= TOL[dtype]


def test_ddpm_step_last_step_is_deterministic(cuda):
    x, e, n1 = _inputs((4, 16), torch.float32, cuda, seed=1)
    n2 = torch.randn_like(n1)
    assert torch.equal(ops.ddpm_step(x, e, n1, 0.9, 0.5, 0.04, 0),
                       ops.ddpm_step(x, e, n2, 0.9, 0.5, 0.04, 0))


def test_launch_counter_counts_kernel_launches_only(cuda):
    x, e, n = _inputs((20,), torch.float32, cuda, seed=2)
    before = ops.LAUNCHES["ddpm_step"]
    for _ in range(3):
        ops.ddpm_step(x, e, n, 0.9, 0.5, 0.04, 1)
    ref.ddpm_step_ref(x, e, n, 1.0, 0.1, 0.2)
    ops.ddpm_step(x.cpu(), e.cpu(), n.cpu(), 0.9, 0.5, 0.04, 1)
    assert ops.LAUNCHES["ddpm_step"] == before + 3


def test_ddpm_step_rejects_what_the_kernel_does_not_take(cuda):
    x, e, n = _inputs((8, 6), torch.float32, cuda, seed=3)
    with pytest.raises(ValueError, match="contiguous"):
        ops.ddpm_step(x.t(), e.t(), n.t(), 0.9, 0.5, 0.04, 1)
    with pytest.raises(ValueError):
        ops.ddpm_step(x, e.cpu(), n, 0.9, 0.5, 0.04, 1)


@pytest.mark.parametrize("shape,dtype", [
    ((20,), torch.float32), ((64, 20), torch.float32),
    ((256,), torch.bfloat16), ((1000003,), torch.float32),
    ((64, 20), torch.bfloat16)])
def test_ddpm_step_bwd_kernel_matches_plain(cuda, shape, dtype):
    """The backward kernel bit for bit against its plain version (one
    rounded product per output), counted once per call."""
    g = _inputs(shape, dtype, cuda, seed=7)[0]
    c1, c2, _ = ops.ddpm_coefficients(0.9, 0.5, 0.04, 2)
    before = ops.LAUNCHES["ddpm_step_bwd"]
    dx, de = ops.ddpm_step_bwd(g, c1, c2)
    wx, we = ref.ddpm_step_bwd_ref(g, c1, c2)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ddpm_step_bwd"] == before + 1
    assert torch.equal(dx, wx) and torch.equal(de, we)
    cx, ce = ref.ddpm_step_bwd_ref(g.cpu(), c1, c2)
    assert torch.equal(dx.cpu(), cx) and torch.equal(de.cpu(), ce)


def test_step_sampler_gradients_through_the_kernels(cuda):
    """Gradients of sum(w * x_0) through reverse_sample(impl="step") on the
    card (5 ddpm_step and 5 ddpm_step_bwd launches) against the same
    chain on the CPU (plain versions), to 2e-5 of each gradient's max."""
    from repro_torch.bridge import denoiser_from_numpy
    rng = np.random.default_rng(0)
    layers = [{"w": rng.standard_normal((i, o)).astype(np.float32)
               / np.sqrt(i), "b": 0.1 * rng.standard_normal(o).astype(
                   np.float32)}
              for i, o in zip((86, 128, 128, 128), (128, 128, 128, 20))]
    s, x_L = rng.standard_normal((64, 50)), rng.standard_normal((64, 20))
    noises = rng.standard_normal((5, 64, 20))
    w = rng.standard_normal((64, 20))
    grads = {}
    for dev in (cuda, "cpu"):
        p = denoiser_from_numpy({"layers": layers}, device=dev)
        t = lambda a: torch.tensor(a, dtype=torch.float32,  # noqa: E731
                                   device=dev)
        ops.reset_launches()
        x0 = reverse_sample(p, make_schedule(5), t(s), 20, x_L=t(x_L),
                            noises=t(noises), impl="step")
        grads[str(dev)] = [g.cpu() for g in torch.autograd.grad(
            torch.sum(t(w) * x0), list(p.parameters()))]
        if dev == cuda:
            assert {k: ops.LAUNCHES[k] for k in
                    ("ddpm_step", "ddpm_step_bwd", "ddpm_chain")} == \
                {"ddpm_step": 5, "ddpm_step_bwd": 5, "ddpm_chain": 0}
    for a, b in zip(grads[str(cuda)], grads["cpu"]):
        assert (a - b).abs().max().item() <= 2e-5 * b.abs().max().item()


def _d3pg_on(dev):
    """One d3pg state on ``dev`` from a seed on the CPU, with a buffer-like
    minibatch and the chains' draws."""
    from repro_torch.core.t2drl import t2drl_init
    cfg = T2DRLCfg(env=EnvCfg(U=4, M=5), lr_actor=1e-4, lr_critic=1e-3)
    ts = t2drl_init(torch.Generator().manual_seed(0), cfg)
    d3 = ts["d3pg"]
    to = lambda m: m.to(dev)  # noqa: E731
    for k in ("actor", "actor_t", "critic", "critic_t"):
        to(d3[k])
    for k in ("opt_a", "opt_c"):
        d3[k] = {"mu": [m.to(dev) for m in d3[k]["mu"]],
                 "nu": [v.to(dev) for v in d3[k]["nu"]], "step": 0}
    g = torch.Generator().manual_seed(1)
    n, S, U, M, A = 64, cfg.env.state_dim, 4, 5, 8
    batch = {"s": torch.randn(n, S, generator=g),
             "a": torch.rand(n, A, generator=g), "r": torch.randn(n,
                                                               generator=g),
             "s1": torch.randn(n, S, generator=g),
             "req": torch.randint(0, M, (n, U), generator=g),
             "rho": torch.randint(0, 2, (n, M), generator=g).float(),
             "req1": torch.randint(0, M, (n, U), generator=g),
             "rho1": torch.randint(0, 2, (n, M), generator=g).float()}
    draws = {k: (torch.randn(n, A, generator=g),
                 torch.randn(cfg.L, n, A, generator=g))
             for k in ("target", "policy")}
    return (cfg, d3, {k: v.to(dev) for k, v in batch.items()},
            {k: tuple(t.to(dev) for t in v) for k, v in draws.items()})


@pytest.mark.parametrize("impl", ["chain", "step"])
def test_d3pg_update_on_card_matches_cpu(cuda, impl):
    """One d3pg_update on the card against the same update on the CPU from
    the same state, batch and draws: losses to 1e-4, and Adam's first
    moments (0.1 g) to 1e-4 of each leaf's max.  Its launches: the target
    chain's ddpm_chain, then for impl="chain" the policy chain's
    ddpm_chain and one ddpm_chain_bwd, for impl="step" 5 ddpm_step and 5
    ddpm_step_bwd."""
    from repro_torch.core.d3pg import d3pg_update
    from repro_torch.agents.allocators import actor_schedule
    want = {"chain": {"ddpm_chain": 2, "ddpm_chain_bwd": 1, "ddpm_step": 0,
                      "ddpm_step_bwd": 0},
            "step": {"ddpm_chain": 1, "ddpm_chain_bwd": 0, "ddpm_step": 5,
                     "ddpm_step_bwd": 5}}[impl]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        cfg, d3, batch, draws = _d3pg_on(dev)
        ops.reset_launches()
        new, m = d3pg_update(d3, cfg.d3pg_cfg(),
                             actor_schedule(cfg.d3pg_cfg()), batch,
                             draws=draws, impl=impl)
        if dev.type == "cuda":
            assert {k: ops.LAUNCHES[k] for k in want} == want
        out[dev.type] = (m, new)
    (mc, nc), (mh, nh) = out["cuda"], out["cpu"]
    for k in mc:
        assert abs(mc[k].item() - mh[k].item()) <= 1e-4 * abs(mh[k].item())
    for opt in ("opt_a", "opt_c"):
        for a, b in zip(nc[opt]["mu"], nh[opt]["mu"]):
            assert (a.cpu() - b).abs().max().item() <= \
                1e-4 * b.abs().max().item()


def test_train_t2drl_two_episodes_on_card(cuda):
    from repro_torch.core.t2drl import eval_t2drl, export_policy, \
        train_t2drl
    cfg = T2DRLCfg(env=EnvCfg(U=4, M=5, T=4, K=5), warmup=10, lr_actor=1e-4,
                   lr_critic=1e-3, lr_ddqn=1e-3)
    ops.reset_launches()
    ts, hist = train_t2drl(cfg, episodes=2)
    n = ts["d3pg"]["opt_a"]["step"]
    assert n == 30          # 10 in episode 1 (size0 = 10, 15), 20 in 2
    # acting, each update's target and policy chains, one chain backward
    # per update, no step kernel
    assert {k: ops.LAUNCHES[k] for k in
            ("ddpm_chain", "ddpm_chain_bwd", "ddpm_step",
             "ddpm_step_bwd")} == \
        {"ddpm_chain": 2 * 4 * 5 + 2 * n, "ddpm_chain_bwd": n,
         "ddpm_step": 0, "ddpm_step_bwd": 0}
    # batch 64: 8 clusters, whose partial sums a second grid adds up
    assert ops.GRIDS["ddpm_chain_bwd"] == 2 * n
    assert ops.CLUSTERS["ddpm_chain_bwd"] == 8 * n
    assert all(np.isfinite(v) for vs in hist.values() for v in vs)
    assert ts["models"].c.device.type == "cuda"
    out = eval_t2drl(export_policy(ts, cfg), ts["models"], cfg, episodes=1)
    assert all(np.isfinite(v) for v in out.values())


@pytest.mark.parametrize("impl", ["chain", "step"])
def test_sampler_on_card_matches_cpu(cuda, impl):
    """64 actor chains on the card, through one ddpm_chain launch (5
    ddpm_step launches with impl="step"), against the CPU."""
    p = denoiser_init(50, 20, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    s, x_L = torch.randn(64, 50, generator=g), torch.randn(64, 20, generator=g)
    noises = torch.randn(5, 64, 20, generator=g)
    sched = make_schedule(5)
    ops.reset_launches()
    on_card = reverse_sample_actions(p.to(cuda), sched, s.to(cuda), 20,
                                     x_L=x_L.to(cuda), noises=noises.to(cuda),
                                     impl=impl)
    want = {"chain": {"ddpm_chain": 1, "ddpm_step": 0},
            "step": {"ddpm_chain": 0, "ddpm_step": 5}}[impl]
    assert {k: ops.LAUNCHES[k] for k in want} == want
    on_cpu = reverse_sample_actions(p.cpu(), sched, s, 20, x_L=x_L,
                                    noises=noises, impl=impl)
    assert (on_card.cpu() - on_cpu).abs().max().item() <= 2e-5


def _greedy_episode_launches(cuda, impl):
    """Launch counts of 2 greedy episodes (T = 3, K = 2) run slot by slot
    through ``greedy_slot_action(impl=...)``."""
    from repro_torch.core.env import (env_advance_frame, env_reset,
                                      env_set_cache, env_step_slot)
    from repro_torch.core.t2drl import greedy_frame_cache, greedy_slot_action
    cfg = T2DRLCfg(env=EnvCfg(U=4, M=4, T=3, K=2))
    pol = policy_init(cfg, seed=0, device=cuda)
    models = make_models(make_generator(1, cuda), cfg.env)
    g = make_generator(2, cuda)
    ops.reset_launches()
    for _ in range(2):
        env = env_reset(g, cfg.env)
        for _ in range(cfg.env.T):
            env = env_advance_frame(env, cfg.env)
            env = env_set_cache(env, greedy_frame_cache(pol, cfg, models,
                                                        env.gamma_idx, g))
            for _ in range(cfg.env.K):
                b, xi = greedy_slot_action(pol, cfg, env, models, g,
                                           impl=impl)
                env, _, _ = env_step_slot(env, cfg.env, models, b, xi)
    return cfg, dict(ops.LAUNCHES)


def test_greedy_episode_launches_l_t_k(cuda):
    """Default serving: one ddpm_chain per slot, T*K per episode, through
    run_eval."""
    cfg = T2DRLCfg(env=EnvCfg(U=4, M=4, T=3, K=2))
    pol = policy_init(cfg, seed=0, device=cuda)
    models = make_models(make_generator(1, cuda), cfg.env)
    ops.reset_launches()
    hist = run_eval(pol, models, cfg, episodes=2, device=cuda)
    assert ops.LAUNCHES["ddpm_chain"] == ops.GRIDS["ddpm_chain"] == 2 * 3 * 2
    assert ops.LAUNCHES["ddpm_step"] == 0
    assert all(len(v) == 2 for v in hist.values())


@pytest.mark.parametrize("impl", ["step", "chain"])
def test_greedy_episode_launches_l_t_k_step_impl(cuda, impl):
    """The same episodes slot by slot: impl="step" launches ddpm_step
    L*T*K times per episode, the chain T*K times."""
    cfg, got = _greedy_episode_launches(cuda, impl)
    want = ({"ddpm_step": 2 * cfg.L * 3 * 2, "ddpm_chain": 0}
            if impl == "step" else {"ddpm_step": 0, "ddpm_chain": 2 * 3 * 2})
    assert {k: got[k] for k in want} == want


def _gateway(cuda):
    cat = [CatalogEntry(model_id=i, name=f"m{i}", kind="diffusion",
                        size_gb=4.0, builder=toy_diffusion_builder(i, 64))
           for i in range(2)]
    gw = EdgeGateway(cat, capacity_gb=8.0, image_dim=64, total_steps=100,
                     device=cuda)
    gw.apply_caching([1.0, 1.0])
    return gw


def test_gateway_launches_one_per_image_step(cuda):
    """The gateway's default path: one ddpm_chain launch per image, none
    of ddpm_step (an image of 25, 50 and 25 steps)."""
    gw = _gateway(cuda)
    ops.reset_launches()
    res = gw.serve_slot([0, 1, 0], [0.25, 0.5, 0.25],
                        make_generator(0, cuda))
    assert [r.steps for r in res] == [25, 50, 25]
    assert ops.LAUNCHES["ddpm_chain"] == 3 and ops.LAUNCHES["ddpm_step"] == 0
    assert all(r.measured_wall_s > 0 for r in res)


def test_gateway_image_chain_step_impl_launches_one_per_step(cuda):
    """The same image chains with impl="step": one ddpm_step per image
    step (100), and the same images as the chain to 2e-5."""
    gw = _gateway(cuda)
    out = {}
    for impl in ("step", "chain"):
        ops.reset_launches()
        out[impl] = [
            reverse_sample(gw.loaded[m], gw._schedule(n), gw._state, 64,
                           generator=make_generator(3, cuda), impl=impl)
            for m, n in ((0, 25), (1, 50), (0, 25))]
        if impl == "step":
            assert ops.LAUNCHES["ddpm_step"] == 100
            assert ops.GRIDS["ddpm_step"] == 100
    for a, b in zip(out["step"], out["chain"]):
        assert (a - b).abs().max().item() <= 2e-5


# -- ddpm_chain ------------------------------------------------------------------

def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHAIN_CASE_NAMES = ["control", "control_R16", "data_L1", "data_L50",
                    "data_L1000", "odd_widths", "empty_slice"]


@pytest.mark.parametrize("name", CHAIN_CASE_NAMES)
def test_ddpm_chain_kernel_matches_plain(cuda, name):
    """chip_smoke's kernel_check cases: 2e-5 against the plain version
    where L <= 50, and every case within ``chain_exact_tol`` of the exact
    f64 chain (L = 1000 included); one launch, one grid, ceil(R / 8)
    clusters."""
    cs = _chip_smoke()
    i = CHAIN_CASE_NAMES.index(name)
    _, dims, S, R, L, kind = cs.CHAIN_CASES[i]
    c = cs._chain_inputs(dims, S, R, L, kind, cuda, 400 + i)
    args = cs._chain_args(c)
    ops.reset_launches()
    out = ops.ddpm_chain(*args)
    expect = ref.ddpm_chain_ref(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ddpm_chain"] == ops.GRIDS["ddpm_chain"] == 1
    assert ops.CLUSTERS["ddpm_chain"] == -(-R // 8)
    assert out.shape == (R, dims[-1]) and bool(torch.isfinite(out).all())
    if L <= 50:
        assert torch.allclose(out, expect, rtol=2e-5, atol=2e-5)
    exact = cs.chain_exact(*args)
    assert cs._tol_ratio(out, exact, cs.chain_exact_tol(L)) <= 1.0


def test_ddpm_chain_rejects_on_the_card(cuda):
    cs = _chip_smoke()
    c = cs._chain_inputs(cs.CTRL_DIMS, 50, 2, 5, "paper", cuda, 3)
    net, x, s, n, coef, te = cs._chain_args(c)
    with pytest.raises(ValueError, match="contiguous"):
        ops.ddpm_chain(net, x, s, n.transpose(0, 1).contiguous()
                       .transpose(0, 1), coef, te)
    with pytest.raises(ValueError):
        ops.ddpm_chain(net, x, s.cpu(), n, coef, te)
    with pytest.raises(TypeError):
        ops.ddpm_chain(net, x.double(), s, n, coef, te)


CHAIN_GRAD_NAMES = ["train", "control_R1", "odd_widths", "empty_slice", "R37",
                    "L50"]


@pytest.mark.parametrize("name", CHAIN_GRAD_NAMES)
def test_ddpm_chain_bwd_kernel_matches_plain(cuda, name):
    """chip_smoke's ddpm_chain_bwd cases: the gradients of sum(w * x_0)
    through DdpmChain (one ddpm_chain with its record, one ddpm_chain_bwd)
    within 2e-5 of each leaf's max of the plain backward on the kernel's
    record, within ``chain_grad_exact_tol`` of the exact f64 gradients,
    and the same bits twice; one grid for one cluster, two (the partial
    sums, then their sum in cluster order) for more."""
    cs = _chip_smoke()
    i = CHAIN_GRAD_NAMES.index(name)
    _, dims, S, R, L, kind = cs.CHAIN_GRAD_CASES[i]
    c = cs._chain_inputs(dims, S, R, L, kind, cuda, 600 + i)
    w = cs._randn(torch.Generator().manual_seed(700 + i), R,
                  dims[-1]).to(cuda)
    ops.reset_launches()
    got = cs._chain_grad(c, w)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ddpm_chain"] == ops.LAUNCHES["ddpm_chain_bwd"] == 1
    clusters = -(-R // 8)
    assert ops.CLUSTERS["ddpm_chain_bwd"] == clusters
    assert ops.GRIDS["ddpm_chain_bwd"] == (1 if clusters == 1 else 2)
    again = cs._chain_grad(c, w)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _, rec = ops.ddpm_chain(*cs._chain_args(c), record=True)
    want = ref.ddpm_chain_bwd_ref(c["net"], rec, c["state"], c["coef"],
                                  c["te"], w)
    assert cs._leaf_rel(got, want[0] + want[1]) <= 2e-5
    exact = cs._exact_chain_grad(c, w)
    assert cs._leaf_rel(got, exact) <= cs.chain_grad_exact_tol(L)


@pytest.mark.parametrize("name", ["control", "control_R64", "odd_widths",
                                  "data_L50"])
def test_ddpm_chain_record_leaves_the_forward_as_it_was(cuda, name):
    """The forward with a record gives x_0 bit for bit as without one, and
    its record (every step's x and hidden outputs) holds the plain
    version's to 2e-5."""
    cs = _chip_smoke()
    names = [c[0] for c in cs.CHAIN_CASES]
    i = names.index(name)
    _, dims, S, R, L, kind = cs.CHAIN_CASES[i]
    c = cs._chain_inputs(dims, S, R, L, kind, cuda, 400 + i)
    args = cs._chain_args(c)
    x0, rec = ops.ddpm_chain(*args, record=True)
    _, rec_plain = ref.ddpm_chain_ref(*args, record=True)
    torch.cuda.synchronize()
    assert torch.equal(x0, ops.ddpm_chain(*args))
    assert rec.shape == (L, R, ops.chain_record_width(dims))
    assert torch.equal(rec[0, :, :dims[-1]], c["x_L"])
    assert torch.allclose(rec, rec_plain, rtol=2e-5, atol=2e-5)


# the row-tiled plan (R >= ops.CHAIN_ROW_TILED_FROM): both decide cells'
# widths at R = 4096, the threshold (R = 125: a tile 3 rows short), a last
# tile one row short (R = 4095), and widths that leave threads of a tile
# without columns (90, 30; 100, 5)
ROW_TILED_CASES = [
    ("table2_R4096", (86, 128, 128, 128, 20), 50, 4096, 5),
    ("u18l10_R4096", (134, 128, 128, 128, 36), 82, 4096, 10),
    ("table2_R125", (86, 128, 128, 128, 20), 50, 125, 5),
    ("u18l10_R4095", (134, 128, 128, 128, 36), 82, 4095, 10),
    ("odd_widths_R200", (53, 90, 90, 90, 30), 7, 200, 7),
    ("empty_slice_R129", (25, 100, 100, 5), 4, 129, 3)]


@pytest.mark.parametrize("name,dims,S,R,L", ROW_TILED_CASES)
def test_ddpm_chain_row_tiled_matches_plain(cuda, name, dims, S, R, L):
    """The row-tiled plan: one launch of one grid and no cluster, counted
    in ``ROW_TILED``; x_0 within 2e-5 of the plain version and within
    ``chain_exact_tol`` of the exact f64 chain; with a record, x_0 bit for
    bit as without one and the record within 2e-5 of the plain one's."""
    cs = _chip_smoke()
    c = cs._chain_inputs(dims, S, R, L, "paper", cuda, 450 + R)
    args = cs._chain_args(c)
    assert ops.chain_plan(dims, R).row_tiled
    ops.reset_launches()
    out = ops.ddpm_chain(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ddpm_chain"] == ops.GRIDS["ddpm_chain"] == 1
    assert ops.ROW_TILED["ddpm_chain"] == 1
    assert ops.CLUSTERS["ddpm_chain"] == 0
    expect, rec_plain = ref.ddpm_chain_ref(*args, record=True)
    assert out.shape == (R, dims[-1]) and bool(torch.isfinite(out).all())
    assert torch.allclose(out, expect, rtol=2e-5, atol=2e-5)
    exact = cs.chain_exact(*args)
    assert cs._tol_ratio(out, exact, cs.chain_exact_tol(L)) <= 1.0
    x0, rec = ops.ddpm_chain(*args, record=True)
    torch.cuda.synchronize()
    assert torch.equal(x0, out)
    assert rec.shape == (L, R, ops.chain_record_width(dims))
    assert torch.equal(rec[0, :, :dims[-1]], c["x_L"])
    assert torch.allclose(rec, rec_plain, rtol=2e-5, atol=2e-5)


def test_row_tiled_counter_counts_its_launches_only(cuda):
    """``ROW_TILED`` counts one a launch from ``CHAIN_ROW_TILED_FROM`` rows
    on and none below; ``CLUSTERS`` counts the cluster plan's only."""
    cs = _chip_smoke()
    for R in (4096, 64, ops.CHAIN_ROW_TILED_FROM,
              ops.CHAIN_ROW_TILED_FROM - 1):
        tiled = R >= ops.CHAIN_ROW_TILED_FROM
        args = cs._chain_args(cs._chain_inputs(cs.CTRL_DIMS, 50, R, 5,
                                               "paper", cuda, 9))
        ops.reset_launches()
        for _ in range(2):
            ops.ddpm_chain(*args)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["ddpm_chain"] == ops.GRIDS["ddpm_chain"] == 2
        assert ops.ROW_TILED["ddpm_chain"] == (2 if tiled else 0)
        assert ops.CLUSTERS["ddpm_chain"] == (0 if tiled else 2 * -(-R // 8))


def test_row_tiled_launch_refuses_what_its_layout_does_not_take(cuda):
    """The C launch recomputes the row-tiled layout: bytes that disagree,
    a tile other than 32 rows, and widths the layout does not cover are
    refused."""
    cs = _chip_smoke()
    for dims, S, rows, delta in (((86, 128, 128, 128, 20), 50, 32, 4),
                                 ((86, 128, 128, 128, 20), 50, 16, 0),
                                 ((86, 256, 256, 20), 50, 32, 0)):
        c = cs._chain_inputs(dims, S, 256, 5, "paper", cuda, 10)
        plan = ops.ChainPlan(1, rows,
                             ops._chain_rows_smem_bytes(dims, rows) + delta)
        with pytest.raises(RuntimeError, match="launch failed"):
            ops._chain_fwd(list(c["net"].w), list(c["net"].b), c["x_L"],
                           c["state"], c["noises"], c["coef"], c["te"],
                           False, None, plan)


@pytest.mark.parametrize("dims,S,L", [((86, 128, 128, 128, 20), 50, 5),
                                      ((134, 128, 128, 128, 36), 82, 10)])
def test_stacked_row_tiled_chain_matches_single_launches(cuda, dims, S, L):
    """Two stacked learners at R = 4096 in one row-tiled launch: within
    2e-5 of the plain stacked version, and each learner's x_0 and record
    bit for bit its single launch's."""
    nets, net, x_L, state, noises, coef, te, _ = _stacked_case(
        dims, S, 2, 4096, L, cuda, 1100 + L)
    ops.reset_launches()
    x0, rec = ops.ddpm_chain(net, x_L, state, noises, coef, te, record=True)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ddpm_chain"] == ops.ROW_TILED["ddpm_chain"] == 1
    x0p = ref.ddpm_chain_stacked_ref(net, x_L, state, noises, coef, te)
    assert (x0 - x0p).abs().max().item() <= 2e-5 * (1 + x0p.abs().max())
    for b in range(2):
        one, rec1 = ops.ddpm_chain(nets[b], x_L[b], state[b], noises[b],
                                   coef, te, record=True)
        assert torch.equal(x0[b], one) and torch.equal(rec[b], rec1)


def test_ddpm_chain_bwd_rejects_on_the_card(cuda):
    cs = _chip_smoke()
    c = cs._chain_inputs(cs.CTRL_DIMS, 50, 3, 5, "paper", cuda, 5)
    _, rec = ops.ddpm_chain(*cs._chain_args(c), record=True)
    g = torch.ones(3, 20, device=cuda)
    net, st, coef, te = c["net"], c["state"], c["coef"], c["te"]
    with pytest.raises(ValueError, match="do not fit"):
        ops.ddpm_chain_bwd(net, rec[:, :2].contiguous(), st, coef, te, g)
    with pytest.raises(TypeError):
        ops.ddpm_chain_bwd(net, rec, st, coef, te, g.double())
    with pytest.raises(ValueError):
        ops.ddpm_chain_bwd(net, rec, st.cpu(), coef, te, g)


# -- flash_attention and ssd_scan ------------------------------------------------

def _randn(seed, *shape, device, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(device=device, dtype=dtype)


@pytest.mark.parametrize("B,H,Hkv,L,S,D,window,dtype,causal", [
    (2, 4, 2, 128, 128, 64, None, torch.float32, True),
    (1, 8, 8, 256, 256, 128, None, torch.float32, True),
    (1, 4, 1, 256, 256, 64, 64, torch.float32, True),
    (2, 2, 2, 96, 96, 32, None, torch.float32, True),
    (1, 4, 2, 128, 128, 64, None, torch.bfloat16, True),
    (1, 2, 1, 64, 64, 128, 32, torch.bfloat16, True),
    (2, 4, 2, 40, 56, 32, None, torch.float32, False),
    (1, 14, 2, 8, 8, 64, None, torch.bfloat16, True),
    (1, 14, 2, 512, 512, 64, None, torch.bfloat16, True),
    (1, 14, 2, 300, 300, 64, 100, torch.float32, True),
    # the bf16 tensor-core kernel: ragged L, batch, window, head dims,
    # non-causal with S != L, and qwen2's heads at a long prompt
    (1, 14, 2, 77, 77, 64, None, torch.bfloat16, True),
    (1, 14, 2, 300, 300, 64, None, torch.bfloat16, True),
    (1, 14, 2, 511, 511, 64, None, torch.bfloat16, True),
    (2, 14, 2, 256, 256, 64, None, torch.bfloat16, True),
    (1, 14, 2, 300, 300, 64, 100, torch.bfloat16, True),
    (2, 4, 2, 200, 200, 32, None, torch.bfloat16, True),
    (1, 8, 2, 200, 200, 128, None, torch.bfloat16, True),
    (2, 4, 2, 40, 56, 64, None, torch.bfloat16, False),
    (1, 14, 2, 4096, 4096, 64, None, torch.bfloat16, True),
    # d_head 112 (zamba2-7b's shared attention): its heads, GQA, windows,
    # ragged edges, in both kernels
    (1, 32, 32, 300, 300, 112, None, torch.bfloat16, True),
    (2, 8, 2, 200, 200, 112, 64, torch.bfloat16, True),
    (1, 4, 1, 77, 77, 112, None, torch.bfloat16, True),
    (2, 4, 2, 130, 130, 112, None, torch.float32, True),
    (1, 8, 2, 96, 96, 112, 40, torch.float32, True),
    (2, 4, 2, 40, 56, 112, None, torch.float32, False)])
def test_flash_attention_kernel_matches_plain(cuda, B, H, Hkv, L, S, D,
                                              window, dtype, causal):
    q = _randn(1, B, L, H, D, device=cuda, dtype=dtype)
    k = _randn(2, B, S, Hkv, D, device=cuda, dtype=dtype)
    v = _randn(3, B, S, Hkv, D, device=cuda, dtype=dtype)
    before = ops.LAUNCHES["flash_attention"], ops.GRIDS["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    expect = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before[0] + 1
    assert ops.GRIDS["flash_attention"] == before[1] + 1
    assert out.dtype == dtype and out.shape == q.shape
    tol = TOL[dtype]
    assert torch.allclose(out.float(), expect.float(), rtol=tol, atol=tol)
    # the rows past L/2 average many keys, so their outputs are about as
    # small as the bf16 tolerance: hold the error to the outputs' norm too
    for rows in (slice(None), slice(L // 2, None)):
        o, e = out[:, rows].double(), expect[:, rows].double()
        assert (o - e).norm() <= FLASH_REL_TOL[dtype] * e.norm()


def test_flash_attention_constant_v_and_rejections(cuda):
    q = _randn(4, 1, 128, 2, 64, device=cuda)
    k = _randn(5, 1, 128, 2, 64, device=cuda)
    out = ops.flash_attention(q, k, torch.ones_like(k), causal=True)
    assert (out - 1).abs().max().item() <= 1e-5
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(1, 2), k, k)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k.cpu(), k)
    with pytest.raises(ValueError, match="d_head"):
        ops.flash_attention(q[..., :48], k[..., :48], k[..., :48])


# MLA's expanded prefill: q and k over 128 nope + 64 rope dims, v of 128,
# DeepSeek-V3's 128 heads, its YaRN-scaled softmax scale.  The plain
# version rounds nothing past the bf16 inputs; the kernel rounds each
# probability to bf16 before P V, ~2e-3 of an output's norm at these
# lengths, so the same bounds as the square kernels' hold.
MLA_SCALE = 192 ** -0.5 * (0.1 * np.log(40) + 1) ** 2


@pytest.mark.parametrize("L,H,dtype", [
    (16, 128, torch.bfloat16), (77, 128, torch.bfloat16),
    (256, 128, torch.bfloat16), (1000, 128, torch.bfloat16),
    (4096, 128, torch.bfloat16), (130, 4, torch.float32)])
def test_flash_attention_mla_pair_matches_plain(cuda, L, H, dtype):
    q = _randn(1, 1, L, H, 192, device=cuda, dtype=dtype)
    k = _randn(2, 1, L, H, 192, device=cuda, dtype=dtype)
    v = _randn(3, 1, L, H, 128, device=cuda, dtype=dtype)
    before = dict(ops.LAUNCHES), dict(ops.GRIDS)
    out = ops.flash_attention(q, k, v, causal=True, scale=MLA_SCALE)
    expect = ref.flash_attention_ref(q, k, v, causal=True, scale=MLA_SCALE)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == {**before[0],
                            "flash_mla": before[0]["flash_mla"] + 1}
    assert ops.GRIDS["flash_mla"] == before[1]["flash_mla"] + 1
    assert out.dtype == dtype and out.shape == (1, L, H, 128)
    tol = TOL[dtype]
    assert torch.allclose(out.float(), expect.float(), rtol=tol, atol=tol)
    for rows in (slice(None), slice(L // 2, None)):
        o, e = out[:, rows].double(), expect[:, rows].double()
        assert (o - e).norm() <= FLASH_REL_TOL[dtype] * e.norm()


def test_mla_prefill_through_the_kernel_matches_plain(cuda):
    """``mla_forward(impl="kernel")`` at DeepSeek-V3's head widths and
    YaRN (16 heads over d_model 1024, 600 positions) against the plain
    einsums, in bf16: one ``flash_mla`` launch, outputs within 2e-2 of
    their largest magnitude (both round the same bf16 inputs; the kernel
    also rounds probabilities)."""
    from repro_torch.configs.deepseek_v3_671b import V3_YARN
    from repro_torch.nn import mla
    cfg = mla.MLACfg(1024, 16, q_lora_rank=256, kv_lora_rank=512,
                     rope_scaling=V3_YARN)
    p = mla.mla_init(make_generator(0, cuda), cfg)
    x = _randn(7, 1, 600, 1024, device=cuda, dtype=torch.bfloat16)
    out = {}
    for impl in ("kernel", "plain"):
        ops.reset_launches()
        with torch.no_grad():
            out[impl], kv = mla.mla_forward(p, cfg, x, impl=impl,
                                            return_kv=True)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["flash_mla"] == (impl == "kernel")
        assert sum(ops.LAUNCHES.values()) == (impl == "kernel")
    scale = out["plain"].float().abs().max()
    assert (out["kernel"].float() - out["plain"].float()).abs().max() \
        <= 2e-2 * scale


@pytest.mark.parametrize("B,L,H,P,G,N,chunk", [
    (2, 64, 4, 16, 1, 16, 16), (1, 128, 8, 32, 2, 64, 32),
    (2, 40, 4, 8, 2, 16, 16), (1, 256, 2, 64, 1, 128, 128),
    (1, 8, 24, 64, 1, 128, 128), (1, 300, 24, 64, 1, 128, 128),
    (1, 512, 24, 64, 1, 128, 128),
    # 32 chunks; a ragged last chunk of 44 at chunk 64; two groups, batch 2
    (1, 4096, 24, 64, 1, 128, 128), (1, 300, 24, 64, 1, 128, 64),
    (2, 300, 8, 64, 2, 128, 128)])
def test_ssd_scan_kernel_matches_plain(cuda, B, L, H, P, G, N, chunk):
    x = _randn(1, B, L, H, P, device=cuda)
    dt = F.softplus(_randn(2, B, L, H, device=cuda))
    A = -torch.exp(0.5 * _randn(3, H, device=cuda))
    Bm, Cm = _randn(4, B, L, G, N, device=cuda), _randn(5, B, L, G, N,
                                                         device=cuda)
    D = torch.ones(H, device=cuda)
    before = ops.LAUNCHES["ssd_scan"], ops.GRIDS["ssd_scan"]
    y, s = ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=chunk)
    yr, sr = ref.ssd_scan_ref(x, dt, A, Bm, Cm, D, chunk=chunk)
    torch.cuda.synchronize()
    # one launch; one grid for one chunk, else chunk states, recurrence
    # and outputs
    assert ops.LAUNCHES["ssd_scan"] == before[0] + 1
    assert ops.GRIDS["ssd_scan"] == before[1] + (1 if L <= chunk else 3)
    assert torch.allclose(y, yr, rtol=2e-4, atol=2e-4)
    assert torch.allclose(s, sr, rtol=2e-4, atol=2e-4)


def test_ssd_scan_rejects_too_much_shared_memory(cuda):
    # N = 1024: the C and B blocks alone (2 x 32 x 1028 floats) pass 227 KB
    x = torch.zeros(1, 256, 1, 128, device=cuda)
    dt = torch.zeros(1, 256, 1, device=cuda)
    h = torch.zeros(1, device=cuda)
    bc = torch.zeros(1, 256, 1, 1024, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        ops.ssd_scan(x, dt, h, bc, bc, h, chunk=256)


@pytest.mark.parametrize("L,P,N,chunk", [(8, 64, 128, 128),
                                         (4096, 64, 128, 128),
                                         (40, 8, 16, 16),
                                         (256, 128, 1024, 256)])
def test_ssd_plan_shared_memory_matches_the_kernel(cuda, L, P, N, chunk):
    plan = ops.ssd_plan(1, L, 1, P, N, chunk)
    smem = ops._fn("ssd_scan", "ssd_scan_smem_bytes")(plan.chunk, N)
    assert smem == plan.smem_bytes


@pytest.mark.parametrize("name,kernel", [("qwen2-0.5b", "flash_attention"),
                                         ("mamba2-130m", "ssd_scan")])
def test_full_width_prefill_launches_one_kernel_per_layer(cuda, name,
                                                          kernel):
    cfg = get_arch(name).make_full()
    params = lm_init(make_generator(0, cuda), cfg)
    toks = torch.from_numpy(np.arange(128) % cfg.vocab).to(cuda)[None]
    ops.reset_launches()
    with torch.no_grad():
        logits, _ = lm_prefill(params, cfg, toks,
                               lm_init_cache(cfg, 1, 128, device=cuda))
    torch.cuda.synchronize()
    assert ops.LAUNCHES[kernel] == cfg.n_layers == 24
    assert sum(ops.LAUNCHES.values()) == 24
    assert bool(torch.isfinite(logits).all())


def test_zamba_layout_prefill_runs_flash_at_d_head_112(cuda):
    """A Zamba2-layout hybrid whose shared attention has zamba2-7b's d_head
    of 112 (4 heads over d_model 448): one flash_attention launch per
    attention occurrence and one ssd_scan per Mamba2 layer, and the kernel
    prefill against the plain one."""
    from repro_torch.configs.common import zamba_lm
    cfg = zamba_lm("zamba-d112", mamba_per_cycle=2, cycles=2, tail_mamba=1,
                   d_model=448, d_state=16, n_heads=4, n_kv_heads=4,
                   d_ff=512, vocab=256, head_dim=64, n_groups=2, chunk=32)
    params = lm_init(make_generator(0, cuda), cfg)
    toks = torch.from_numpy(np.arange(100) % cfg.vocab).to(cuda)[None]
    out = {}
    for impl in ("kernel", "plain"):
        ops.reset_launches()
        with torch.no_grad():
            out[impl], _ = lm_prefill(params, cfg, toks,
                                      lm_init_cache(cfg, 1, 128, device=cuda),
                                      impl=impl)
        torch.cuda.synchronize()
        if impl == "kernel":
            assert ops.LAUNCHES["flash_attention"] == 2
            assert ops.LAUNCHES["ssd_scan"] == 5
    scale = out["plain"].abs().max()
    assert (out["kernel"] - out["plain"]).abs().max() <= 5e-2 * scale


# -- the learner axis (the fused vector-env learners) -------------------------

def _stacked_case(dims, S, B, R, L, dev, seed):
    from repro_torch.core.networks import mlp_init, stack_mlps
    from repro_torch.diffusion.sampler import chain_tables
    g = torch.Generator().manual_seed(seed)
    nets = [mlp_init(list(dims), g) for _ in range(B)]
    for net in nets:
        with torch.no_grad():
            for b in net.b:
                b.copy_(0.1 * torch.randn(b.shape, generator=g))
    nets = [n.to(dev).requires_grad_(False) for n in nets]
    A, T = dims[-1], dims[0] - dims[-1] - S
    coef, te = chain_tables(make_schedule(L), T, dev)
    x_L = torch.randn(B, R, A, generator=g).to(dev)
    state = torch.randn(B, R, S, generator=g).to(dev)
    noises = torch.randn(B, L, R, A, generator=g).to(dev)
    gup = torch.randn(B, R, A, generator=g).to(dev)
    return (nets, stack_mlps(nets).requires_grad_(False), x_L, state, noises,
            coef, te, gup)


@pytest.mark.parametrize("dims,S,B,R,L", [
    ((86, 128, 128, 128, 20), 50, 8, 64, 5),
    ((86, 128, 128, 128, 20), 50, 8, 1, 5),
    ((86, 128, 128, 128, 20), 50, 4, 64, 5),
    ((86, 128, 128, 128, 20), 50, 4, 1, 5),
    ((53, 90, 90, 90, 30), 7, 3, 9, 7),
    ((86, 128, 128, 128, 20), 50, 1, 64, 5)])
def test_stacked_chain_kernels_match_plain_and_single(cuda, dims, S, B, R,
                                                      L):
    """One stacked ddpm_chain (with its record) and one stacked
    ddpm_chain_bwd for B learners: within 2e-5 of the plain stacked
    versions (the backward within 2e-5 of each leaf's max), and each
    learner's slice bit for bit the single-learner launch on its
    weights."""
    nets, net, x_L, state, noises, coef, te, g = _stacked_case(
        dims, S, B, R, L, cuda, 1000 + B + R)
    ops.reset_launches()
    x0, rec = ops.ddpm_chain(net, x_L, state, noises, coef, te, record=True)
    dws, dbs = ops.ddpm_chain_bwd(net, rec, state, coef, te, g)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ddpm_chain"] == ops.LAUNCHES["ddpm_chain_bwd"] == 1
    x0p, recp = ref.ddpm_chain_stacked_ref(net, x_L, state, noises, coef, te,
                                           record=True)
    assert (x0 - x0p).abs().max().item() <= 2e-5 * (1 + x0p.abs().max())
    pw, pb = ref.ddpm_chain_bwd_stacked_ref(net, rec, state, coef, te, g)
    for a, p in zip(dws + dbs, pw + pb):
        for b in range(B):
            assert (a[b] - p[b]).abs().max().item() <= \
                2e-5 * p[b].abs().max().item()
    for b in range(B):
        one, rec1 = ops.ddpm_chain(nets[b], x_L[b], state[b], noises[b],
                                   coef, te, record=True)
        w1, b1 = ops.ddpm_chain_bwd(nets[b], rec1, state[b], coef, te,
                                    g[b].contiguous())
        assert torch.equal(x0[b], one) and torch.equal(rec[b], rec1)
        assert all(torch.equal(a[b], o) for a, o in zip(dws + dbs, w1 + b1))


def test_stacked_chain_rejects_on_the_card(cuda):
    nets, net, x_L, state, noises, coef, te, g = _stacked_case(
        (86, 128, 128, 128, 20), 50, 2, 4, 5, cuda, 7)
    ws = list(net.w)
    with pytest.raises(ValueError, match="contiguous"):
        ops._chain_fwd([ws[0][:1].expand(2, -1, -1)] + ws[1:], list(net.b),
                       x_L, state, noises, coef, te, False)
    with pytest.raises(ValueError):
        ops.ddpm_chain(net, x_L[0], state[0], noises[0], coef, te)


def test_d3pg_update_stacked_on_card_matches_cpu(cuda):
    """One fused update of 3 learners (per-cell masks, per-learner rates)
    on the card against the same update on the CPU from the same state,
    minibatch and draws: losses to 1e-4, Adam's first moments to 1e-4 of
    each leaf's max; 2 ddpm_chain and 1 ddpm_chain_bwd launches for the
    three learners."""
    from repro_torch.agents.allocators import actor_schedule
    from repro_torch.core.d3pg import d3pg_init_stacked, d3pg_update_stacked
    from repro_torch.core.env import make_user_masks
    cfg = T2DRLCfg(env=EnvCfg(U=4, M=5))
    d3 = cfg.d3pg_cfg()
    B, n, A, U = 3, 64, cfg.env.action_dim, cfg.env.U
    g = torch.Generator().manual_seed(2)
    batch = {"s": torch.randn(B, n, cfg.env.state_dim, generator=g),
             "a": torch.softmax(torch.randn(B, n, A, generator=g), -1),
             "r": torch.randn(B, n, generator=g),
             "s1": torch.randn(B, n, cfg.env.state_dim, generator=g),
             "req": torch.randint(0, 5, (B, n, U), generator=g),
             "rho": torch.randint(0, 2, (B, n, 5), generator=g).float(),
             "req1": torch.randint(0, 5, (B, n, U), generator=g),
             "rho1": torch.randint(0, 2, (B, n, 5), generator=g).float()}
    draws = {k: (torch.randn(B, n, A, generator=g),
                 torch.randn(B, 5, n, A, generator=g))
             for k in ("target", "policy")}
    mask = make_user_masks(cfg.env, [4, 2, 3])
    lr = torch.tensor([1e-4, 2e-4, 0.0])
    out = {}
    for dev in (cuda, torch.device("cpu")):
        gens = [torch.Generator().manual_seed(b) for b in range(B)]
        params = d3pg_init_stacked(d3, gens)
        params = {k: (v.to(dev) if isinstance(v, torch.nn.Module) else
                      {"mu": [m.to(dev) for m in v["mu"]],
                       "nu": [m.to(dev) for m in v["nu"]],
                       "step": v["step"]})
                  for k, v in params.items()}
        ops.reset_launches()
        new, m = d3pg_update_stacked(
            params, d3, actor_schedule(d3),
            {k: v.to(dev) for k, v in batch.items()},
            lr_a=lr.to(dev), lr_c=lr.to(dev), mask=mask.to(dev),
            draws={k: tuple(t.to(dev) for t in v) for k, v in draws.items()})
        if dev.type == "cuda":
            assert (ops.LAUNCHES["ddpm_chain"],
                    ops.LAUNCHES["ddpm_chain_bwd"]) == (2, 1)
        out[dev.type] = (m, new)
    (mc, nc), (mh, nh) = out["cuda"], out["cpu"]
    for k in mc:
        assert ((mc[k].cpu() - mh[k]).abs() <= 1e-4 * mh[k].abs()).all()
    for opt in ("opt_a", "opt_c"):
        for a, b in zip(nc[opt]["mu"], nh[opt]["mu"]):
            assert (a.cpu() - b).abs().max().item() <= \
                1e-4 * b.abs().max().item()


_DRAWS = ("rand", "randn", "randint", "randperm")


@pytest.fixture
def cpu_streams(monkeypatch):
    """Every draw that the port makes from a generator on the card is made
    instead from a CPU generator with the same seed (paired at that
    generator's first draw) and copied to the card, so a run on the card
    consumes, bit for bit, the random streams of the same run on the CPU.
    The port draws only through ``torch.rand``, ``randn``, ``randint``,
    ``randperm`` and ``Tensor.exponential_``, each with ``generator=``."""
    pairs = {}

    def host(g):
        if g is None or g.device.type != "cuda":
            return None
        if id(g) not in pairs:
            pairs[id(g)] = (g, torch.Generator().manual_seed(
                g.initial_seed()))
        return pairs[id(g)][1]

    for name in _DRAWS:
        def draw(*args, _orig=getattr(torch, name), generator=None,
                 device=None, **kw):
            h = host(generator)
            if h is None:
                return _orig(*args, generator=generator, device=device, **kw)
            return _orig(*args, generator=h, **kw).to(
                device if device is not None else generator.device)
        monkeypatch.setattr(torch, name, draw)
    exp = torch.Tensor.exponential_

    def exponential_(self, *args, generator=None, **kw):
        h = host(generator)
        if h is None:
            return exp(self, *args, generator=generator, **kw)
        return self.copy_(exp(torch.empty(self.shape, dtype=self.dtype),
                              *args, generator=h, **kw))
    monkeypatch.setattr(torch.Tensor, "exponential_", exponential_)
    return pairs


def _first_update(monkeypatch):
    """Record the first stacked D3PG update of each device's run: its
    minibatch, and copies of the learners, Adam's first moments and the
    losses it returns, on the CPU, by the device's name."""
    import repro_torch.agents.allocators as alloc_mod
    seen = {}
    fn = alloc_mod.d3pg_update_stacked

    def cpu(ts):
        return [t.detach().cpu().clone() for t in ts]

    def update(state, cfg, sched, batch, *args, **kw):
        out, m = fn(state, cfg, sched, batch, *args, **kw)
        dev = batch["s"].device.type
        if dev not in seen:
            seen[dev] = {
                "batch": {k: v.cpu().clone() for k, v in batch.items()},
                "losses": {k: v.detach().cpu().clone() for k, v in m.items()},
                **{k: cpu(out[k].parameters())
                   for k in ("actor", "critic", "actor_t", "critic_t")},
                **{k: cpu(out[k]["mu"]) for k in ("opt_a", "opt_c")}}
        return out, m
    monkeypatch.setattr(alloc_mod, "d3pg_update_stacked", update)
    return seen


def test_train_t2drl_fused_two_episodes_on_card(cuda, cpu_streams,
                                                monkeypatch):
    """Three fused learners for two episodes on the card: ddpm_chain once a
    slot for all three and 2 + 1 launches a stacked update, whatever B;
    every learner's actor moved; (episodes, B) history; the shared learner
    over masked cells runs too.  The same run on the CPU, from the same
    random streams (``cpu_streams``), agrees on the first stacked update
    to round-off: its minibatch to 1e-5 of each field's max, its losses to 1e-4 relative,
    Adam's first moments to 1e-4 of each leaf's max, and the new learners
    to 2e-5 where |mu| > 1e-3 max|mu| of the leaf (Adam steps a weight
    whose gradient sits at rounding noise by lr * g / (|g| + eps), so
    there the two may step apart by up to lr)."""
    from repro_torch.core.t2drl import (cell_generators, t2drl_init_batch,
                                        train_t2drl)
    cfg = T2DRLCfg(env=EnvCfg(U=4, M=5, T=4, K=5), warmup=10, lr_actor=1e-4,
                   lr_critic=1e-3, lr_ddqn=1e-3)
    first = _first_update(monkeypatch)
    for dev in ("cpu", cuda):
        ops.reset_launches()
        ts, hist = train_t2drl(cfg, episodes=2, num_envs=3, device=dev)
    assert cpu_streams                        # the card drew the CPU's
    n = ts["d3pg"]["opt_a"]["step"]
    assert n == 30
    assert {k: ops.LAUNCHES[k] for k in ("ddpm_chain", "ddpm_chain_bwd",
                                         "ddpm_step")} == \
        {"ddpm_chain": 2 * 4 * 5 + 2 * n, "ddpm_chain_bwd": n,
         "ddpm_step": 0}
    assert np.asarray(hist["mean_reward"]).shape == (2, 3)
    assert np.isfinite(np.asarray(hist["mean_reward"])).all()
    init = t2drl_init_batch(cell_generators(cfg.seed, 3, "cpu"), cfg)
    for p, p0 in zip(ts["d3pg"]["actor"].parameters(),
                     init["d3pg"]["actor"].parameters()):
        assert all(not torch.equal(p[b].cpu(), p0[b]) for b in range(3))
    card, host = first["cuda"], first["cpu"]
    for k, v in host["batch"].items():
        v = v.float()
        assert (card["batch"][k] - v).abs().max().item() <= \
            1e-5 * (1 + v.abs().max().item()), k
    for k, v in host["losses"].items():
        assert ((card["losses"][k] - v).abs() <= 1e-4 * v.abs()).all(), k
    for opt, nets in (("opt_a", ("actor", "actor_t")),
                      ("opt_c", ("critic", "critic_t"))):
        for a, b in zip(card[opt], host[opt]):
            assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()
        for net in nets:
            for a, b, g in zip(card[net], host[net], host[opt]):
                keep = g.abs() > 1e-3 * g.abs().max()
                assert (a - b)[keep].abs().max().item() <= 2e-5, net
    shared = T2DRLCfg(env=cfg.env, warmup=10, policy="shared")
    ts2, h2 = train_t2drl(shared, episodes=1, num_envs=3,
                          user_counts=[4, 3, 2])
    assert np.asarray(h2["hit_ratio"]).shape == (1, 3)
    assert ts2["ebuf"]["data"]["s"].device.type == "cuda"


# -- classical cachers, checkpoints and telemetry on the card ---------------------

@pytest.mark.parametrize("kind", ["lru", "lfu", "lru-ghost", "arc"])
@pytest.mark.parametrize("B", [1, 8])
def test_cache_replay_on_card_matches_cpu(cuda, kind, B):
    """Three frames of a classical cacher's replay (one with a quarter of
    the users masked) on the card against the CPU's, every state leaf
    bit for bit."""
    from repro_torch.agents.cachers import classical_cacher
    from repro_torch.core.cache_policies import cache_state_init
    from repro_torch.core.env import ModelParams, make_models_batch
    ec = EnvCfg()
    agent = classical_cacher(kind, ec)
    lead = (B,) if B > 1 else ()
    g = torch.Generator().manual_seed(B)
    zoo = make_models_batch([g] * B, ec) if B > 1 else make_models(g, ec)
    reqs = [torch.randint(0, ec.M, lead + (ec.K, ec.U), generator=g)
            for _ in range(3)]
    mask = (torch.rand(lead + (ec.U,), generator=g) > 0.25).float()
    masks = (None, mask, None)
    st = cache_state_init(ec.M, lead=lead)
    st_d = {k: v.to(cuda) for k, v in st.items()}
    zoo_d = ModelParams(*(t.to(cuda) for t in zoo))
    for r, m in zip(reqs, masks):
        st = agent.step_frame(st, r, zoo, m)
        st_d = agent.step_frame(st_d, r.to(cuda), zoo_d,
                                None if m is None else m.to(cuda))
        for k in st:
            assert torch.equal(st_d[k].cpu(), st[k]), k


def test_checkpoint_round_trip_on_card(cuda, tmp_path):
    """A trained state saved from the card and loaded back onto it: every
    leaf equal and on the card, and the same greedy episode."""
    from repro_torch.checkpoint import load_train_state, save_train_state
    from repro_torch.core.t2drl import export_policy, train_t2drl
    cfg = T2DRLCfg(env=EnvCfg(T=3, K=4), warmup=8, cacher="arc")
    ts, _ = train_t2drl(cfg, episodes=2, device=cuda)
    path = str(tmp_path / "ts.ckpt")
    save_train_state(path, ts, cfg=cfg)
    got, _ = load_train_state(path, cfg, device=cuda)

    def leaves(t):
        if isinstance(t, torch.nn.Module):
            return [p.detach() for p in t.parameters()]
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in leaves(t[k])]
        if isinstance(t, (list, tuple)):
            return [x for v in t for x in leaves(v)]
        return [t]
    for a, b in zip(leaves(ts), leaves(got), strict=True):
        if torch.is_tensor(a):
            assert b.is_cuda and a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b
    runs = [run_eval(export_policy(s, cfg), s["models"], cfg, episodes=1,
                     seed=4, device=cuda) for s in (ts, got)]
    assert runs[0] == runs[1]


def test_update_telemetry_reads_the_chain_record_on_card(cuda):
    """d3pg_update(diag=True) on the card launches what diag=False does
    (two ddpm_chain, one ddpm_chain_bwd), never the plain chain, and its
    denoise_mag equals the per-step mean |eps_hat| of the plain step
    loop on the same target draws: to 1e-4 relative, since each step's
    eps_hat rides on the kernel's x of that step, which the chain checks
    hold to 2e-5 of the plain chain's."""
    from repro_torch.agents.allocators import actor_schedule
    from repro_torch.core.buffers import buffer_sample
    from repro_torch.core.d3pg import d3pg_update
    from repro_torch.core.t2drl import t2drl_init
    import copy
    cfg = T2DRLCfg(env=EnvCfg(), L=5)
    d3 = cfg.d3pg_cfg()
    ts = t2drl_init(make_generator(0, cuda), cfg)
    g = make_generator(1, cuda)
    batch = {k: torch.randn(64, *v.shape[1:], device=cuda)
             if v.is_floating_point() else
             torch.randint(0, 2, (64,) + v.shape[1:], device=cuda)
             for k, v in ts["ebuf"]["data"].items()}
    for k in ("rho", "rho1"):
        batch[k] = (batch[k] > 0).float()
    A = d3.action_dim
    x_t = torch.randn(64, A, device=cuda)
    n_t = torch.randn(d3.L, 64, A, device=cuda)
    draws = {"target": (x_t, n_t), "policy": (torch.randn_like(x_t),
                                              torch.randn_like(n_t))}
    sched = actor_schedule(d3)
    counts = []
    for diag in (False, True):
        state = copy.deepcopy(ts["d3pg"])
        saved = (ref.ddpm_chain_ref, ref.ddpm_chain_stacked_ref)
        ref.ddpm_chain_ref = ref.ddpm_chain_stacked_ref = None
        try:
            ops.reset_launches()
            _, m = d3pg_update(state, d3, sched, batch, draws=draws,
                               diag=diag)
            torch.cuda.synchronize()
        finally:
            ref.ddpm_chain_ref, ref.ddpm_chain_stacked_ref = saved
        counts.append(dict(ops.LAUNCHES))
    assert counts[0] == counts[1]
    assert counts[1]["ddpm_chain"] == 2 and counts[1]["ddpm_chain_bwd"] == 1
    # the plain step loop's |eps_hat| per step on the same draws
    p = ts["d3pg"]["actor_t"]
    from repro_torch.diffusion.sampler import chain_tables
    coef, te = chain_tables(sched, p.time_dim, cuda)
    x, mags = x_t, []
    with torch.no_grad():
        for i in range(d3.L):
            l_rev = d3.L - 1 - i
            eps = p(x, None, batch["s1"], te=te[l_rev])
            mags.append(eps.abs().mean())
            x = ref.ddpm_step_ref(x, eps, n_t[i], *coef[l_rev].tolist())
    want = torch.stack(mags)
    assert m["denoise_mag"].shape == (d3.L,)
    assert torch.allclose(m["denoise_mag"], want, rtol=1e-4, atol=0)


# -- LM training: chunked attention and a train step on the card ---------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_attention_on_card_matches_cpu(cuda, dtype):
    """``chunked_attention``'s output and q/k/v gradients on the card
    against the same call on the CPU (f32 to 2e-5 of each leaf's max,
    bf16 to 2e-2): GQA 7, causal, two q- and k-blocks."""
    from repro_torch.nn.attention import chunked_attention
    g = torch.Generator().manual_seed(5)
    q, k, v, do = (torch.randn(shape, generator=g) for shape in (
        (2, 256, 14, 64), (2, 256, 2, 64), (2, 256, 2, 64),
        (2, 256, 14, 64)))
    res = {}
    for dev in ("cpu", cuda):
        ts = [t.to(dev, dtype).requires_grad_(True) for t in (q, k, v)]
        out = chunked_attention(*ts, causal=True, window=None, scale=0.125,
                                bq=128, bk=128)
        grads = torch.autograd.grad(out, ts, do.to(dev, dtype))
        res[str(dev)] = [t.detach().float().cpu() for t in (out, *grads)]
    for a, b in zip(res["cpu"], res[str(cuda)]):
        assert (a - b).abs().max().item() <= TOL[dtype] * a.abs().max().item()


def test_lm_train_step_on_card_matches_cpu(cuda):
    """One ``make_train_fns`` step of qwen2-0.5b's smoke config in f32
    compute on the card against the CPU from the same weights and batch:
    the gradients to 1e-4 of each leaf's max, loss and gnorm to 1e-5
    relative, and the updated parameters to 0.1% of lr where the two
    gradients agree in sign and exceed 1e-6 (Adam's first step moves a
    parameter by ~lr·sign(g), so a ~0 gradient's rounding may flip it:
    tests/test_torch_lm_train.py states the bound); no LM kernel."""
    from repro_torch.launch.train import make_batch_fn, make_train_fns
    from repro_torch.models.lm import lm_loss, tree_leaves, tree_map
    from repro_torch.optim import adam_init, constant
    arch = get_arch("qwen2-0.5b")
    cfg = arch.make_smoke()
    p0 = lm_init(torch.Generator().manual_seed(0), cfg)
    out = {}
    for dev in ("cpu", cuda):
        _, step = make_train_fns(arch, cfg, lr_schedule=constant(1e-3),
                                 compute_dtype=torch.float32)
        params = tree_map(lambda t: t.clone().to(dev), p0)
        batch = make_batch_fn(arch, cfg, batch=4, seq_len=64, device=dev)(
            torch.Generator().manual_seed(1))
        leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
        grads = torch.autograd.grad(lm_loss(
            params, cfg, batch, compute_dtype=torch.float32)[0], leaves)
        ops.reset_launches()
        params, opt, m = step(params, adam_init(leaves), batch)
        assert ops.LAUNCHES["flash_attention"] == 0
        out[str(dev)] = (m, [g.cpu() for g in grads],
                         [t.detach().cpu() for t in tree_leaves(params)])
    (mc, gc, pc), (mg, gg, pg) = out["cpu"], out[str(cuda)]
    for key in ("loss", "gnorm"):
        assert abs(mg[key].item() - mc[key].item()) <= 1e-5 * abs(
            mc[key].item())
    for a, b, ga, gb in zip(pc, pg, gc, gg):
        assert (ga - gb).abs().max() <= 1e-4 * ga.abs().max()
        same = (torch.sign(ga) == torch.sign(gb)) & (ga.abs() > 1e-6)
        assert torch.where(same, a - b, 0.0).abs().max() <= 1e-6
