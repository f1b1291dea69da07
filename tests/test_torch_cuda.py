"""Card-only tests of the port: each hand-written kernel against its plain
version on the card, and the serving paths' launch counts.

Run on a machine with an NVIDIA GPU (it has no JAX, so skip the suite's
conftest, which imports it):

    PYTHONPATH=src python -m pytest -m cuda --noconftest tests/test_torch_cuda.py

Card presence is decided inside the ``cuda`` fixture, never at import, so
every worker collects the same tests; without a card they skip.
"""
import pytest
import torch

from repro_torch.core.env import EnvCfg, make_models
from repro_torch.core.t2drl import T2DRLCfg, policy_init, run_eval
from repro_torch.device import make_generator
from repro_torch.diffusion import (denoiser_init, make_schedule,
                                   reverse_sample_actions)
from repro_torch.kernels import build, ops, ref
from repro_torch.serving import CatalogEntry, EdgeGateway, \
    toy_diffusion_builder

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


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


def test_sampler_on_card_matches_cpu(cuda):
    p = denoiser_init(50, 20, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    s, x_L = torch.randn(64, 50, generator=g), torch.randn(64, 20, generator=g)
    noises = torch.randn(5, 64, 20, generator=g)
    sched = make_schedule(5)
    before = ops.LAUNCHES["ddpm_step"]
    on_card = reverse_sample_actions(p.to(cuda), sched, s.to(cuda), 20,
                                     x_L=x_L.to(cuda), noises=noises.to(cuda))
    assert ops.LAUNCHES["ddpm_step"] == before + 5
    on_cpu = reverse_sample_actions(p.cpu(), sched, s, 20, x_L=x_L,
                                    noises=noises)
    assert (on_card.cpu() - on_cpu).abs().max().item() <= 2e-5


def test_greedy_episode_launches_l_t_k(cuda):
    cfg = T2DRLCfg(env=EnvCfg(U=4, M=4, T=3, K=2))
    pol = policy_init(cfg, seed=0, device=cuda)
    models = make_models(make_generator(1, cuda), cfg.env)
    ops.reset_launches()
    hist = run_eval(pol, models, cfg, episodes=2, device=cuda)
    assert ops.LAUNCHES["ddpm_step"] == 2 * cfg.L * 3 * 2
    assert all(len(v) == 2 for v in hist.values())


def test_gateway_launches_one_per_image_step(cuda):
    cat = [CatalogEntry(model_id=i, name=f"m{i}", kind="diffusion",
                        size_gb=4.0, builder=toy_diffusion_builder(i, 64))
           for i in range(2)]
    gw = EdgeGateway(cat, capacity_gb=8.0, image_dim=64, total_steps=100,
                     device=cuda)
    gw.apply_caching([1.0, 1.0])
    ops.reset_launches()
    res = gw.serve_slot([0, 1, 0], [0.25, 0.5, 0.25],
                        make_generator(0, cuda))
    assert [r.steps for r in res] == [25, 50, 25]
    assert ops.LAUNCHES["ddpm_step"] == 100
    assert all(r.measured_wall_s > 0 for r in res)
