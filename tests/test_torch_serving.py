"""Edge gateway parity: the port's gateway (CPU) mirrors the JAX gateway's
byte budget, eviction and cloud path; a served image chain equals the JAX
``reverse_sample`` on the same weights and injected draws (2e-5); an LM
request gives what the JAX gateway's LM branch gives on the same
weights (bf16 engine, equal tokens)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.diffusion import make_schedule as jmake_schedule
from repro.diffusion import reverse_sample as jreverse_sample
from repro.configs import get_arch as jget_arch
from repro.models import lm as jlm
from repro.serving import EdgeGateway as JEdgeGateway
from repro.serving import Engine as JEngine
from repro.serving import ServeCfg as JServeCfg
from repro.serving.gateway import toy_diffusion_builder as jtoy_builder
from repro_torch.bridge import denoiser_from_numpy, lm_params_from_numpy
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.models.lm import tree_map as lm_tree_map
from repro_torch.serving import (CatalogEntry, EdgeGateway, Engine,
                                 ServeCfg, toy_diffusion_builder)


def _catalogue(n=3, counter=None, image_dim=32):
    def counted(seed):
        inner = toy_diffusion_builder(seed, image_dim)

        def build():
            if counter is not None:
                counter[seed] = counter.get(seed, 0) + 1
            return inner()
        return build
    return [CatalogEntry(model_id=i, name=f"m{i}", kind="diffusion",
                         size_gb=4.0 + i, builder=counted(i))
            for i in range(n)]


def _gw(cat, capacity, **kw):
    return EdgeGateway(cat, capacity_gb=capacity, image_dim=32,
                       total_steps=50, device="cpu", **kw)


def test_gateway_load_respects_byte_budget():
    gw = _gw(_catalogue(), 10.0)
    info = gw.apply_caching(np.array([1.0, 1.0, 1.0]))
    # id-order greedy: 4.0 + 5.0 fit, 6.0 would overflow -> skipped
    assert sorted(gw.loaded) == [0, 1]
    assert info["used_gb"] == pytest.approx(9.0)
    assert info["n_loaded"] == 2.0


def test_gateway_evict_then_reload_rebuilds_params():
    counter = {}
    gw = _gw(_catalogue(counter=counter), 6.0)
    gw.apply_caching(np.array([1.0, 0.0, 0.0]))
    assert counter == {0: 1}
    gw.apply_caching(np.array([0.0, 1.0, 0.0]))      # evict 0, load 1
    assert sorted(gw.loaded) == [1] and gw.used_gb() == pytest.approx(5.0)
    gw.apply_caching(np.array([1.0, 0.0, 0.0]))      # reload 0 from scratch
    assert counter == {0: 2, 1: 1}
    assert 0 in gw.loaded and 1 not in gw.loaded


def test_gateway_uncached_serves_modeled_cloud_path():
    cat = _catalogue()
    gw = _gw(cat, 4.0)
    gw.apply_caching(np.array([1.0, 0.0, 0.0]))
    res = gw.serve_slot([0, 2], np.array([0.5, 0.5]),
                        torch.Generator().manual_seed(0))
    assert res[0].cached and res[0].measured_wall_s > 0.0
    assert res[0].steps == 25 and res[0].output_shape == (32,)
    assert not res[1].cached and res[1].measured_wall_s == 0.0
    e = cat[2]
    assert res[1].modeled_quality == e.a4
    assert res[1].modeled_delay == pytest.approx(e.b1 * e.a3 + e.b2)


def test_served_chain_matches_jax_reverse_sample():
    """Same weights (``toy_diffusion_builder``'s, bridged) and the draws
    the JAX sampler makes from its key: the gateway's chain equals the
    JAX gateway's ``reverse_sample`` to 2e-5."""
    dim, steps, seed = 32, 30, 4
    jparams = jtoy_builder(seed, dim)()
    entry = CatalogEntry(
        model_id=0, name="m0", kind="diffusion", size_gb=1.0,
        builder=lambda: denoiser_from_numpy(jax.tree.map(np.asarray, jparams),
                                            device="cpu"))
    gw = EdgeGateway([entry], capacity_gb=2.0, image_dim=dim,
                     total_steps=100, device="cpu")
    gw.apply_caching(np.array([1.0]))
    key = jax.random.PRNGKey(8)
    j = jreverse_sample(jparams, jmake_schedule(steps, kind="linear"),
                        jnp.zeros((1,)), key, dim)
    kx, ke = jax.random.split(key)
    x_L = torch.tensor(np.asarray(jax.random.normal(kx, (dim,))))
    noises = torch.tensor(np.asarray(jax.random.normal(ke, (steps, dim))))
    t = gw.diffusion_sample(0, steps, x_L=x_L, noises=noises)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2e-5,
                               atol=2e-5)


def test_gateway_cpu_run_launches_no_kernel_and_lm_raises():
    """A CPU run launches no kernel; an LM entry whose builder does not
    give an Engine (or gives one on another device) is refused."""
    before = dict(ops.LAUNCHES)
    gw = _gw(_catalogue(), 20.0)
    gw.apply_caching(np.ones(3))
    gw.serve_slot([0, 1, 2], np.array([0.2, 0.3, 0.5]))
    assert ops.LAUNCHES == before
    lm = CatalogEntry(model_id=0, name="lm", kind="lm", size_gb=1.0,
                      builder=lambda: None)
    with pytest.raises(TypeError, match="Engine"):
        _gw([lm], 2.0).apply_caching(np.ones(1))
    meta = CatalogEntry(model_id=0, name="lm", kind="lm", size_gb=1.0,
                        builder=lambda: _port_engine("meta"))
    with pytest.raises(ValueError, match="its engine is on meta"):
        _gw([meta], 2.0).apply_caching(np.ones(1))


# -- the LM branch ---------------------------------------------------------------

# with seed 8 the JAX engine's smallest greedy top-2 margin on these
# requests is 0.071, above the ~0.025 by which the two frameworks' bf16
# logits differ (tests/test_torch_lm.py), so rounding cannot flip a token
LM_SEED = 8


def _jax_lm():
    cfg = jget_arch("qwen2-0.5b").make_smoke()
    return cfg, jlm.lm_init(jax.random.PRNGKey(LM_SEED), cfg)


def _port_engine(device="cpu"):
    jcfg, jp = _jax_lm()
    cfg = get_arch("qwen2-0.5b").make_smoke()
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                  device="cpu")
    if device == "meta":
        params = lm_tree_map(lambda t: t.to("meta"), params)
    return Engine(cfg, params, ServeCfg(max_batch=2, max_seq=64),
                  device=device)


def _lm_catalogue(engine_builder, diffusion_builder=None):
    """Entry 1: the LM; entry 0: a diffusion model when a builder is
    given."""
    cat = [CatalogEntry(model_id=1, name="qwen2-0.5b-smoke", kind="lm",
                        size_gb=3.0, builder=engine_builder, a1=50.0,
                        a2=120.0, a3=160.0, a4=30.0, b1=0.2, b2=5.0)]
    if diffusion_builder is not None:
        cat.insert(0, CatalogEntry(model_id=0, name="m0", kind="diffusion",
                                   size_gb=4.0, builder=diffusion_builder))
    return cat


def test_lm_branch_matches_the_jax_gateway():
    """Same weights, same xi: the same steps, token count and modeled
    quality/delay as the JAX gateway, and the same tokens."""
    jcfg, jp = _jax_lm()
    jgw = JEdgeGateway(_lm_catalogue(
        lambda: JEngine(jcfg, jp, JServeCfg(max_batch=2, max_seq=64)),
        jtoy_builder(0, 32)), capacity_gb=8.0, image_dim=32, total_steps=160)
    gw = EdgeGateway(_lm_catalogue(_port_engine, toy_diffusion_builder(0, 32)),
                     capacity_gb=8.0, image_dim=32, total_steps=160,
                     device="cpu")
    for g in (jgw, gw):
        g.apply_caching(np.array([1.0, 1.0]))
    assert sorted(gw.loaded) == sorted(jgw.loaded) == [0, 1]
    xi = np.array([0.3, 0.7])
    res = gw.serve_slot([0, 1], xi, torch.Generator().manual_seed(0))
    jres = jgw.serve_slot([0, 1], xi, jax.random.PRNGKey(0))
    for r, j in zip(res, jres):
        assert (r.cached, r.steps, r.output_shape) == \
            (j.cached, j.steps, j.output_shape)
        assert r.modeled_quality == pytest.approx(j.modeled_quality, 1e-6)
        assert r.modeled_delay == pytest.approx(j.modeled_delay, 1e-6)
        assert r.measured_wall_s > 0
    assert res[1].output_shape == (max(1, 112 // 16) + 1,)
    prompt = np.arange(8) % jcfg.vocab
    done, _ = gw.loaded[1].run([(0, prompt, 3)])
    jdone, _ = jgw.loaded[1].run([(0, prompt, 3)])
    assert done == jdone


def test_lm_branch_prompt_and_eviction():
    built = []

    def builder():
        built.append(1)
        return _port_engine()
    gw = EdgeGateway(_lm_catalogue(builder),
                     capacity_gb=4.0, image_dim=32, total_steps=32,
                     device="cpu")
    gw.apply_caching(np.array([0.0, 1.0]))
    r = gw.serve_request(1, 0.5, prompt=np.arange(20))
    assert r.cached and r.steps == 16 and r.output_shape == (2,)
    gw.apply_caching(np.array([0.0, 0.0]))
    assert not gw.loaded and gw.serve_request(1, 0.5).measured_wall_s == 0
    gw.apply_caching(np.array([0.0, 1.0]))
    assert len(built) == 2
