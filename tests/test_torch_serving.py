"""Edge gateway parity: the port's gateway (CPU) mirrors the JAX gateway's
byte budget, eviction and cloud path, and a served image chain equals the
JAX ``reverse_sample`` on the same weights and injected draws (2e-5)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.diffusion import make_schedule as jmake_schedule
from repro.diffusion import reverse_sample as jreverse_sample
from repro.serving.gateway import toy_diffusion_builder as jtoy_builder
from repro_torch.bridge import denoiser_from_numpy
from repro_torch.kernels import ops
from repro_torch.serving import (CatalogEntry, EdgeGateway,
                                 toy_diffusion_builder)


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
    before = ops.LAUNCHES["ddpm_step"]
    gw = _gw(_catalogue(), 20.0)
    gw.apply_caching(np.ones(3))
    gw.serve_slot([0, 1, 2], np.array([0.2, 0.3, 0.5]))
    assert ops.LAUNCHES["ddpm_step"] == before
    lm = CatalogEntry(model_id=0, name="lm", kind="lm", size_gb=1.0,
                      builder=lambda: None)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _gw([lm], 2.0).apply_caching(np.ones(1))
