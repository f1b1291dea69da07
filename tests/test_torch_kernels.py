"""ddpm_step: the port's wrapper on CPU tensors (its plain version) against
the JAX package's Pallas kernel (interpret mode on the CPU) and its oracle.

Same numpy inputs on both sides; tolerances of tests/test_kernels.py
(2e-5 for f32, 2e-2 for bf16).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

_J2T = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == jnp.bfloat16 \
        else dict(rtol=2e-5, atol=2e-5)


# DDPM_CASES of tests/test_kernels.py, plus the serving path's shapes
DDPM_CASES = [
    ((4, 20), jnp.float32, 0), ((4, 20), jnp.float32, 3),
    ((2, 3, 40), jnp.float32, 1), ((8, 256), jnp.bfloat16, 2),
    ((1, 7), jnp.float32, 0), ((20,), jnp.float32, 4),
    ((256,), jnp.float32, 999),
]


def _inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    jx = [jnp.asarray(a).astype(dtype) for a in arrs]
    # the torch side gets the same (dtype-rounded) values
    tx = [torch.tensor(np.asarray(a.astype(jnp.float32))).to(_J2T[dtype])
          for a in jx]
    return jx, tx


@pytest.mark.parametrize("shape,dtype,l_rev", DDPM_CASES)
def test_ddpm_step_matches_jax_kernel_and_oracle(shape, dtype, l_rev):
    (jx, je, jn), (tx, te, tn) = _inputs(shape, dtype, seed=sum(shape))
    alpha, abar, btilde = 0.9, 0.5, 0.04
    out = ops.ddpm_step(tx, te, tn, alpha, abar, btilde, l_rev)
    assert out.dtype == tx.dtype and out.shape == tx.shape
    got = out.float().numpy()
    pallas = jops.ddpm_step(jx, je, jn, jnp.float32(alpha), jnp.float32(abar),
                            jnp.float32(btilde), jnp.int32(l_rev))
    oracle = jref.ddpm_step_ref(jx, je, jn, alpha, abar, btilde, l_rev)
    for expect in (pallas, oracle):
        np.testing.assert_allclose(got, np.asarray(expect, np.float32),
                                   **_tol(dtype))


def test_ddpm_step_last_step_is_deterministic():
    _, (x, e, n1) = _inputs((4, 16), jnp.float32, seed=1)
    n2 = torch.randn(4, 16, generator=torch.Generator().manual_seed(3))
    o1 = ops.ddpm_step(x, e, n1, 0.9, 0.5, 0.04, 0)
    o2 = ops.ddpm_step(x, e, n2, 0.9, 0.5, 0.04, 0)
    assert torch.equal(o1, o2)


def test_ddpm_coefficients_match_the_update():
    c1, c2, sigma = ops.ddpm_coefficients(0.9, 0.5, 0.04, 2)
    assert c1 == pytest.approx(1 / np.sqrt(0.9))
    assert c2 == pytest.approx(0.1 / (np.sqrt(0.5) * np.sqrt(0.9)))
    assert sigma == pytest.approx(0.2)
    assert ops.ddpm_coefficients(0.9, 0.5, 0.04, 0)[2] == 0.0


def test_cpu_path_runs_the_plain_version_and_does_not_count():
    _, (x, e, n) = _inputs((3, 5), jnp.float32, seed=2)
    before = ops.LAUNCHES["ddpm_step"]
    out = ops.ddpm_step(x, e, n, 0.9, 0.5, 0.04, 1)
    c = ops.ddpm_coefficients(0.9, 0.5, 0.04, 1)
    assert torch.equal(out, ref.ddpm_step_ref(x, e, n, *c))
    assert ops.LAUNCHES["ddpm_step"] == before


@pytest.mark.parametrize("bad", ["shape", "dtype", "float16", "grad"])
def test_ddpm_step_rejects_bad_inputs(bad):
    x = torch.zeros(2, 4)
    e, n = torch.zeros(2, 4), torch.zeros(2, 4)
    if bad == "shape":
        e = torch.zeros(4, 2)
        err = ValueError
    elif bad == "dtype":
        e = e.to(torch.bfloat16)
        err = TypeError
    elif bad == "float16":
        x, e, n = (t.half() for t in (x, e, n))
        err = TypeError
    else:
        x.requires_grad_(True)
        err = NotImplementedError
    with pytest.raises(err):
        ops.ddpm_step(x, e, n, 0.9, 0.5, 0.04, 1)
