"""ddpm_step: the port's wrapper on CPU tensors (its plain version) against
the JAX package's Pallas kernel (interpret mode on the CPU) and its oracle;
ddpm_chain's wrapper, plan and plain version (its JAX parity is in
tests/test_torch_diffusion.py); flash_attention and ssd_scan likewise.

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


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread, as every other port test file runs.  On a
    thread pool, torch's CPU ``exp`` splits a tensor of more than 2048
    f32 elements into chunks of 2048 across the pool's threads (the
    vectorised math library's ``vmsExp`` on each chunk).  Under CPU
    contention, as the suite's parallel workers make, the first such call
    in a fresh process now and then returns one chunk up to ~1.5e-4
    relative off, and every later call is right.  The plain SSD takes
    ``exp`` of its (B, chunks, Q, Q, H) decay matrix, 8192 elements in its
    first case, so that case failed its 2e-4 now and then.  torch.exp of
    8192 elements alone, one fresh process each, 24 at a time on 8 cores
    (``tests/_exp_thread_probe.py``): 10 of 1500 went wrong at 8 threads,
    none of 1500 at one thread (no chunk leaves the calling thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
        # x and eps_hat are differentiable now; the noise, a drawn
        # constant, gets no gradient, so a noise that asks for one is refused
        n.requires_grad_(True)
        err = ValueError
    with pytest.raises(err):
        ops.ddpm_step(x, e, n, 0.9, 0.5, 0.04, 1)


# -- ddpm_chain -----------------------------------------------------------------

def _chain_args(dims=(32, 16, 16, 8), S=4, R=3, L=6, seed=0):
    """A small MLP (T = dims[0] - A - S) and a chain's inputs, from numpy."""
    from repro_torch.core.networks import MLP
    rng = np.random.default_rng(seed)

    def f32(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    net = MLP([f32(i, o) / np.sqrt(i) for i, o in zip(dims[:-1], dims[1:])],
              [0.1 * f32(o) for o in dims[1:]]).requires_grad_(False)
    A, T = dims[-1], dims[0] - dims[-1] - S
    coef = torch.tensor([ops.ddpm_coefficients(0.9, 0.5, 0.04, l)
                         for l in range(L)], dtype=torch.float32)
    return [net, f32(R, A), f32(R, S), f32(L, R, A), coef, f32(L, T)]


def test_ddpm_chain_is_the_step_loop_on_the_cpu():
    """On CPU tensors the wrapper runs the plain version, which is the
    step loop: denoiser MLP then ddpm_step's update; no launch counted."""
    net, x, s, n, coef, te = _chain_args()
    before = dict(ops.LAUNCHES), dict(ops.GRIDS), dict(ops.CLUSTERS)
    out = ops.ddpm_chain(net, x, s, n, coef, te)
    assert (ops.LAUNCHES, ops.GRIDS, ops.CLUSTERS) == before
    L = coef.shape[0]
    for i in range(L):
        l_rev = L - 1 - i
        eps = net(torch.cat([x, s, te[l_rev].expand(3, -1)], dim=-1))
        x = ops.ddpm_step(x, eps, n[i], 0.9, 0.5, 0.04, l_rev)
    assert torch.equal(out, x)


@pytest.mark.parametrize("bad", ["bf16", "shape", "noises", "widths",
                                 "non_contiguous", "grad", "meta"])
def test_ddpm_chain_rejects_what_the_kernel_does_not_take(bad):
    args = _chain_args()
    err = ValueError
    if bad == "bf16":
        args[1], err = args[1].to(torch.bfloat16), TypeError
    elif bad == "shape":
        args[2] = args[2][:2]
    elif bad == "noises":
        args[3] = args[3][:, :, :4]
    elif bad == "widths":
        args[5] = torch.zeros(6, 15)          # dims[0] != A + S + T
    elif bad == "non_contiguous":
        args[3] = args[3].transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "grad":
        # x_L gets no gradient (only the MLP's weights and biases do)
        args[1].requires_grad_(True)
    else:
        args[1:] = [t.to("meta") for t in args[1:]]
    with pytest.raises(err):
        ops.ddpm_chain(*args)


# (widths, R) -> (cluster, rows, shared-memory bytes).  Floats per CTA:
# two mbarriers (4 floats); each layer's weight slice (in rows of a stride
# >= its ceil(out / C) columns and = 4 mod 32) and bias slice; the rows'
# state share of layer 0; two input buffers of max(widths); the own x
# slice; two noise slices; 2 x 256 time-embedding slots.
CHAIN_PLANS = [
    # control plane over 8 CTAs of 16 columns (3 of the last layer's 20):
    # 4 + 86*36+16 + 2*(128*36+16) + 128*4+3, + 16 + 2*128 + 3*3 + 512
    # = 13672 floats
    (((86, 128, 128, 128, 20), 1), (8, 1, 54688)),
    # data plane: 4 + 273*36+16 + 2*(128*36+16) + 128*36+32, + 16 + 2*273
    # + 3*32 + 512 = 24906 floats
    (((273, 128, 128, 128, 256), 1), (8, 1, 99624)),
    # 16 rows: two clusters of 8 rows; 12879 + 8*16 + 16*128 + 24*3 + 512
    (((86, 128, 128, 128, 20), 16), (8, 8, 62556)),
    # 8 columns a CTA: 64 wide over 8 CTAs, 32 over 4, 16 over 2
    (((40, 64, 64, 8), 3), (8, 3, None)),
    (((24, 32, 32, 8), 2), (4, 2, None)),
    (((20, 16, 4), 1), (2, 1, None)),
    # narrower still: the smallest cluster
    (((12, 8, 4), 1), (2, 1, None)),
    # 512 wide: 8 CTAs, and only 8 hold the weights
    (((528, 512, 16), 1), (8, 1, None)),
    # the row-tiled plan (cluster 1) over R = 4096 rows, 32 rows a CTA.
    # Table 2's decide widths: 21*128 (x's rows of w0, and b0) +
    # 2*129*128 + 129*20, + 2*128*36 (two activation buffers of 32 + 4) +
    # 2*128 (two steps' time share) = 47764 floats
    (((86, 128, 128, 128, 20), 4096), (1, 32, 191056)),
    # U = 18, L = 10: 37*128 + 2*129*128 + 129*36 + 2*128*36 + 2*128
    # = 51876 floats
    (((134, 128, 128, 128, 36), 4096), (1, 32, 207504)),
    # the threshold (the measured crossover, ops.CHAIN_ROW_TILED_FROM)
    # takes it too; one row less keeps the clusters
    (((86, 128, 128, 128, 20), 125), (1, 32, 191056)),
    (((86, 128, 128, 128, 20), 124), (8, 8, 62556)),
    # widths 8 does not divide, padded to 4: 31*92 + 2*91*92 + 91*32, +
    # 2*90*36 + 2*92 = 29172 floats
    (((53, 90, 90, 90, 30), 4095), (1, 32, 116688)),
    # widths the row-tiled layout does not cover keep the cluster plan at
    # R = 4096: A = 256 (the data plane's image chain), a 256-wide hidden
    # layer
    (((273, 128, 128, 128, 256), 4096), (8, 8, None)),
    (((86, 256, 256, 20), 4096), (8, 8, None)),
]


@pytest.mark.parametrize("shape,plan", CHAIN_PLANS)
def test_chain_plan_picks_cluster_rows_and_bytes(shape, plan):
    got = ops.chain_plan(*shape)
    assert (got.cluster, got.rows) == plan[:2]
    if plan[2] is not None:
        assert got.smem_bytes == plan[2]
    assert got.smem_bytes <= ops.SMEM_LIMIT


def test_chain_plan_raises_past_8_ctas_and_for_other_dtypes():
    with pytest.raises(ValueError, match="8 CTAs"):
        ops.chain_plan((2048, 2048, 2048), 1)
    with pytest.raises(TypeError, match="float32"):
        ops.chain_plan((86, 128, 20), 1, torch.bfloat16)
    with pytest.raises(ValueError):
        ops.chain_plan((86, 128, 20), 0)


# -- flash_attention ------------------------------------------------------------

# FLASH_CASES of tests/test_kernels.py: (B, H, Hkv, L, S, D, window, dtype)
FLASH_CASES = [
    (2, 4, 2, 128, 128, 64, None, jnp.float32),
    (1, 8, 8, 256, 256, 128, None, jnp.float32),
    (1, 4, 1, 256, 256, 64, 64, jnp.float32),
    (2, 2, 2, 96, 96, 32, None, jnp.float32),      # unaligned L
    (1, 4, 2, 128, 128, 64, None, jnp.bfloat16),
    (1, 2, 1, 64, 64, 128, 32, jnp.bfloat16),
]


def _same(seed, dtype, *shapes):
    """The same (dtype-rounded) normal arrays for JAX and for torch."""
    rng = np.random.default_rng(seed)
    jx = [jnp.asarray(rng.standard_normal(s).astype(np.float32)).astype(dtype)
          for s in shapes]
    return jx, [torch.tensor(np.asarray(a.astype(jnp.float32))).to(
        _J2T[dtype]) for a in jx]


@pytest.mark.parametrize("B,H,Hkv,L,S,D,window,dtype", FLASH_CASES)
def test_flash_attention_matches_jax_kernel_and_oracle(B, H, Hkv, L, S, D,
                                                       window, dtype):
    (jq, jk, jv), (q, k, v) = _same(L + D, dtype, (B, L, H, D),
                                    (B, S, Hkv, D), (B, S, Hkv, D))
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    assert ops.LAUNCHES["flash_attention"] == before   # CPU: plain version
    assert out.dtype == q.dtype and out.shape == q.shape
    pallas = jops.flash_attention(jq, jk, jv, causal=True, window=window,
                                  bq=64, bk=64)
    oracle = jref.flash_attention_ref(jq, jk, jv, causal=True, window=window)
    for expect in (pallas, oracle):
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(expect, np.float32),
                                   **_tol(dtype))


def test_flash_attention_rows_sum_to_one_property():
    _, (q, k) = _same(5, jnp.float32, (1, 128, 2, 64), (1, 128, 2, 64))
    out = ops.flash_attention(q, k, torch.ones_like(k), causal=True)
    np.testing.assert_allclose(out.numpy(), 1.0, rtol=1e-5, atol=1e-5)


def test_flash_attention_non_causal_matches_jax_oracle():
    (jq, jk, jv), (q, k, v) = _same(6, jnp.float32, (2, 40, 4, 32),
                                    (2, 56, 2, 32), (2, 56, 2, 32))
    out = ops.flash_attention(q, k, v, causal=False, window=None)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jref.flash_attention_ref(
            jq, jk, jv, causal=False)), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("bad", ["d_head", "dtype", "groups", "window",
                                 "shape", "grad", "device"])
def test_flash_attention_rejects_what_the_kernel_does_not_take(bad):
    q, k, v = torch.zeros(1, 8, 4, 32), torch.zeros(1, 8, 2, 32), \
        torch.zeros(1, 8, 2, 32)
    kw, err = {}, ValueError
    if bad == "d_head":
        q, k, v = (t[..., :16] for t in (q, k, v))
    elif bad == "dtype":
        k, err = k.to(torch.bfloat16), TypeError
    elif bad == "groups":
        q = torch.zeros(1, 8, 3, 32)
    elif bad == "window":
        kw = {"window": 0}
    elif bad == "shape":
        v = torch.zeros(1, 7, 2, 32)
    elif bad == "grad":
        q.requires_grad_(True)
        err = NotImplementedError
    else:
        q, k, v = (t.to("meta") for t in (q, k, v))
    with pytest.raises(err):
        ops.flash_attention(q, k, v, **kw)


@pytest.mark.parametrize("dtype,kernel,code", [
    (torch.bfloat16, "mma_bf16", 1), (torch.float32, "simt_f32", 0)])
def test_flash_plan_dispatches_by_dtype(dtype, kernel, code):
    """bf16 goes to the tensor-core kernel, f32 to the CUDA-core one."""
    assert ops.flash_plan(dtype) == (kernel, code)


def test_flash_plan_rejects_other_dtypes():
    with pytest.raises(TypeError):
        ops.flash_plan(torch.float16)


# -- ssd_scan -------------------------------------------------------------------

# SSD_CASES of tests/test_kernels.py: (B, L, H, P, G, N, chunk)
SSD_CASES = [
    (2, 64, 4, 16, 1, 16, 16),
    (1, 128, 8, 32, 2, 64, 32),
    (2, 40, 4, 8, 2, 16, 16),      # L not divisible by the chunk
    (1, 256, 2, 64, 1, 128, 128),
]


def _ssd_inputs(seed, B, L, H, P, G, N):
    """x, dt, A, B, C, D drawn as tests/test_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P))
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H))))
    A = -np.exp(0.5 * rng.standard_normal(H))
    Bm = rng.standard_normal((B, L, G, N))
    Cm = rng.standard_normal((B, L, G, N))
    arrs = [a.astype(np.float32) for a in (x, dt, A, Bm, Cm, np.ones(H))]
    return [jnp.asarray(a) for a in arrs], [torch.tensor(a) for a in arrs]


@pytest.mark.parametrize("B,L,H,P,G,N,chunk", SSD_CASES)
def test_ssd_scan_matches_jax_kernel_and_oracle(B, L, H, P, G, N, chunk):
    jargs, targs = _ssd_inputs(L + H, B, L, H, P, G, N)
    before = ops.LAUNCHES["ssd_scan"]
    y, s = ops.ssd_scan(*targs, chunk=chunk)
    assert ops.LAUNCHES["ssd_scan"] == before
    assert y.dtype == s.dtype == torch.float32
    assert tuple(y.shape) == (B, L, H, P) and tuple(s.shape) == (B, H, P, N)
    for jy, js in (jops.ssd_scan(*jargs, chunk=chunk),
                   jref.ssd_scan_ref(*jargs, chunk=chunk)):
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=2e-4,
                                   atol=2e-4)


def test_ssd_matches_stepwise_recurrence():
    """The chunked SSD (any chunking) equals the sequential SSM."""
    B, L, H, P, G, N = 1, 24, 2, 4, 1, 8
    _, (x, dt, A, Bm, Cm, _) = _ssd_inputs(9, B, L, H, P, G, N)
    y, _ = ops.ssd_scan(x, dt, A, Bm, Cm, torch.zeros(H), chunk=8)
    x, dt, A, Bm, Cm = (t.numpy().astype(np.float64)
                        for t in (x, dt, A, Bm, Cm))
    S = np.zeros((B, H, P, N))
    Bf, Cf = np.repeat(Bm, H // G, 2), np.repeat(Cm, H // G, 2)
    for t in range(L):
        dA = np.exp(dt[:, t] * A[None])
        S = S * dA[:, :, None, None] + np.einsum(
            "bh,bhn,bhp->bhpn", dt[:, t], Bf[:, t], x[:, t])
        np.testing.assert_allclose(y.numpy()[:, t],
                                   np.einsum("bhn,bhpn->bhp", Cf[:, t], S),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("bad", ["groups", "dt", "int", "grad", "empty",
                                 "device"])
def test_ssd_scan_rejects_what_the_kernel_does_not_take(bad):
    _, args = _ssd_inputs(3, 1, 8, 4, 8, 2, 8)
    err = ValueError
    if bad == "groups":
        args[3] = args[4] = torch.zeros(1, 8, 3, 8)
    elif bad == "dt":
        args[1] = torch.zeros(1, 8, 3)
    elif bad == "int":
        args[0], err = args[0].long(), TypeError
    elif bad == "grad":
        args[0].requires_grad_(True)
        err = NotImplementedError
    elif bad == "empty":
        args = [a[:, :0] if a.dim() > 1 else a for a in args]
    else:
        args = [a.to("meta") for a in args]
    with pytest.raises(err):
        ops.ssd_scan(*args, chunk=4)


def test_reset_launches_zeroes_launches_and_grids():
    ops.LAUNCHES["ssd_scan"] += 2
    ops.GRIDS["ssd_scan"] += 6
    ops.reset_launches()
    assert set(ops.LAUNCHES.values()) == set(ops.GRIDS.values()) == {0}
    # a grid count exists for each kernel whose C entry point reports one
    assert set(ops.GRIDS) <= set(ops.LAUNCHES)


@pytest.mark.parametrize("name", ["ddpm_step", "flash_attention",
                                  "ssd_scan"])
def test_a_cpu_call_starts_no_grids(name):
    """On the CPU the plain version runs: no launch and no grid counted."""
    torch.manual_seed(0)
    before = dict(ops.LAUNCHES), dict(ops.GRIDS)
    if name == "ddpm_step":
        x = torch.randn(20)
        ops.ddpm_step(x, x, x, 0.9, 0.5, 0.04, 1)
    elif name == "flash_attention":
        q, k = torch.randn(1, 16, 2, 32), torch.randn(1, 16, 1, 32)
        ops.flash_attention(q, k, k)
    else:
        x, dt = torch.randn(1, 16, 2, 4), torch.rand(1, 16, 2)
        h, bc = -torch.ones(2), torch.randn(1, 16, 1, 8)
        ops.ssd_scan(x, dt, h, bc, bc, h, chunk=8)
    assert (ops.LAUNCHES, ops.GRIDS) == before


# (B, L, H, P, N, chunk) -> chunks
SSD_PLANS = [
    ((1, 8, 24, 64, 128, 128), 1),      # mamba2, one chunk
    ((1, 128, 24, 64, 128, 128), 1),
    ((1, 512, 24, 64, 128, 128), 4),
    ((1, 4096, 24, 64, 128, 128), 32),
    ((1, 300, 24, 64, 128, 64), 5),     # ragged last chunk
    ((2, 40, 4, 8, 16, 16), 3),
]


@pytest.mark.parametrize("shape,n_chunks", SSD_PLANS)
def test_ssd_plan_splits_the_chunks_across_ctas(shape, n_chunks):
    B, L, H, P, N, chunk = shape
    plan = ops.ssd_plan(*shape)
    assert plan.n_chunks == n_chunks
    assert plan.chunk == min(chunk, L)
    assert plan.one_chunk == (L <= chunk)
    # no scratch for one chunk; chunk states and decays for more
    if plan.one_chunk:
        assert plan.scratch == ()
    else:
        assert plan.scratch == ((B, n_chunks, H, P, N), (B, n_chunks, H))
    assert plan.smem_bytes <= ops.SMEM_LIMIT


def test_ssd_plan_shared_memory_at_the_path_shape_and_above_the_limit():
    """The shared memory grows with the chunk and the state N, not with
    B, L past the chunk, H or P; N = 1024 passes the card's 227 KB."""
    path = ops.ssd_plan(1, 512, 24, 64, 128, 128).smem_bytes
    assert path == ops.ssd_plan(2, 4096, 8, 128, 128, 128).smem_bytes
    assert path < ops.ssd_plan(1, 512, 24, 64, 256, 128).smem_bytes
    assert path < ops.ssd_plan(1, 512, 24, 64, 128, 256).smem_bytes
    assert ops.ssd_plan(1, 256, 1, 128, 1024, 256).smem_bytes \
        > ops.SMEM_LIMIT
