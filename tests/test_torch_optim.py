"""The port's optimizer, schedules, replay buffers and the ``ddpm_step``
backward's plain version (CPU), against ``repro.optim`` and
``repro.core.buffers`` on the same numpy inputs.

Tolerances: Adam's parameters, moments and ``gnorm`` agree to 2e-5
(rtol = atol) with f32 moments and to 2e-2 with bf16 moments (the two
frameworks round bf16 at other places); the buffers and the constant
schedule agree exactly, the cosine schedules to two ulps (XLA's cos and
torch's differ by one ulp at some inputs); the backward is checked by
``torch.autograd.gradcheck`` in f64 (its default tolerances) and bit for
bit against its plain version in f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import buffers as jbuf
from repro.optim import adam as jadam
from repro.optim import schedules as jsched
from repro_torch.core import buffers as tbuf
from repro_torch.kernels import ops, ref
from repro_torch.optim import adam as tadam
from repro_torch.optim import schedules as tsched


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tests run many small ops, which several
    threads only slow down when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHAPES = [(5, 4), (4,), (4, 3), (3,)]


def _tree(rng, scale=1.0):
    """A numpy parameter tree of two layers, as repro's mlp_init lays it
    out (jax.tree.leaves order: b, w per layer)."""
    return [{"w": scale * rng.standard_normal(SHAPES[2 * i]).astype(np.float32),
             "b": scale * rng.standard_normal(SHAPES[2 * i + 1]).astype(
                 np.float32)} for i in range(2)]


def _leaves_t(tree):
    return [torch.from_numpy(np.array(a)) for a in jax.tree.leaves(tree)]


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("max_norm", [0.0, 1.0])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adam_matches_jax_over_five_steps(weight_decay, max_norm, moments):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[moments]
    tol = dict(rtol=2e-2, atol=2e-2) if moments == "bfloat16" else \
        dict(rtol=2e-5, atol=2e-5)
    jp = jax.tree.map(jnp.asarray, params)
    js = jadam.adam_init(jp, moment_dtype=jdt)
    tp = _leaves_t(params)
    ts = tadam.adam_init(tp, moment_dtype=tdt)
    kw = dict(lr=1e-2, weight_decay=weight_decay, max_norm=max_norm)
    for _ in range(5):
        grads = _tree(rng, scale=3.0)     # global norm ~10: clipping bites
        jp, js, jm = jadam.adam_update(jax.tree.map(jnp.asarray, grads), js,
                                       jp, **kw)
        tp, ts, tm = tadam.adam_update(_leaves_t(grads), ts, tp, **kw)
        np.testing.assert_allclose(tm["gnorm"].item(), float(jm["gnorm"]),
                                   rtol=2e-5)
    assert ts["step"] == int(js["step"]) == 5
    for name, jt, tt in (("params", jp, tp), ("mu", js["mu"], ts["mu"]),
                         ("nu", js["nu"], ts["nu"])):
        for j, t in zip(jax.tree.leaves(jt), tt):
            assert t.dtype == (torch.float32 if name == "params" else tdt)
            np.testing.assert_allclose(t.float().numpy(),
                                       np.asarray(j, np.float32), **tol,
                                       err_msg=name)


def test_adam_updates_in_place_and_takes_modules():
    from repro_torch.core.networks import mlp_init
    net = mlp_init([3, 4, 2], torch.Generator().manual_seed(0))
    state = tadam.adam_init(net)
    w0 = net.w[0]
    before = w0.detach().clone()
    grads = [torch.ones_like(p) for p in net.parameters()]
    out, state, _ = tadam.adam_update(grads, state, net, lr=0.1)
    assert out is net and net.w[0] is w0 and state["step"] == 1
    # step 1 moves each weight by lr * g / (|g| + eps) = ~lr
    torch.testing.assert_close(w0.detach(), before - 0.1, rtol=0, atol=1e-6)


def test_global_norm_and_clip_match_jax():
    rng = np.random.default_rng(1)
    g = _tree(rng, scale=2.0)
    jn = jadam.global_norm(jax.tree.map(jnp.asarray, g))
    np.testing.assert_allclose(tadam.global_norm(_leaves_t(g)).item(),
                               float(jn), rtol=2e-5)
    jc, jcn = jadam.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
    tc, tcn = tadam.clip_by_global_norm(_leaves_t(g), 1.0)
    np.testing.assert_allclose(tcn.item(), float(jcn), rtol=2e-5)
    for j, t in zip(jax.tree.leaves(jc), tc):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2e-5,
                                   atol=2e-7)


@pytest.mark.parametrize("lr,max_norm,weight_decay", [
    ("scalar", 0.0, 0.0), ("per_learner", 0.0, 0.0),
    ("per_learner", 1.0, 0.01)])
def test_stacked_adam_matches_jax(lr, max_norm, weight_decay):
    """Three steps of B = 3 stacked learners against
    ``repro.optim.adam_update_stacked``, with one lr or one per learner
    (the population lever), to 2e-5; the per-learner global norms too."""
    B = 3
    rng = np.random.default_rng(2)

    def stacked(scale=1.0):
        return [{k: scale * rng.standard_normal((B,) + v.shape).astype(
            np.float32) for k, v in layer.items()} for layer in _tree(rng)]

    params = stacked()
    lrs = 1e-2 if lr == "scalar" else np.array([1e-2, 3e-3, 0.0],
                                               np.float32)
    jp = jax.tree.map(jnp.asarray, params)
    js = jadam.adam_init_stacked(jp)
    tp = _leaves_t(params)
    ts = tadam.adam_init_stacked(tp)
    kw = dict(max_norm=max_norm, weight_decay=weight_decay)
    t_lr = lrs if lr == "scalar" else torch.from_numpy(lrs)
    for _ in range(3):
        grads = stacked(3.0)
        jp, js, jm = jadam.adam_update_stacked(
            jax.tree.map(jnp.asarray, grads), js, jp, lr=jnp.asarray(lrs),
            **kw)
        tp, ts, tm = tadam.adam_update_stacked(_leaves_t(grads), ts, tp,
                                               lr=t_lr, **kw)
        np.testing.assert_allclose(tm["gnorm"].numpy(),
                                   np.asarray(jm["gnorm"]), rtol=2e-5)
    assert ts["step"] == 3 and list(np.asarray(js["step"])) == [3] * B
    for name, jt, tt in (("params", jp, tp), ("mu", js["mu"], ts["mu"]),
                         ("nu", js["nu"], ts["nu"])):
        for j, t in zip(jax.tree.leaves(jt), tt):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2e-5,
                                       atol=2e-5, err_msg=name)
    if lr != "scalar":          # lr 0 leaves learner 2 where it started
        for t, p0 in zip(tp, _leaves_t(params)):
            assert torch.equal(t[2], p0[2])


@pytest.mark.parametrize("name,args", [
    ("constant", (3e-4,)), ("cosine_decay", (1e-3, 50)),
    ("cosine_decay", (1e-3, 50, 0.0)),
    ("linear_warmup_cosine", (1e-3, 10, 60)),
    ("linear_warmup_cosine", (2e-4, 0, 7, 0.2))])
def test_schedules_match_jax_exactly(name, args):
    """Same f32 arithmetic in the same order.  XLA's cos and torch's differ
    by one ulp at some inputs, so a value that goes through a cos is held
    to two ulps of the result or of lr * cos (rtol 2.4e-7, atol 2.4e-7
    lr; the latter where 1 + cos cancels); every other value is equal."""
    jf, tf = getattr(jsched, name)(*args), getattr(tsched, name)(*args)
    for step in range(0, 80, 3):
        j = np.float32(jf(jnp.int32(step)))
        t = tf(torch.tensor(step, dtype=torch.int32))
        assert t.dtype == torch.float32
        if name == "constant":
            assert t.item() == float(j)
        else:
            np.testing.assert_allclose(t.item(), float(j), rtol=2.4e-7,
                                       atol=2.4e-7 * args[0],
                                       err_msg=f"{name} {step}")


# -- replay buffers -------------------------------------------------------------

def _item(rng, n=None):
    lead = () if n is None else (n,)
    return {"s": rng.standard_normal(lead + (3,)).astype(np.float32),
            "a": rng.integers(0, 9, lead).astype(np.int32),
            "r": rng.standard_normal(lead).astype(np.float32)}


def _buf_pair(cap):
    ex = {"s": np.zeros(3, np.float32), "a": np.int32(0),
          "r": np.float32(0)}
    tex = {"s": torch.zeros(3), "a": torch.zeros((), dtype=torch.int64),
           "r": torch.zeros(())}
    return jbuf.buffer_init(cap, jax.tree.map(jnp.asarray, ex)), \
        tbuf.buffer_init(cap, tex)


def _t(item):
    return {k: torch.from_numpy(np.asarray(v, np.int64 if k == "a"
                                           else np.float32))
            for k, v in item.items()}


def _same_buffer(jb, tb):
    assert tb["ptr"] == int(jb["ptr"]) and tb["size"] == int(jb["size"])
    for k, v in tb["data"].items():
        np.testing.assert_array_equal(v.numpy(),
                                      np.asarray(jb["data"][k]).astype(
                                          v.numpy().dtype))


def test_buffer_add_and_add_many_wrap_like_jax():
    rng = np.random.default_rng(2)
    jb, tb = _buf_pair(7)
    for _ in range(3):
        it = _item(rng)
        jb = jbuf.buffer_add(jb, jax.tree.map(jnp.asarray, it))
        tb = tbuf.buffer_add(tb, _t(it))
        _same_buffer(jb, tb)
    for n in (4, 5, 7, 2):                  # 3+4 fills, 5 wraps, 7 = cap
        items = _item(rng, n)
        jb = jbuf.buffer_add_many(jb, jax.tree.map(jnp.asarray, items))
        tb = tbuf.buffer_add_many(tb, _t(items))
        _same_buffer(jb, tb)
    with pytest.raises(ValueError, match="capacity"):
        tbuf.buffer_add_many(tb, _t(_item(rng, 8)))
    with pytest.raises(ValueError, match="capacity"):
        jbuf.buffer_add_many(jb, jax.tree.map(jnp.asarray, _item(rng, 8)))


def test_buffer_sample_and_occupancy_match_jax():
    rng = np.random.default_rng(3)
    jb, tb = _buf_pair(10)
    items = _item(rng, 6)
    jb = jbuf.buffer_add_many(jb, jax.tree.map(jnp.asarray, items))
    tb = tbuf.buffer_add_many(tb, _t(items))
    key = jax.random.PRNGKey(4)
    jbatch = jbuf.buffer_sample(jb, key, 16)
    # the JAX draw's indices, injected into the port
    idx = np.array(jax.random.randint(key, (16,), 0, 6))
    tbatch = tbuf.buffer_sample(tb, idx=torch.from_numpy(idx).long())
    for k in jbatch:
        np.testing.assert_array_equal(
            tbatch[k].numpy(), np.asarray(jbatch[k]).astype(
                tbatch[k].numpy().dtype))
    # drawn from a generator: with replacement, stored rows only
    drawn = tbuf.buffer_sample(tb, torch.Generator().manual_seed(0), 200)
    stored = {tuple(r) for r in items["s"].tolist()}
    assert {tuple(r) for r in drawn["s"].tolist()} <= stored
    assert drawn["s"].shape == (200, 3)
    jo = jbuf.buffer_occupancy(jb, "ebuf")
    to = tbuf.buffer_occupancy(tb, "ebuf")
    assert set(to) == set(jo) == {"ebuf_size", "ebuf_fill"}
    for k in jo:
        assert to[k] == pytest.approx(float(jo[k]), rel=1e-7)


# -- the ddpm_step backward -------------------------------------------------------

@pytest.mark.parametrize("l_rev", [0, 3])
def test_ddpm_step_backward_passes_gradcheck_in_f64(l_rev):
    g = torch.Generator().manual_seed(l_rev)
    x, e, n = (torch.randn(4, 6, generator=g, dtype=torch.float64)
               for _ in range(3))
    c1, c2, sigma = ops.ddpm_coefficients(0.9, 0.5, 0.04, l_rev)
    x.requires_grad_(True)
    e.requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda x, e: ops.DdpmStep.apply(x, e, n, c1, c2, sigma), (x, e))


def test_ddpm_step_gradient_is_its_backward_in_f32():
    """Through the wrapper on CPU tensors: the autograd Function's
    backward is ddpm_step_bwd's plain version, bit for bit, and nothing
    counts as a launch."""
    g = torch.Generator().manual_seed(5)
    x, e, n, up = (torch.randn(3, 20, generator=g) for _ in range(4))
    x.requires_grad_(True)
    e.requires_grad_(True)
    before = dict(ops.LAUNCHES)
    out = ops.ddpm_step(x, e, n, 0.9, 0.5, 0.04, 2)
    dx, de = torch.autograd.grad(out, (x, e), up)
    c1, c2, _ = ops.ddpm_coefficients(0.9, 0.5, 0.04, 2)
    want = ref.ddpm_step_bwd_ref(up, c1, c2)
    assert torch.equal(dx, want[0]) and torch.equal(de, want[1])
    assert torch.equal(dx, c1 * up) and torch.equal(de, -c2 * up)
    assert ops.LAUNCHES == before
    bx, be = ops.ddpm_step_bwd(up.bfloat16(), c1, c2)
    assert bx.dtype == be.dtype == torch.bfloat16
    with pytest.raises(TypeError):
        ops.ddpm_step_bwd(up.half(), c1, c2)
