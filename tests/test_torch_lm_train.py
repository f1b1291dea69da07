"""The port's LM training losses and step against the JAX package, on the
CPU at smoke widths.

* ``softmax_xent`` with ``ignore`` entries (a row wholly ignored) to 2e-5.
* ``lm_loss`` (qwen2-0.5b through ``plain`` and ``chunked``, mamba2-130m,
  deepseek-v3-671b with MLA, MoE aux and MTP, internvl2-2b with its patch
  prefix) and whisper-small's ``whisper_loss``, and their gradients,
  against ``jax.value_and_grad`` of the reference.  In f32 compute: the
  losses to 1e-5 relative, every gradient leaf to 1e-4 of its largest
  magnitude.  In bf16 compute the two frameworks round activations and
  gradients at other places (XLA keeps f32 inside its fusions, PyTorch
  rounds every op), so single leaves drift 1-3% in relative L2 (the
  worst, 2.87e-2, is qwen2's k bias, the leaf of smallest gradient): the
  loss is held to 2e-2 relative and every leaf to 4e-2 in relative L2.
  The MoE layers' routes are recorded on both sides (each ``top_k``
  call's indices): every token picks the reference's experts, so
  deepseek-v3's trunk is held like the rest.
* The other five architectures take one port-only step: a finite loss,
  and a finite gradient with a nonzero entry on every leaf.
* ``remat=True`` gives the losses and gradients of ``remat=False`` bit for
  bit, with fewer tensors kept for the backward.
* One ``make_train_fns`` step against the reference's step composed from
  its parts, and checkpoints both ways (JAX writes, the port resumes one
  step equal to JAX's; the port writes what JAX's ``load_pytree`` reads).

One JAX compile per architecture and dtype (``_jax_value_and_grad``),
shared by every test of the file that needs it.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import bf16_safe_cast
from repro.checkpoint import load_pytree as jload_pytree
from repro.checkpoint import save_pytree as jsave_pytree
from repro.configs import get_arch as jget_arch
from repro.models import lm as jlm
from repro.models import whisper as jwhisper
from repro.optim import adam_init as jadam_init
from repro.optim import adam_update as jadam_update
from repro.optim import constant as jconstant
from repro.optim import linear_warmup_cosine as jwarmup
from repro_torch.bridge import (lm_train_state_from_numpy,
                                lm_train_state_to_numpy)
from repro_torch.checkpoint import load_pytree, save_pytree
from repro_torch.configs import get_arch
from repro_torch.launch.train import make_train_fns
from repro_torch.models import lm, whisper
from repro_torch.optim import adam_init, constant, linear_warmup_cosine

B, L = 2, 32
F32_GRAD = 1e-4       # of each leaf's largest magnitude
BF16 = 2e-2           # the losses, relative
BF16_LEAF = 4e-2      # each leaf's ||dg|| / ||g||; the worst reading 2.87e-2
PARITY = [("qwen2-0.5b", "plain"), ("qwen2-0.5b", "chunked"),
          ("mamba2-130m", "plain"), ("deepseek-v3-671b", "plain"),
          ("internvl2-2b", "plain"), ("whisper-small", "plain")]
PORT_ONLY = ["olmo-1b", "codeqwen1.5-7b", "zamba2-7b", "deepseek-v2-236b",
             "qwen3-4b"]
JIMPL = {"plain": "xla", "chunked": "chunked"}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _is_whisper(name):
    return get_arch(name).kind == "whisper"


@functools.lru_cache(maxsize=None)
def _setup(name):
    """(JAX cfg, port cfg, JAX params, numpy batch) at smoke width."""
    jcfg, tcfg = jget_arch(name).make_smoke(), get_arch(name).make_smoke()
    init = jwhisper.whisper_init if _is_whisper(name) else jlm.lm_init
    jp = jax.jit(lambda k: init(k, jcfg))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    labels = rng.integers(0, jcfg.vocab, (B, L)).astype(np.int32)
    labels[0, :5] = -100
    batch = {"labels": labels}
    n_text = L - getattr(jcfg, "n_prefix", 0) if getattr(
        jcfg, "prefix_embed_dim", 0) else L
    batch["tokens"] = rng.integers(0, jcfg.vocab, (B, n_text)).astype(
        np.int32)
    if n_text < L:
        batch["prefix_embeds"] = 0.02 * rng.standard_normal(
            (B, jcfg.n_prefix, jcfg.prefix_embed_dim)).astype(np.float32)
    if _is_whisper(name):
        batch["frame_embeds"] = 0.02 * rng.standard_normal(
            (B, jcfg.n_frames, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, batch


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(name, impl, dt):
    """(the jitted value_and_grad, ((loss, metrics), grads) of the
    reference, the experts its MoE layers picked): one compile.  The
    routes are every ``top_k`` call's indices in call order, each row
    sorted, recorded by a callback traced into the first call."""
    jcfg, _, jp, batch = _setup(name)
    if _is_whisper(name):
        def loss(p, b):
            return jwhisper.whisper_loss(p, jcfg, b, compute_dtype=JDT[dt])
    else:
        def loss(p, b):
            return jlm.lm_loss(p, jcfg, b, impl=JIMPL[impl],
                               compute_dtype=JDT[dt])
    vg = jax.jit(jax.value_and_grad(loss, has_aux=True))
    routes, top_k = [], jax.lax.top_k

    def recording_top_k(x, k):
        vals, ids = top_k(x, k)
        jax.debug.callback(lambda i: routes.append(np.sort(i, -1)), ids,
                           ordered=True)
        return vals, ids
    jax.lax.top_k = recording_top_k
    try:
        out = jax.device_get(vg(jp, jax.tree.map(jnp.asarray, batch)))
        jax.effects_barrier()
    finally:
        jax.lax.top_k = top_k
    return vg, out, list(routes)


def _port_tree(name, jp):
    tcfg = _setup(name)[1]
    state = lm_train_state_from_numpy(
        {"params": jax.tree.map(np.asarray, jp),
         "opt": {"mu": jax.tree.map(np.zeros_like, jp),
                 "nu": jax.tree.map(np.zeros_like, jp), "step": 0}},
        tcfg, device="cpu")
    return state["params"]


def _tbatch(batch):
    return {k: torch.tensor(v).long() if v.dtype.kind == "i"
            else torch.tensor(v) for k, v in batch.items()}


def _port_loss(name, impl, dt, params=None, cfg=None):
    _, tcfg, jp, batch = _setup(name)
    cfg = cfg or tcfg
    tp = params if params is not None else _port_tree(name, jp)
    leaves = lm.tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    if _is_whisper(name):
        loss, m = whisper.whisper_loss(tp, cfg, _tbatch(batch),
                                       compute_dtype=TDT[dt])
    else:
        loss, m = lm.lm_loss(tp, cfg, _tbatch(batch), impl=impl,
                             compute_dtype=TDT[dt])
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return ({k: float(v.detach()) for k, v in m.items()},
            [g.float().numpy() for g in grads])


def _jleaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def _assert_metrics(tm, jm, rtol):
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k], float(jm[k]), rtol=rtol,
                                   atol=rtol * 1e-2, err_msg=k)


def test_softmax_xent_matches_jax_with_ignored_entries():
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((3, 5, 11))).astype(np.float32)
    labels = rng.integers(0, 11, (3, 5)).astype(np.int32)
    labels[0, 1:4] = -100
    labels[2] = -100                              # a row wholly ignored
    got = lm.softmax_xent(torch.tensor(logits), torch.tensor(labels).long())
    want = jlm.softmax_xent(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=2e-5)
    none = np.full((2, 3), -100, np.int32)
    assert float(lm.softmax_xent(torch.tensor(logits[:2, :3]),
                                 torch.tensor(none).long())) == 0.0


@pytest.mark.parametrize("name,impl", PARITY)
def test_losses_and_gradients_match_jax_in_f32(name, impl):
    _, ((_, jm), jg), _ = _jax_value_and_grad(name, impl, "f32")
    tm, tg = _port_loss(name, impl, "f32")
    _assert_metrics(tm, jm, 1e-5)
    jl = _jleaves(jg)
    assert len(jl) == len(tg)
    for i, (a, b) in enumerate(zip(jl, tg)):
        assert a.shape == b.shape
        err = np.abs(a - b).max()
        assert err <= F32_GRAD * max(np.abs(a).max(), 1e-30), (i, err)


@pytest.mark.parametrize("name,impl", PARITY)
def test_losses_and_gradients_match_jax_in_bf16(name, impl, monkeypatch):
    """The loss to 2e-2 relative and every gradient leaf by its own
    ||g_port - g_ref|| / ||g_ref|| to BF16_LEAF; each MoE layer's tokens
    pick the reference's experts (deepseek-v3's two layers: the trunk's
    and the MTP module's), so its whole trunk is held too."""
    _, ((_, jm), jg), jroutes = _jax_value_and_grad(name, impl, "bf16")
    routes, topk = [], torch.topk

    def recording_topk(x, k, dim=-1, **kw):
        vals, ids = topk(x, k, dim=dim, **kw)
        routes.append(np.sort(ids.numpy(), -1))
        return vals, ids
    monkeypatch.setattr(torch, "topk", recording_topk)
    tm, tg = _port_loss(name, impl, "bf16")
    monkeypatch.undo()
    assert len(routes) == len(jroutes)
    for want, got in zip(jroutes, routes):
        assert np.array_equal(want, got), (want != got).any(-1).sum()
    _assert_metrics(tm, jm, BF16)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(jg)]
    for path, a, b in zip(paths, _jleaves(jg), tg):
        err = np.linalg.norm(a - b)
        assert err <= BF16_LEAF * np.linalg.norm(a), (path, err)


@pytest.mark.parametrize("name", PORT_ONLY)
def test_the_other_architectures_take_a_finite_step(name):
    cfg = get_arch(name).make_smoke()
    p = lm.lm_init(torch.Generator().manual_seed(1), cfg)
    rng = np.random.default_rng(2)
    batch = {k: torch.tensor(rng.integers(0, cfg.vocab, (B, L)))
             for k in ("tokens", "labels")}
    leaves = lm.tree_leaves(p)
    for t in leaves:
        t.requires_grad_(True)
    loss, m = lm.lm_loss(p, cfg, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    loss = float(loss.detach())
    assert np.isfinite(loss) and loss == float(m["loss"].detach())
    for i, g in enumerate(grads):
        assert bool(torch.isfinite(g).all()) and bool((g != 0).any()), i


def _saved_count(fn):
    n = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: n.append(1) or t, lambda t: t):
        out = fn()
    return out, len(n)


@pytest.mark.parametrize("name", ["qwen2-0.5b", "deepseek-v3-671b",
                                  "whisper-small"])
def test_remat_gives_the_same_loss_and_gradients(name):
    _, tcfg, jp, _ = _setup(name)
    res = {}
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        res[remat] = _saved_count(lambda: _port_loss(
            name, "plain", "f32", cfg=cfg))
    (m0, g0), n0 = res[False]
    (m1, g1), n1 = res[True]
    assert m0 == m1
    for a, b in zip(g0, g1):
        np.testing.assert_array_equal(a, b)
    assert n1 < n0


def _jax_step(name, params, opt, lr_schedule):
    """The reference's train step composed from its parts:
    ``value_and_grad`` of the loss (the cached compile), the lr at the
    optimizer's step, ``adam_update(max_norm=1.0)``."""
    _, _, _, batch = _setup(name)
    vg, _, _ = _jax_value_and_grad(name, "plain", "f32")
    (_, m), g = vg(params, jax.tree.map(jnp.asarray, batch))
    lr = lr_schedule(opt["step"])
    params, opt, om = _jadam(g, opt, params, lr)
    return params, opt, {**m, **om, "lr": lr}, g


@jax.jit
def _jadam(g, opt, params, lr):
    return jadam_update(g, opt, params, lr=lr, max_norm=1.0)


def _port_step(name, state, lr_schedule):
    _, tcfg, _, batch = _setup(name)
    arch = get_arch(name)
    _, step = make_train_fns(arch, tcfg, lr_schedule=lr_schedule,
                             compute_dtype=torch.float32)
    leaves = lm.tree_leaves(state["params"])
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = lm.lm_loss(state["params"], tcfg, _tbatch(batch),
                         compute_dtype=torch.float32)
    grads = [g.numpy() for g in torch.autograd.grad(loss, leaves)]
    params, opt, m = step(state["params"], state["opt"], _tbatch(batch))
    return params, opt, m, grads


def _hold_step(jout, tout, p_before):
    """Loss, xent, gnorm to 1e-5 relative, lr exactly; the updated
    parameters to 0.1% of the step's lr wherever the two gradients agree
    in sign and the reference's is 0 or above 100x Adam's eps (1e-6),
    which is more than 99% of the entries.  Adam moves a parameter by
    lr·m/(sqrt(v) + 1e-8), about lr·sign(g) on its first steps whatever
    |g|: where a gradient is ~0 the frameworks' rounding may give it
    opposite signs, and the updates differ by ~2·lr; where |g| is within
    a few eps, an f32 rounding of g (~1e-9) moves the update by up to a
    few % of lr.  Above 1e-6 that sensitivity is below 1e-5·lr, and wrong
    moments, bias corrections or clipping would move every parameter by
    a sizable part of lr."""
    jp, jopt, jm, jg = jout
    tp, topt, tm, tg = tout
    for k in ("loss", "xent", "gnorm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    assert tm["lr"] == float(jm["lr"])
    assert topt["step"] == int(jopt["step"])
    atol = 1e-3 * tm["lr"]
    agree = total = 0
    for a, b, ga, gb, p0 in zip(_jleaves(jp), lm.tree_leaves(tp),
                                _jleaves(jg), tg, p_before):
        b = b.detach().numpy()
        same = (np.sign(ga) == np.sign(gb)) & ((np.abs(ga) > 1e-6)
                                               | (ga == 0))
        np.testing.assert_allclose(b[same], a[same], rtol=0, atol=atol)
        assert not np.array_equal(b, p0)
        agree, total = agree + same.sum(), total + same.size
    assert agree / total > 0.99


def test_make_train_fns_step_matches_the_reference_step():
    name = "qwen2-0.5b"
    _, tcfg, jp, _ = _setup(name)
    jopt = jadam_init(jp)
    tstate = {"params": _port_tree(name, jp)}
    tstate["opt"] = adam_init(lm.tree_leaves(tstate["params"]))
    before = [t.detach().numpy().copy()
              for t in lm.tree_leaves(tstate["params"])]
    jout = _jax_step(name, jp, jopt, jconstant(1e-3))
    tout = _port_step(name, tstate, constant(1e-3))
    _hold_step(jout, tout, before)


def test_checkpoints_cross_both_ways_and_resume(tmp_path):
    """JAX takes a step (lr 0 at step 0, its moments move) and writes
    {params, opt}; the port reads it, resumes one step, equal to JAX's
    second step; the port's file after that step reads in JAX's
    ``load_pytree`` as the port's state, leaf for leaf."""
    name = "qwen2-0.5b"
    _, tcfg, jp, _ = _setup(name)
    jsched = jwarmup(1e-3, warmup=2, steps=10)
    tsched = linear_warmup_cosine(1e-3, warmup=2, steps=10)
    jp1, jopt1, _, _ = _jax_step(name, jp, jadam_init(jp), jsched)
    path = str(tmp_path / "jax.ckpt")
    jsave_pytree(path, bf16_safe_cast({"params": jp1, "opt": jopt1}))
    state = lm_train_state_from_numpy(load_pytree(path), tcfg, device="cpu")
    assert state["opt"]["step"] == 1
    before = [t.detach().numpy().copy()
              for t in lm.tree_leaves(state["params"])]
    jout = _jax_step(name, jp1, jopt1, jsched)
    tout = _port_step(name, state, tsched)
    _hold_step(jout, tout, before)

    out = str(tmp_path / "port.ckpt")
    tp, topt = tout[0], tout[1]
    save_pytree(out, lm_train_state_to_numpy({"params": tp, "opt": topt}))
    back = jload_pytree(out)
    assert int(back["opt"]["step"]) == 2
    want = lm_train_state_to_numpy({"params": tp, "opt": topt})
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), b)
