"""DeepSeek-V3 as published in the port (``configs/deepseek_v3_671b.py:
make_ep32``'s layout at a tiny width), against the plain PyTorch
reference the benchmark's check runs (``perfbench/reference/
deepseek_v3.py``) on the CPU, with seeded random
weights: a prefill and then decode steps through the latent cache, two
slots at their own padded buckets as the engine runs them, against the
reference's full forward (f32 at 2e-5; the engine itself in bf16); the
published router's choice against a brute force over groups; YaRN's
frequencies and scale against the published formula; the expert share:
the outputs of every share, the shared expert counted once, add up to
the uncut layer, and a share drops nothing under a router skewed onto
its experts; ``flash_attention``'s (192, 128) path with its scale; the
spans and counters of the share.
"""
import dataclasses
import itertools
import math

import numpy as np
import pytest
import torch

from repro_torch.configs.common import deepseek_lm
from repro_torch.configs.deepseek_v3_671b import V3_ROUTER, V3_YARN, make_ep32
from repro_torch.device import make_generator
from repro_torch.kernels import ops
from repro_torch.models.lm import (lm_decode, lm_forward, lm_init,
                                   lm_init_cache, lm_prefill, tree_map)
from repro_torch.nn import mla, moe, rotary
from repro_torch.obs import profiling
from repro_torch.serving import Engine, ServeCfg

from perfbench.reference import deepseek_v3 as ref

CPU = torch.device("cpu")
F32 = torch.float32
YARN16 = rotary.YaRN(40.0, 16, 32.0, 1.0, 1.0, 1.0)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(first_expert=0, n_held=4, heads=(16, 8, 16), **router):
    """DeepSeek-V3's layout at a tiny width: 1 dense and 2 MoE layers,
    16 experts in 4 groups (2 kept), top-4, 1 shared, YaRN over 16
    original positions, the share [first_expert, first_expert + n_held)
    (all 16 with n_held 16)."""
    nope, rope, v = heads
    return deepseek_lm(
        "dsv3-tiny", layers=3, dense_layers=1, d_model=64, n_heads=4,
        vocab=97, moe_d_ff=32, dense_d_ff=96, n_experts=16, top_k=4,
        n_shared=1, kv_lora_rank=32, q_lora_rank=48, qk_nope_dim=nope,
        qk_rope_dim=rope, v_head_dim=v, rope_scaling=YARN16,
        router={**V3_ROUTER, "n_group": 4, "topk_group": 2,
                "first_expert": first_expert, "n_held": n_held, **router})


def port_of(cfg) -> dict:
    """The reference's ``port`` dict of a ``tiny`` config."""
    dense, moe_g = cfg.groups
    a, e = dense.cycle[0].mla, moe_g.cycle[0].moe
    y = a.rope_scaling
    return {"d_model": cfg.d_model, "vocab": cfg.vocab, "norm_eps": 1e-6,
            "dense_layers": dense.repeats, "moe_layers": moe_g.repeats,
            "mla": {"n_heads": a.n_heads, "kv_lora_rank": a.kv_lora_rank,
                    "qk_nope_dim": a.qk_nope_dim,
                    "qk_rope_dim": a.qk_rope_dim,
                    "v_head_dim": a.v_head_dim, "rope_theta": a.rope_theta,
                    "yarn": dataclasses.asdict(y)},
            "moe": {k: getattr(e, k) for k in (
                "n_group", "topk_group", "top_k", "routed_scaling",
                "first_expert", "n_held")}}


def weights(cfg, seed):
    return lm_init(make_generator(seed, CPU), cfg)


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


# -- the model ----------------------------------------------------------------

def test_make_ep32_is_the_published_config():
    cfg = make_ep32()
    dense, moe_g = cfg.groups
    a, e = dense.cycle[0].mla, moe_g.cycle[0].moe
    assert (cfg.d_model, cfg.vocab, cfg.tie_embeddings, cfg.mtp) \
        == (7168, 129280, False, False)
    assert (dense.repeats, moe_g.repeats) == (3, 13)
    assert dense.cycle[0].mlp.d_ff == 18432
    assert (a.n_heads, a.q_lora_rank, a.kv_lora_rank, a.qk_nope_dim,
            a.qk_rope_dim, a.v_head_dim, a.rope_theta) \
        == (128, 1536, 512, 128, 64, 128, 10000.0)
    assert a.rope_scaling == rotary.YaRN(40.0, 4096, 32.0, 1.0, 1.0, 1.0)
    assert (e.n_experts, e.top_k, e.d_ff, e.n_shared, e.score_func,
            e.score_correction, e.n_group, e.topk_group, e.routed_scaling,
            e.first_expert, e.n_held) \
        == (256, 8, 2048, 1, "sigmoid", True, 8, 4, 2.5, 0, 8)
    assert moe_g.cycle[0].mla == a


@pytest.mark.parametrize("seed", [0, 2**31 + 11])
def test_forward_is_the_reference(seed):
    cfg = tiny()
    w = weights(cfg, seed)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        1, cfg.vocab, 40))
    with torch.no_grad():
        got, _ = lm_forward(w, cfg, toks[None], compute_dtype=F32)
    (want,) = ref.forward(w, port_of(cfg), [toks], [torch.arange(40)])
    assert _rel(got[0], want) < 2e-5


def test_prefill_then_decode_through_the_latent_cache_is_the_forward():
    """Two slots prefilled at their own padded buckets, then decoded
    together with a position a row and per-row routing, as the engine
    runs them, in f32: every row's logits are the reference's full
    forward over the sequence processed, the padding included (past the
    16 original positions, where YaRN stretches the rope)."""
    cfg = tiny(heads=(128, 64, 128))
    w = weights(cfg, 5)
    port = port_of(cfg)
    rng = np.random.default_rng(5)
    buckets, steps = (8, 32), 12
    seqs = [torch.from_numpy(rng.integers(1, cfg.vocab, b + steps))
            for b in buckets]
    cache = lm_init_cache(cfg, 2, 64, dtype=F32)
    got = [[], []]
    with torch.no_grad():
        for slot, (b, s) in enumerate(zip(buckets, seqs)):
            sub = tree_map(lambda c: c[:, slot: slot + 1], cache)
            last, sub = lm_prefill(w, cfg, s[None, :b], sub,
                                   compute_dtype=F32)
            tree_map(lambda c, n: c[:, slot: slot + 1].copy_(n), cache, sub)
            got[slot].append(last[0, -1])
        pos = torch.tensor(buckets)
        for t in range(steps - 1):
            tok = torch.stack([s[b + t] for b, s in zip(buckets, seqs)])
            logits, cache = lm_decode(w, cfg, tok[:, None], cache, pos + t,
                                      compute_dtype=F32, route_rows=True)
            for slot in range(2):
                got[slot].append(logits[slot, -1])
    wants = [torch.arange(b - 1, b + steps - 1) for b in buckets]
    for g, want in zip(got, ref.forward(w, port, seqs, wants)):
        assert _rel(torch.stack(g), want) < 2e-5


def test_the_engine_serves_it_in_bf16():
    """``Engine`` over the published router, the dropless share and
    YaRN at MLA's head widths (the prefill takes ``flash_attention``'s
    (192, 128) path): every request gets its budget, and its first token
    is the argmax of logits within bf16 rounding of the reference's."""
    cfg = tiny(heads=(128, 64, 128))
    w = weights(cfg, 7)
    eng = Engine(cfg, w, ServeCfg(max_batch=2, max_seq=64), device=CPU)
    rng = np.random.default_rng(7)
    reqs = [(i, rng.integers(1, cfg.vocab, n), m)
            for i, (n, m) in enumerate([(5, 6), (20, 4), (11, 9)])]
    done, stats = eng.run(reqs)
    assert {i: len(t) for i, t in done.items()} == {0: 7, 1: 5, 2: 10}
    assert stats["prefills"] == 3
    # one prefill's logits against the reference's over the padded bucket
    toks = torch.zeros(8, dtype=torch.long)
    toks[:5] = torch.from_numpy(reqs[0][1])
    with torch.no_grad():
        last, _ = lm_prefill(w, cfg, toks[None], lm_init_cache(cfg, 1, 64))
    (want,) = ref.forward(w, port_of(cfg), [toks], [torch.tensor([7])])
    assert _rel(last[0, -1], want[0]) < 0.05


def test_the_engine_resumes_a_request_mid_answer():
    """``Engine.admit(..., answered=)``: the tokens already answered follow
    the padded prompt in one prefill, the slot's position is the bucket
    plus their number, its cache and first token are that prefill's, and
    a bucket with the answer that leaves no room is refused."""
    cfg = tiny(heads=(128, 64, 128))
    w = weights(cfg, 9)
    eng = Engine(cfg, w, ServeCfg(max_batch=2, max_seq=32), device=CPU)
    rng = np.random.default_rng(9)
    prompt, answered = rng.integers(1, cfg.vocab, 5), rng.integers(
        1, cfg.vocab, 6)
    slot = eng.admit(0, prompt, 3, answered=answered)
    assert eng.pos[slot] == 8 + 6
    toks = torch.zeros(14, dtype=torch.long)
    toks[:5], toks[8:] = torch.from_numpy(prompt), torch.from_numpy(answered)
    with torch.no_grad():
        last, sub = lm_prefill(w, cfg, toks[None], lm_init_cache(cfg, 1, 32))
    assert eng.last_tok[slot, 0] == int(last[0, -1].argmax())
    tree_map(lambda c, n: torch.testing.assert_close(
        c[:, slot: slot + 1, :14], n[:, :, :14].to(c.dtype)), eng.cache, sub)
    done = {}
    while len(done) < 1:
        done.update(eng.step())
    assert len(done[0]) == 1 + 3
    with pytest.raises(ValueError, match="no room"):
        eng.admit(1, prompt, 1, answered=rng.integers(1, cfg.vocab, 24))


@pytest.mark.parametrize("heads,plain", [((128, 64, 128), 0),
                                         ((16, 8, 16), 3)])
def test_mla_prefills_without_the_kernel_are_counted(heads, plain):
    """An engine prefill (``impl="kernel"``) at a head pair the kernel is
    not built for runs the plain products, one count a layer in
    ``ops.PLAIN_PREFILLS["mla"]``; at (192, 128) none."""
    cfg = tiny(heads=heads)
    eng = Engine(cfg, weights(cfg, 3), ServeCfg(max_batch=2, max_seq=32),
                 device=CPU)
    ops.reset_launches()
    eng.admit(0, np.arange(1, 6), 1)
    assert ops.PLAIN_PREFILLS["mla"] == plain


# -- the router ---------------------------------------------------------------

def _brute_route(scores, bias, n_group, topk_group, top_k, scaling):
    """Each token alone in Python: every subset of ``topk_group`` groups
    scored by the sum of its groups' two best corrected scores, the best
    subset's experts ranked by corrected score, the best ``top_k`` kept,
    weights their scores renormalised times ``scaling``."""
    E = len(bias)
    per = E // n_group
    ids, wts = [], []
    for s in scores.tolist():
        c = [x + b for x, b in zip(s, bias.tolist())]
        gscore = [sum(sorted(c[g * per:(g + 1) * per])[-2:])
                  for g in range(n_group)]
        best = max(itertools.combinations(range(n_group), topk_group),
                   key=lambda gs: sum(gscore[g] for g in gs))
        cand = [e for g in best for e in range(g * per, (g + 1) * per)]
        chosen = sorted(cand, key=lambda e: -c[e])[:top_k]
        tot = sum(s[e] for e in chosen)
        ids.append(sorted(chosen))
        wts.append({e: s[e] / tot * scaling for e in chosen})
    return ids, wts


def test_router_matches_brute_force_over_groups():
    cfg = moe.MoECfg(32, 16, n_experts=64, top_k=8, **V3_ROUTER)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(50, 32, generator=g)
    router = {"w": torch.randn(32, 64, generator=g) / math.sqrt(32),
              "correction": 0.1 * torch.randn(64, generator=g)}
    w, ids, probs = moe._route(x, router, cfg)
    scores = torch.sigmoid(x @ router["w"])
    assert torch.allclose(probs, scores, atol=1e-6)
    want_ids, want_w = _brute_route(scores, router["correction"], 8, 4, 8,
                                    2.5)
    assert [sorted(r) for r in ids.tolist()] == want_ids
    for row, (i, ww) in enumerate(zip(ids.tolist(), w.tolist())):
        for e, v in zip(i, ww):
            assert v == pytest.approx(want_w[row][e], rel=1e-5)
        assert sum(ww) == pytest.approx(2.5, rel=1e-5)


def test_the_router_margin_bounds_what_moves_the_held_experts():
    """The reference's ``held_margin`` (the witness beside the check's
    widest gaps): router logits moved by less than it (scores by less
    than a quarter of it) leave every token's held experts as they
    were."""
    moe = {"n_group": 4, "topk_group": 2, "top_k": 4, "routed_scaling": 2.5,
           "first_expert": 4, "n_held": 4}
    g = torch.Generator().manual_seed(3)
    x = torch.randn(300, 16, generator=g)
    f = {"router": {"w": torch.eye(16),
                    "correction": 0.1 * torch.randn(16, generator=g)}}
    margin = torch.full((300,), math.inf)
    _, ids = ref.route(f, x, moe, torch.matmul, margin)
    assert bool(torch.isfinite(margin).all()) and bool((margin >= 0).all())
    assert float(margin.min()) < 0.01

    def held(ids):
        return [sorted(set(r) & set(range(4, 8))) for r in ids.tolist()]
    for _ in range(5):
        push = (2 * torch.rand(300, 16, generator=g) - 1) \
            * 0.99 * margin[:, None]
        _, moved = ref.route(f, x + push, moe, torch.matmul)
        assert held(moved) == held(ids)


def test_default_router_is_unchanged_softmax_topk():
    """The defaults keep the softmax router: the top-k of the softmax,
    renormalised, no groups, no scaling."""
    cfg = moe.MoECfg(32, 16, n_experts=8, top_k=2)
    g = torch.Generator().manual_seed(4)
    x = torch.randn(20, 32, generator=g)
    router = {"w": torch.randn(32, 8, generator=g)}
    w, ids, _ = moe._route(x, router, cfg)
    p = torch.softmax(x @ router["w"], dim=-1)
    tw, tids = torch.topk(p, 2, dim=-1)
    assert torch.equal(ids, tids)
    assert torch.equal(w, tw / (tw.sum(-1, keepdim=True) + 1e-9))


# -- YaRN ---------------------------------------------------------------------

def test_yarn_matches_the_published_formula():
    """DeepSeek-V3's rope_scaling: frequencies from
    DeepseekV3YarnRotaryEmbedding's ramp, written out in float64, and
    the softmax scale times (0.1 ln 40 + 1)^2."""
    d, base, y = 64, 10000.0, V3_YARN

    def corr(rot):
        return d * math.log(4096 / (rot * 2 * math.pi)) / (2 * math.log(base))
    low, high = max(math.floor(corr(32)), 0), min(math.ceil(corr(1)), d - 1)
    assert (low, high) == (10, 23)
    want = []
    for i in range(d // 2):
        extra = base ** (-2 * i / d)
        ramp = min(max((i - low) / (high - low), 0.0), 1.0)
        want.append(extra / 40 * ramp + extra * (1 - ramp))
    got = rotary.yarn_freqs(d, base, y)
    assert torch.allclose(got.double(),
                          torch.tensor(want, dtype=torch.float64), rtol=1e-6)
    assert rotary.yarn_mscale(40, 1.0) == pytest.approx(
        0.1 * math.log(40) + 1)
    cfg = mla.MLACfg(7168, 128, q_lora_rank=1536, rope_scaling=y)
    assert mla._scale(cfg) == pytest.approx(
        192 ** -0.5 * (0.1 * math.log(40) + 1) ** 2)
    assert mla._scale(dataclasses.replace(cfg, rope_scaling=None)) \
        == pytest.approx(192 ** -0.5)
    pos = torch.arange(5000)
    cos, sin = rotary.rope_cos_sin(pos, d, base, y)
    ang = pos.double()[:, None] * torch.tensor(want, dtype=torch.float64)
    assert torch.allclose(cos.double(), torch.cos(ang), atol=2e-3)
    # mscale over mscale_all_dim multiplies cos and sin (V2's 0.707 / 0.707
    # is 1; 1 over 0.707 is not)
    odd = dataclasses.replace(y, mscale_all_dim=0.707)
    c2, s2 = rotary.rope_cos_sin(pos[:3], d, base, odd)
    m = rotary.yarn_mscale(40, 1.0) / rotary.yarn_mscale(40, 0.707)
    c1, s1 = rotary.rope_cos_sin(pos[:3], d, base, y)
    assert torch.allclose(c2, c1 * m) and torch.allclose(s2, s1 * m)


# -- the expert share ---------------------------------------------------------

def _layer(cfg, seed):
    """One MoE layer's parameters (all experts) and its config."""
    mcfg = cfg.groups[1].cycle[0].moe
    return moe.moe_init(make_generator(seed, CPU), mcfg), mcfg


def _share(p, mcfg, first, n):
    sp = {**p, **{k: p[k][first:first + n] for k in ("up", "gate", "down")}}
    return sp, dataclasses.replace(mcfg, first_expert=first, n_held=n)


@pytest.fixture(params=["dense", "sorted"])
def share_path(request, monkeypatch):
    """Both paths of the share: every held expert on every token (a
    decode step's few tokens), and the counts-sized sorted dispatch."""
    if request.param == "sorted":
        monkeypatch.setattr(moe, "SHARE_DENSE_MAX_TOKENS", 0)
    return request.param


def test_the_shares_add_up_to_the_uncut_layer(share_path):
    """The four shares of 4 of 16 experts, the shared expert counted
    once, give the whole layer (every expert held), and that is the
    reference's layer."""
    whole, wcfg = _layer(tiny(n_held=16), 9)
    x = torch.randn(3, 7, 64, generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        y_all, _ = moe.moe_apply(whole, wcfg, x, compute_dtype=F32)
        shared = moe.mlp_apply(whole["shared"], moe._shared_cfg(wcfg), x,
                               compute_dtype=F32)
        parts = [moe.moe_apply(*_share(whole, wcfg, f, 4), x,
                               compute_dtype=F32)[0] for f in (0, 4, 8, 12)]
    assert torch.allclose(sum(parts) - 3 * shared, y_all, atol=1e-5)
    port = {"moe": {k: getattr(wcfg, k) for k in (
        "n_group", "topk_group", "top_k", "routed_scaling", "first_expert",
        "n_held")}}
    with ref.f32_products():
        want = ref.moe_ffn(whole, x.reshape(-1, 64), port, torch.matmul)
    assert torch.allclose(y_all.reshape(-1, 64), want, atol=1e-5)


def test_the_share_is_dropless_under_a_skewed_router(share_path):
    """A correction bias that sends every token's four choices to the 4
    held experts: the share computes all of them (21 tokens x 4, where a
    capacity of 1.25 would keep 7 a expert) and matches the reference."""
    p, mcfg = _layer(tiny(n_held=16), 10)
    p["router"]["correction"] = torch.full((16,), -5.0)
    p["router"]["correction"][4:8] = 5.0
    sp, scfg = _share(p, mcfg, 4, 4)
    x = torch.randn(1, 21, 64, generator=torch.Generator().manual_seed(10))
    with torch.no_grad(), profiling.recording(annotate=False):
        profiling.take_counts()
        y, _ = moe.moe_apply(sp, scfg, x, compute_dtype=F32)
        counts = profiling.take_counts()
        names = {s.name for s in profiling.take().spans}
    assert counts == {"moe.routed": 84, "moe.held": 84}
    assert names == {"moe.route", "moe.experts", "moe.shared"}
    port = {"moe": {k: getattr(scfg, k) for k in (
        "n_group", "topk_group", "top_k", "routed_scaling", "first_expert",
        "n_held")}}
    with ref.f32_products():
        want = ref.moe_ffn(sp, x[0], port, torch.matmul)
    assert torch.allclose(y[0], want, atol=1e-5)
    # the capacity path drops what the share keeps
    with torch.no_grad():
        capped, _ = moe.moe_apply(p, mcfg.__class__(
            **{**dataclasses.asdict(mcfg), "n_held": 0}), x,
            compute_dtype=F32)
    assert not torch.allclose(capped, y, atol=1e-3)


def test_the_share_refuses_a_mesh_and_other_expert_counts():
    p, mcfg = _layer(tiny(n_held=16), 11)
    sp, scfg = _share(p, mcfg, 0, 4)
    x = torch.zeros(1, 2, 64)
    with pytest.raises(ValueError, match="share holds 8"):
        moe.moe_apply(sp, dataclasses.replace(scfg, n_held=8), x)
    with pytest.raises(ValueError, match="mesh"):
        moe.moe_spec(scfg)


# -- the prefill's attention --------------------------------------------------

def test_flash_attention_takes_the_mla_pair_and_a_scale():
    g = torch.Generator().manual_seed(12)
    q, k = (torch.randn(1, 9, 3, 192, generator=g) for _ in range(2))
    v = torch.randn(1, 9, 3, 128, generator=g)
    out = ops.flash_attention(q, k, v, causal=True, scale=0.3)
    s = torch.einsum("blhd,bshd->bhls", q, k) * 0.3
    s = s.masked_fill(~torch.tril(torch.ones(9, 9, dtype=torch.bool)),
                      -math.inf)
    want = torch.einsum("bhls,bshd->blhd", torch.softmax(s, -1), v)
    assert out.shape == (1, 9, 3, 128)
    assert torch.allclose(out, want, atol=1e-5)
    assert ops.flash_plan(torch.bfloat16, 192, 128).kernel == "mma_bf16"
    with pytest.raises(ValueError, match="d_head"):
        ops.flash_plan(torch.bfloat16, 192, 64)
    with pytest.raises(ValueError, match="d_head"):
        ops.flash_plan(torch.bfloat16, 192)


@pytest.mark.parametrize("heads,kernel", [((128, 64, 128), True),
                                          ((16, 8, 16), False)])
def test_mla_prefill_takes_the_kernel_path_at_the_published_pair(
        heads, kernel, monkeypatch):
    """``impl="kernel"`` sends MLA's prefill attention to
    ``flash_attention`` at (192, 128) with MLA's YaRN scale; other
    widths, and ``impl="plain"``, keep the einsums; both agree."""
    cfg = tiny(heads=heads).groups[0].cycle[0].mla
    p = mla.mla_init(make_generator(13, CPU), cfg)
    x = torch.randn(2, 11, 64, generator=torch.Generator().manual_seed(13))
    calls = []
    real = ops.flash_attention

    def spy(*a, **kw):
        calls.append(kw["scale"])
        return real(*a, **kw)
    monkeypatch.setattr(ops, "flash_attention", spy)
    with torch.no_grad():
        got = mla.mla_forward(p, cfg, x, impl="kernel", compute_dtype=F32)
        want = mla.mla_forward(p, cfg, x, impl="plain", compute_dtype=F32)
    assert calls == ([mla._scale(cfg)] if kernel else [])
    assert torch.allclose(got, want, atol=1e-5)
