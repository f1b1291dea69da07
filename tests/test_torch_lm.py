"""The LM slice against the JAX package: ``models/lm.py`` (f32, 2e-5; 2e-4
where the SSD runs), the continuous-batching ``Engine`` (bf16 on both
sides, equal token streams), the configs, the bridge and the serve demo.

Weights cross over through ``bridge.lm_params_from_numpy``; prompts are
made with numpy from a seed.  Everything runs on CPU tensors, so the
port's kernel wrappers run their plain versions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.launch.serve import serve_demo as jserve_demo
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.nn import attention as jattn
from repro.nn import mlp as jmlp
from repro.nn import ssm as jssm
from repro.serving import Engine as JEngine
from repro.serving import ServeCfg as JServeCfg
from repro_torch.bridge import lm_params_from_numpy
from repro_torch.configs import canonical_id, get_arch
from repro_torch.launch.serve import serve_demo
from repro_torch.models import blocks, lm
from repro_torch.nn import attention, mlp, ssm
from repro_torch.serving import Engine, ServeCfg
from repro_torch.serving.engine import _bucket

ARCHS = ["qwen2-0.5b", "mamba2-130m"]
F32 = dict(rtol=2e-5, atol=2e-5)
SSD = dict(rtol=2e-4, atol=2e-4)


def _tol(name):
    return SSD if "mamba" in name else F32


def _close(got, expect, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(expect, np.float32), **tol)


def _pair(name, seed=0):
    """(JAX cfg, port cfg, JAX params, port params) of a smoke config."""
    jcfg = jget_arch(name).make_smoke()
    tcfg = get_arch(name).make_smoke()
    jp = jlm.lm_init(jax.random.PRNGKey(seed), jcfg)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                              device="cpu")
    return jcfg, tcfg, jp, tp


def _tokens(seed, B, L, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, L))


# -- configs and bridge ----------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("make", ["make_full", "make_smoke"])
def test_configs_equal_the_jax_configs(name, make):
    jcfg = getattr(jget_arch(name), make)()
    tcfg = getattr(get_arch(name), make)()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.n_layers == jcfg.n_layers


def test_get_arch_aliases_and_unported_archs():
    """Every architecture of the registry is ported and found by either
    name; one outside it (not ported by either package) raises
    KeyError."""
    from repro_torch.configs import ARCH_IDS
    assert canonical_id("qwen2-0.5b") == "qwen2_0_5b"
    assert get_arch("mamba2_130m").name == "mamba2-130m"
    for name in ("olmo-1b", "deepseek-v3-671b", "whisper-small"):
        assert get_arch(name) is get_arch(canonical_id(name))
        assert get_arch(name).name == jget_arch(name).name
    assert len({get_arch(i).name for i in ARCH_IDS}) == 10
    with pytest.raises(KeyError):
        get_arch("gpt-17")


def test_bridge_keeps_the_tree_and_rejects_a_mismatch():
    jcfg, tcfg, jp, tp = _pair("qwen2-0.5b")
    assert lm.tree_map(lambda t: tuple(t.shape), tp) == jax.tree.map(
        np.shape, jp)
    other = get_arch("mamba2-130m").make_smoke()
    with pytest.raises(ValueError, match="does not fit"):
        lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                             dataclasses.replace(other, vocab=100),
                             device="cpu")


def test_lm_init_matches_the_jax_tree():
    for name in ARCHS:
        tcfg = get_arch(name).make_smoke()
        tp = lm.lm_init(torch.Generator().manual_seed(0), tcfg)
        jp = jlm.lm_init(jax.random.PRNGKey(0), jget_arch(name).make_smoke())
        assert lm.tree_map(lambda t: tuple(t.shape), tp) == jax.tree.map(
            np.shape, jp)


def test_lm_features_build_the_jax_tree_and_moe_reads_the_mesh():
    """MTP parameters, the VLM prefix projector, an untied head and learned
    positions each build the JAX tree.  The MoE takes its mesh from the
    context (``use_mesh``), not an argument: ``"shardmap"`` is the global
    path without a mesh and on a world of one (every expert local)."""
    from _dist_ranks import world_of_one
    from repro_torch.nn import moe
    from repro_torch.nn.sharding import use_mesh
    tcfg = get_arch("qwen2-0.5b").make_smoke()
    jcfg = jget_arch("qwen2-0.5b").make_smoke()
    for over in (dict(mtp=True), dict(prefix_embed_dim=8, n_prefix=4),
                 dict(tie_embeddings=False),
                 dict(pos_embed="learned", max_positions=32)):
        tp = lm.lm_init(torch.Generator(), dataclasses.replace(tcfg, **over))
        jp = jlm.lm_init(jax.random.PRNGKey(0),
                         dataclasses.replace(jcfg, **over))
        assert lm.tree_map(lambda t: tuple(t.shape), tp) == jax.tree.map(
            np.shape, jp)
    mcfg = moe.MoECfg(16, 8, n_experts=4, top_k=2, dispatch="shardmap")
    p = moe.moe_init(torch.Generator().manual_seed(0), mcfg)
    x = torch.randn(1, 6, 16, generator=torch.Generator().manual_seed(1))
    with pytest.raises(TypeError, match="mesh"):
        moe.moe_apply(p, mcfg, x, mesh=object())
    want = moe.moe_apply(p, dataclasses.replace(mcfg, dispatch="gspmd"), x)
    with world_of_one() as mesh, use_mesh(mesh):
        got = moe.moe_apply(p, mcfg, x)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# -- lm forward / prefill / decode (f32) -------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("jimpl", ["xla", "kernel"])
def test_lm_forward_matches_jax(name, jimpl):
    jcfg, tcfg, jp, tp = _pair(name)
    if jimpl == "kernel":
        jimpl = "flash" if "qwen" in name else "pallas"
    toks = _tokens(1, 2, 20)
    logits, aux = lm.lm_forward(tp, tcfg, torch.tensor(toks),
                                compute_dtype=torch.float32)
    jl, _ = jlm.lm_forward(jp, jcfg, jnp.asarray(toks), impl=jimpl,
                           compute_dtype=jnp.float32)
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    _close(logits, jl, _tol(name))


@pytest.mark.parametrize("name", ARCHS)
def test_lm_prefill_then_decode_matches_jax(name):
    jcfg, tcfg, jp, tp = _pair(name)
    B, L, S = 2, 16, 32
    toks = _tokens(2, B, L + 3)
    jc = jlm.lm_init_cache(jcfg, B, S, dtype=jnp.float32)
    tc = lm.lm_init_cache(tcfg, B, S, dtype=torch.float32)
    assert lm.tree_map(lambda t: tuple(t.shape), tc) == jax.tree.map(
        np.shape, jc)
    tl, tc = lm.lm_prefill(tp, tcfg, torch.tensor(toks[:, :L]), tc,
                           compute_dtype=torch.float32)
    jl, jc = jlm.lm_prefill(jp, jcfg, jnp.asarray(toks[:, :L]), jc,
                            compute_dtype=jnp.float32)
    assert tuple(tl.shape) == (B, 1, tcfg.vocab)
    _close(tl, jl, _tol(name))
    for i in range(3):
        tok = toks[:, L + i: L + i + 1]
        tl, tc = lm.lm_decode(tp, tcfg, torch.tensor(tok), tc, L + i,
                              compute_dtype=torch.float32)
        jl, jc = jlm.lm_decode(jp, jcfg, jnp.asarray(tok), jc,
                               jnp.int32(L + i), compute_dtype=jnp.float32)
        _close(tl, jl, _tol(name))
    lm.tree_map(lambda a, b: _close(a, b, _tol(name)), tc,
                jax.tree.map(np.asarray, jc))


def _hybrid(mod_blocks, mod_attn, mod_mlp, mod_ssm, mod_lm):
    """A two-repeat cycle of (Mamba2, shared attention+MLP): the
    ``shared=True`` parameter path of Zamba2, at smoke width."""
    s = mod_blocks.BlockCfg(64, mixer="ssm", ffn="none", ssm=mod_ssm.SSMCfg(
        64, 128, head_dim=32, n_groups=2, d_state=16, chunk=8))
    a = mod_blocks.BlockCfg(64, shared=True,
                            attn=mod_attn.AttnCfg(64, 4, 2, 32),
                            mlp=mod_mlp.MLPCfg(64, 128))
    return mod_lm.LMCfg(name="hybrid", vocab=256, d_model=64,
                        groups=(mod_lm.GroupCfg((s, a), 2),))


def test_shared_block_lm_matches_jax():
    jcfg = _hybrid(jblocks, jattn, jmlp, jssm, jlm)
    tcfg = _hybrid(blocks, attention, mlp, ssm, lm)
    jp = jlm.lm_init(jax.random.PRNGKey(5), jcfg)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                              device="cpu")
    assert set(tp["groups"][0]["shared"]) == {"1"}
    toks = _tokens(6, 1, 12, vocab=256)
    jc = jlm.lm_init_cache(jcfg, 1, 16, dtype=jnp.float32)
    tc = lm.lm_init_cache(tcfg, 1, 16, dtype=torch.float32)
    tl, tc = lm.lm_prefill(tp, tcfg, torch.tensor(toks), tc,
                           compute_dtype=torch.float32)
    jl, jc = jlm.lm_prefill(jp, jcfg, jnp.asarray(toks), jc,
                            compute_dtype=jnp.float32)
    _close(tl, jl, SSD)
    tl, _ = lm.lm_decode(tp, tcfg, torch.tensor([[3]]), tc, 12,
                         compute_dtype=torch.float32)
    jl, _ = jlm.lm_decode(jp, jcfg, jnp.asarray([[3]]), jc, jnp.int32(12),
                          compute_dtype=jnp.float32)
    _close(tl, jl, SSD)


# -- the engine against the JAX engine (bf16) ---------------------------------------

# Seeds whose JAX runs keep every greedy top-2 margin >= MIN_MARGIN: the
# port's bf16 logits differ from JAX's by up to ~0.025 on these configs
# (bf16 rounding in other places), so a narrower margin could flip a token.
ENGINE_SEEDS = {"qwen2-0.5b": 8, "mamba2-130m": 1}
MIN_MARGIN = 0.05


def _engine_requests(seed, n=4, vocab=512):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, vocab, size=rng.integers(4, 20)),
             int(rng.integers(3, 6))) for i in range(n)]


def _watched_jax_engine(jcfg, jp, sc):
    """A JAX engine that records the greedy top-2 margin of every logit
    row it acts on (prefill, and each active slot of each decode step)."""
    eng = JEngine(jcfg, jp, sc)
    margins = []
    prefill, vdecode = eng._prefill, eng._vdecode

    def top2(row):
        s = np.sort(np.asarray(row, np.float32))[::-1]
        return float(s[0] - s[1])

    def rec_prefill(*a):
        logits, cache = prefill(*a)
        margins.append(top2(logits[0, -1]))
        return logits, cache

    def rec_decode(*a):
        logits, cache = vdecode(*a)
        margins.extend(top2(logits[i, 0, -1]) for i in eng.active())
        return logits, cache
    eng._prefill, eng._vdecode = rec_prefill, rec_decode
    return eng, margins


@pytest.mark.parametrize("name", ARCHS)
def test_engine_token_streams_equal_the_jax_engine(name):
    seed = ENGINE_SEEDS[name]
    jcfg, tcfg, jp, tp = _pair(name, seed)
    reqs = _engine_requests(seed)
    jeng, margins = _watched_jax_engine(jcfg, jp, JServeCfg(max_batch=2,
                                                            max_seq=64))
    jdone, jstats = jeng.run(reqs)
    assert min(margins) >= MIN_MARGIN, sorted(margins)[:3]
    done, stats = Engine(tcfg, tp, ServeCfg(max_batch=2, max_seq=64),
                         device="cpu").run(reqs)
    assert done == jdone
    assert stats["decode_steps"] == jstats["decode_steps"]
    assert stats["prefills"] == len(reqs)


# -- the JAX package's engine tests, ported -------------------------------------------

@pytest.fixture(scope="module")
def qwen():
    cfg = get_arch("qwen2-0.5b").make_smoke()
    return cfg, lm.lm_init(torch.Generator().manual_seed(0), cfg)


def _eng(qwen, **kw):
    cfg, params = qwen
    return Engine(cfg, params, ServeCfg(**kw), device="cpu")


def test_bucket_is_pow2_with_floor_8():
    assert [_bucket(n) for n in (1, 8, 9, 100)] == [8, 8, 16, 128]


def test_admit_pads_prompt_to_bucket(qwen):
    eng = _eng(qwen, max_batch=2, max_seq=64)
    slot = eng.admit(7, np.arange(3), 4)
    assert eng.pos[slot] == 8
    slot2 = eng.admit(8, np.arange(9) % qwen[0].vocab, 4)
    assert eng.pos[slot2] == 16
    assert eng.slots[slot].uid == 7 and eng.slots[slot2].uid == 8
    with pytest.raises(RuntimeError, match="no free slot"):
        eng.admit(9, np.arange(3), 1)


def test_bucketing_does_not_change_greedy_output(qwen):
    prompt = np.arange(5)
    done_a, _ = _eng(qwen, max_batch=2, max_seq=64).run([(0, prompt, 4)])
    done_b, _ = _eng(qwen, max_batch=2, max_seq=64).run(
        [(0, prompt, 4), (1, np.arange(12) % qwen[0].vocab, 4)])
    assert done_a[0] == done_b[0]


def test_budget_exhaustion_frees_and_reuses_slot(qwen):
    eng = _eng(qwen, max_batch=1, max_seq=64)
    assert eng.free_slot() == 0
    eng.admit(0, np.arange(4), 2)
    assert eng.free_slot() is None
    finished = []
    while not finished:
        finished = eng.step()
    (uid, toks), = finished
    assert uid == 0 and len(toks) == 3
    assert eng.free_slot() == 0
    prompt = (np.arange(6) * 3) % qwen[0].vocab
    done_reuse, _ = eng.run([(1, prompt, 3)])
    done_fresh, _ = _eng(qwen, max_batch=1, max_seq=64).run([(1, prompt, 3)])
    assert done_reuse[1] == done_fresh[1]


def test_eos_terminates_before_budget(qwen):
    prompt = np.arange(4)
    done, _ = _eng(qwen, max_batch=1, max_seq=64).run([(0, prompt, 5)])
    eng = _eng(qwen, max_batch=1, max_seq=64, eos_id=done[0][1])
    done_eos, stats = eng.run([(0, prompt, 5)])
    assert done_eos[0] == done[0][:2]
    assert stats["decode_steps"] == 1
    assert eng.free_slot() == 0


def test_context_cap_finishes_slot(qwen):
    eng = _eng(qwen, max_batch=1, max_seq=16)
    done, _ = eng.run([(0, np.arange(8), 100)])
    assert len(done[0]) == 8
    assert eng.free_slot() == 0


def test_prompt_filling_the_context_matches_jax():
    """A bucket equal to max_seq: the first decode writes past the end,
    which both engines clamp to the last cache slot."""
    seed = ENGINE_SEEDS["qwen2-0.5b"]
    jcfg, tcfg, jp, tp = _pair("qwen2-0.5b", seed)
    reqs = [(0, _tokens(10, 1, 20)[0], 4)]
    jeng, margins = _watched_jax_engine(jcfg, jp, JServeCfg(max_batch=1,
                                                            max_seq=32))
    jdone, _ = jeng.run(reqs)
    assert min(margins) >= MIN_MARGIN, margins
    done, _ = Engine(tcfg, tp, ServeCfg(max_batch=1, max_seq=32),
                     device="cpu").run(reqs)
    assert len(done[0]) == 2 and done == jdone


# -- the serve demo -------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_serve_demo_runs_the_jax_demos_requests(name, capsys):
    """Same numpy-drawn requests as the JAX demo (other random weights):
    every request finishes with the same number of tokens."""
    done, stats = serve_demo(name, n_requests=4, max_seq=64, device="cpu")
    jdone, jstats = jserve_demo(name, n_requests=4, max_seq=64)
    assert {u: len(t) for u, t in done.items()} == \
        {u: len(t) for u, t in jdone.items()}
    assert stats["decode_steps"] == jstats["decode_steps"]
    assert "on cpu" in capsys.readouterr().out
