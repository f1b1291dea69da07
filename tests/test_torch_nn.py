"""Layer parity of the LM side branch: the port's ``nn/`` and
``models/blocks.py`` against the JAX package on the same numpy inputs and
weights, in f32 (``compute_dtype=float32`` on both sides) at small widths.

Tolerances: 2e-5 for f32 (tests/test_kernels.py), 2e-4 where the chunked
SSD runs (the JAX SSD tests' own).  The kernel paths run here as the JAX
package's tests run them: the JAX Pallas kernels in interpret mode, the
port's wrappers through their plain versions (CPU tensors).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import blocks as jblocks
from repro.nn import attention as jattn
from repro.nn import core as jcore
from repro.nn import mlp as jmlp
from repro.nn import rotary as jrot
from repro.nn import ssm as jssm
from repro_torch.models import blocks
from repro_torch.models.lm import tree_map
from repro_torch.nn import attention, core, mlp, rotary, ssm

F32 = dict(rtol=2e-5, atol=2e-5)
SSD = dict(rtol=2e-4, atol=2e-4)
KEY = jax.random.PRNGKey(3)


def _t(tree):
    """A JAX tree (or numpy leaves) -> the same tree of CPU tensors."""
    return tree_map(lambda a: torch.tensor(np.asarray(a)),
                    jax.tree.map(np.asarray, tree))


def _close(got, expect, tol=F32):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(expect, np.float32), **tol)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# -- core ---------------------------------------------------------------------

@pytest.mark.parametrize("bias,cd", [(True, "f32"), (False, "f32"),
                                     (True, "bf16")])
def test_linear_matches_jax(bias, cd):
    p = {"w": _rand(0, 16, 24)}
    if bias:
        p["b"] = _rand(1, 24)
    x = _rand(2, 3, 5, 16)
    jcd, tcd = ((jnp.float32, torch.float32) if cd == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    got = core.linear(_t(p), torch.tensor(x), compute_dtype=tcd)
    assert got.dtype == tcd
    expect = jcore.linear(p, jnp.asarray(x), compute_dtype=jcd)
    _close(got.float(), expect, F32 if cd == "f32"
           else dict(rtol=2e-2, atol=2e-2))


@pytest.mark.parametrize("kind", ["rms", "ln", "ln_np"])
def test_norms_match_jax(kind):
    x = _rand(3, 4, 7, 32, scale=3.0)
    if kind == "rms":
        p = {"scale": _rand(4, 32)}
        got, expect = core.rmsnorm(_t(p), torch.tensor(x)), jcore.rmsnorm(
            p, jnp.asarray(x))
    else:
        p = ({"scale": _rand(4, 32), "bias": _rand(5, 32)} if kind == "ln"
             else {})
        got, expect = core.layernorm(_t(p), torch.tensor(x)), \
            jcore.layernorm(p, jnp.asarray(x))
    _close(got, expect)


def test_embed_unembed_and_activations_match_jax():
    p = {"table": _rand(6, 50, 16)}
    ids = np.random.default_rng(7).integers(0, 50, size=(2, 9))
    _close(core.embed(_t(p), torch.tensor(ids), compute_dtype=torch.float32),
           jcore.embed(p, jnp.asarray(ids), compute_dtype=jnp.float32))
    x = _rand(8, 2, 3, 16)
    for cd, jcd in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = core.unembed(_t(p), torch.tensor(x), compute_dtype=cd)
        assert got.dtype == torch.float32            # f32 logits
        _close(got, jcore.unembed(p, jnp.asarray(x), compute_dtype=jcd))
    _close(core.silu(torch.tensor(x)), jcore.silu(jnp.asarray(x)))
    _close(core.gelu(torch.tensor(x)), jcore.gelu(jnp.asarray(x)))


def test_truncated_normal_init_matches_jax_in_distribution():
    """Different streams, same law: fan-in scaled, cut at 2 sigma."""
    g = torch.Generator().manual_seed(0)
    t = core.linear_init(g, 256, 512)["w"].numpy()
    j = np.asarray(jcore.linear_init(KEY, 256, 512)["w"])
    assert t.shape == j.shape
    assert np.abs(t).max() <= 2.0 / 16 + 1e-6
    assert abs(t.std() / j.std() - 1) < 0.02
    assert abs(t.mean()) < 1e-3 and abs(j.mean()) < 1e-3


# -- rotary -----------------------------------------------------------------------

def test_rope_matches_jax():
    pos = np.array([0, 1, 5, 77, 4095])
    c, s = rotary.rope_cos_sin(torch.tensor(pos), 32, 1e6)
    jc, js = jrot.rope_cos_sin(jnp.asarray(pos), 32, 1e6)
    _close(c, jc)
    _close(s, js)
    x = _rand(9, 2, 5, 3, 32)
    _close(rotary.apply_rope(torch.tensor(x), c, s),
           jrot.apply_rope(jnp.asarray(x), jc, js))


# -- mlp ----------------------------------------------------------------------------

@pytest.mark.parametrize("gated,act", [(True, "silu"), (False, "gelu")])
def test_mlp_matches_jax(gated, act):
    jcfg = jmlp.MLPCfg(32, 64, gated=gated, act=act)
    tcfg = mlp.MLPCfg(32, 64, gated=gated, act=act)
    p = jmlp.mlp_init(KEY, jcfg)
    x = _rand(10, 2, 6, 32)
    _close(mlp.mlp_apply(_t(p), tcfg, torch.tensor(x),
                         compute_dtype=torch.float32),
           jmlp.mlp_apply(p, jcfg, jnp.asarray(x), compute_dtype=jnp.float32))


# -- attention ----------------------------------------------------------------------

ATTN_CFGS = {
    "qwen": dict(d_model=64, n_heads=4, n_kv_heads=2, d_head=32,
                 qkv_bias=True, rope_theta=1e6),
    "window_qknorm": dict(d_model=64, n_heads=4, n_kv_heads=1, d_head=32,
                          qk_norm=True, window=8),
    "mha_d64": dict(d_model=64, n_heads=2, n_kv_heads=2, d_head=64),
}


def _attn(name, **over):
    kw = {**ATTN_CFGS[name], **over}
    jcfg = jattn.AttnCfg(**kw)
    p = jattn.attn_init(KEY, jcfg)
    # non-zero biases, so the bias path is exercised
    rng = np.random.default_rng(1)
    p = jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32)),
        p)
    return jcfg, attention.AttnCfg(**kw), p


@pytest.mark.parametrize("name", sorted(ATTN_CFGS))
@pytest.mark.parametrize("jimpl,timpl", [("xla", "plain"), ("xla", "kernel"),
                                         ("flash", "kernel")])
def test_attn_forward_matches_jax(name, jimpl, timpl):
    jcfg, tcfg, p = _attn(name)
    x = _rand(11, 2, 20, 64)
    y, (k, v) = attention.attn_forward(_t(p), tcfg, torch.tensor(x),
                                       impl=timpl,
                                       compute_dtype=torch.float32,
                                       return_kv=True)
    jy, (jk, jv) = jattn.attn_forward(p, jcfg, jnp.asarray(x), impl=jimpl,
                                      compute_dtype=jnp.float32,
                                      return_kv=True)
    _close(y, jy)
    _close(k, jk)
    _close(v, jv)


def test_attn_forward_non_causal_takes_the_plain_path():
    jcfg, tcfg, p = _attn("qwen", causal=False)
    x = _rand(12, 1, 12, 64)
    _close(attention.attn_forward(_t(p), tcfg, torch.tensor(x),
                                  compute_dtype=torch.float32),
           jattn.attn_forward(p, jcfg, jnp.asarray(x), impl="flash",
                              compute_dtype=jnp.float32))


def test_causal_window_mask_matches_jax():
    for causal, window, off in ((True, None, 0), (True, 4, 3),
                                (False, 5, 0)):
        m = attention.causal_window_mask(6, 9, causal=causal, window=window,
                                         q_offset=off)
        jm = jattn.causal_window_mask(6, 9, causal=causal, window=window,
                                      q_offset=off)
        assert np.array_equal(m.numpy(), np.asarray(jm))


def _filled_cache(B, S, cfg, seed):
    shape = (B, S, cfg.n_kv_heads, cfg.d_head)
    return {"k": _rand(seed, *shape), "v": _rand(seed + 1, *shape)}


@pytest.mark.parametrize("name,ring,S,positions", [
    ("qwen", False, 16, [3, 11]),
    ("qwen", False, 16, [15, 20]),          # at / past the end: clamped
    ("window_qknorm", False, 32, [9, 30]),
    ("window_qknorm", True, 8, [5, 13]),    # ring buffer, warm and wrapped
])
def test_attn_decode_per_row_positions_match_jax(name, ring, S, positions):
    """The port decodes a batch with one position per row; each row equals
    the JAX single-sequence decode at that row's scalar position."""
    jcfg, tcfg, p = _attn(name, ring=ring)
    B = len(positions)
    cache = _filled_cache(B, S, jcfg, seed=13)
    x = _rand(15, B, 1, 64)
    y, nc = attention.attn_decode(_t(p), tcfg, torch.tensor(x), _t(cache),
                                  torch.tensor(positions),
                                  compute_dtype=torch.float32)
    for b, pos in enumerate(positions):
        row = {k: jnp.asarray(v[b:b + 1]) for k, v in cache.items()}
        jy, jc = jattn.attn_decode(p, jcfg, jnp.asarray(x[b:b + 1]), row,
                                   jnp.int32(pos), compute_dtype=jnp.float32)
        _close(y[b:b + 1], jy)
        _close(nc["k"][b:b + 1], jc["k"])
        _close(nc["v"][b:b + 1], jc["v"])


def test_attn_decode_scalar_position_and_cache_untouched():
    jcfg, tcfg, p = _attn("qwen")
    cache = _filled_cache(2, 16, jcfg, seed=17)
    tc = _t(cache)
    before = tc["k"].clone()
    x = _rand(18, 2, 1, 64)
    y, _ = attention.attn_decode(_t(p), tcfg, torch.tensor(x), tc, 6,
                                 compute_dtype=torch.float32)
    jy, _ = jattn.attn_decode(p, jcfg, jnp.asarray(x),
                              jax.tree.map(jnp.asarray, cache), jnp.int32(6),
                              compute_dtype=jnp.float32)
    _close(y, jy)
    assert torch.equal(tc["k"], before)


def test_cross_attention_is_not_ported():
    """Cross-attention is ported to neither the kernel nor the chunked
    attention (the reference runs its score-matrix path for both): with
    ``impl="kernel"`` and with ``impl="chunked"`` it takes the plain path,
    bit for bit, against the JAX layer."""
    kw = dict(d_model=64, n_heads=4, n_kv_heads=4, d_head=16, rope=False,
              causal=False, cross=True, d_kv_in=32)
    p = jattn.attn_init(KEY, jattn.AttnCfg(**kw))
    tcfg = attention.AttnCfg(**kw)
    x, enc = _rand(50, 2, 5, 64), _rand(51, 2, 7, 32)
    out = {impl: attention.attn_forward(
        _t(p), tcfg, torch.tensor(x), kv_src=torch.tensor(enc), impl=impl,
        compute_dtype=torch.float32) for impl in ("kernel", "plain",
                                                  "chunked")}
    assert torch.equal(out["kernel"], out["plain"])
    assert torch.equal(out["chunked"], out["plain"])
    _close(out["kernel"], jattn.attn_forward(
        p, jattn.AttnCfg(**kw), jnp.asarray(x), kv_src=jnp.asarray(enc),
        compute_dtype=jnp.float32))


# -- ssm -------------------------------------------------------------------------------

SSM_KW = dict(d_model=64, d_inner=128, head_dim=32, n_groups=2, d_state=16,
              chunk=8)


def _ssm(**over):
    kw = {**SSM_KW, **over}
    jcfg = jssm.SSMCfg(**kw)
    return jcfg, ssm.SSMCfg(**kw), jssm.ssm_init(KEY, jcfg)


@pytest.mark.parametrize("L", [20, 16])
@pytest.mark.parametrize("jimpl,timpl", [("xla", "plain"), ("xla", "kernel"),
                                         ("pallas", "kernel")])
def test_ssm_forward_matches_jax(L, jimpl, timpl):
    jcfg, tcfg, p = _ssm()
    x = _rand(20, 2, L, 64)
    y, st = ssm.ssm_forward(_t(p), tcfg, torch.tensor(x), impl=timpl,
                            compute_dtype=torch.float32, return_state=True)
    jy, jst = jssm.ssm_forward(p, jcfg, jnp.asarray(x), impl=jimpl,
                               compute_dtype=jnp.float32, return_state=True)
    _close(y, jy, SSD)
    _close(st["ssm"], jst["ssm"], SSD)
    _close(st["conv"], jst["conv"])


def test_ssd_reference_with_init_state_matches_jax():
    rng = np.random.default_rng(21)
    B, L, H, P, G, N = 2, 13, 4, 8, 2, 8
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32)
    A = -np.exp(0.5 * rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((B, L, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, L, G, N)).astype(np.float32)
    D = rng.standard_normal(H).astype(np.float32)
    S0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    args = (x, dt, A, Bm, Cm, D)
    y, s = ssm.ssd_reference(*map(torch.tensor, args), chunk=4,
                             init_state=torch.tensor(S0), return_state=True)
    jy, js = jssm.ssd_reference(*map(jnp.asarray, args), chunk=4,
                                init_state=jnp.asarray(S0),
                                return_state=True)
    _close(y, jy, SSD)
    _close(s, js, SSD)


def test_ssm_decode_matches_jax():
    jcfg, tcfg, p = _ssm()
    state = {"conv": _rand(22, 3, 3, 128 + 2 * 2 * 16),
             "ssm": _rand(23, 3, 4, 32, 16)}
    x = _rand(24, 3, 1, 64)
    y, st = ssm.ssm_decode(_t(p), tcfg, torch.tensor(x), _t(state),
                           compute_dtype=torch.float32)
    jy, jst = jssm.ssm_decode(p, jcfg, jnp.asarray(x),
                              jax.tree.map(jnp.asarray, state),
                              compute_dtype=jnp.float32)
    _close(y, jy)
    _close(st["ssm"], jst["ssm"])
    _close(st["conv"], jst["conv"])


def test_ssm_init_follows_the_mamba2_recipe():
    _, tcfg, _ = _ssm()
    p = ssm.ssm_init(torch.Generator().manual_seed(0), tcfg)
    H = tcfg.n_heads
    assert torch.equal(p["A_log"], torch.log(torch.arange(1.0, H + 1)))
    assert torch.equal(p["D"], torch.ones(H))
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert bool(((dt >= 0.001 - 1e-6) & (dt <= 0.1 + 1e-6)).all())
    j = jax.tree.map(np.shape, jssm.ssm_init(KEY, jssm.SSMCfg(**SSM_KW)))
    assert tree_map(lambda t: tuple(t.shape), p) == j


def test_init_ssm_state_layout_matches_jax():
    _, tcfg, _ = _ssm()
    st = ssm.init_ssm_state(2, tcfg)
    jst = jssm.init_ssm_state(2, jssm.SSMCfg(**SSM_KW))
    for k in ("conv", "ssm"):
        assert tuple(st[k].shape) == jst[k].shape
    assert st["conv"].dtype == torch.bfloat16
    assert st["ssm"].dtype == torch.float32


# -- blocks ------------------------------------------------------------------------------

def _block_cfgs(kind):
    if kind == "attn":
        kw = ATTN_CFGS["qwen"]
        return (jblocks.BlockCfg(64, attn=jattn.AttnCfg(**kw),
                                 mlp=jmlp.MLPCfg(64, 96)),
                blocks.BlockCfg(64, attn=attention.AttnCfg(**kw),
                                mlp=mlp.MLPCfg(64, 96)))
    return (jblocks.BlockCfg(64, mixer="ssm", ffn="none",
                             ssm=jssm.SSMCfg(**SSM_KW)),
            blocks.BlockCfg(64, mixer="ssm", ffn="none",
                            ssm=ssm.SSMCfg(**SSM_KW)))


@pytest.mark.parametrize("kind", ["attn", "ssm"])
def test_block_prefill_then_decode_matches_jax(kind):
    jcfg, tcfg = _block_cfgs(kind)
    p = jblocks.block_init(KEY, jcfg)
    tol = F32 if kind == "attn" else SSD
    B, L, S = 2, 12, 24
    jc = jblocks.block_init_cache(jcfg, B, S, dtype=jnp.float32)
    tc = blocks.block_init_cache(tcfg, B, S, dtype=torch.float32)
    assert tree_map(lambda t: tuple(t.shape), tc) == jax.tree.map(
        np.shape, jc)
    x = _rand(30, B, L, 64)
    y, tc, _ = blocks.block_prefill(_t(p), tcfg, torch.tensor(x), tc,
                                    compute_dtype=torch.float32)
    jy, jc, _ = jblocks.block_prefill(p, jcfg, jnp.asarray(x), jc,
                                      compute_dtype=jnp.float32)
    _close(y, jy, tol)
    for pos in (L, L + 1):
        x1 = _rand(31 + pos, B, 1, 64)
        y, tc = blocks.block_decode(_t(p), tcfg, torch.tensor(x1), tc, pos,
                                    compute_dtype=torch.float32)
        jy, jc = jblocks.block_decode(p, jcfg, jnp.asarray(x1), jc,
                                      jnp.int32(pos),
                                      compute_dtype=jnp.float32)
        _close(y, jy, tol)
    tree_map(lambda a, b: _close(a, b, tol), tc, jax.tree.map(np.asarray, jc))


def test_block_forward_matches_jax():
    jcfg, tcfg = _block_cfgs("attn")
    p = jblocks.block_init(KEY, jcfg)
    x = _rand(40, 2, 10, 64)
    y, aux = blocks.block_forward(_t(p), tcfg, torch.tensor(x),
                                  compute_dtype=torch.float32)
    jy, _ = jblocks.block_forward(p, jcfg, jnp.asarray(x),
                                  compute_dtype=jnp.float32)
    _close(y, jy)
    assert float(aux) == 0.0


@pytest.mark.parametrize("over", [dict(mixer="atn"), dict(ffn="moee")])
def test_block_init_refuses_an_unknown_mixer_or_ffn(over):
    """A misspelt mixer or FFN raises instead of building a block that
    lacks it."""
    _, tcfg = _block_cfgs("attn")
    with pytest.raises(ValueError, match="must be one of"):
        blocks.block_init(torch.Generator(),
                          dataclasses.replace(tcfg, **over))


@pytest.mark.parametrize("over", [dict(mixer="mla"), dict(ffn="moe"),
                                  dict(cross=attention.AttnCfg(64, 2, 2, 32,
                                                               cross=True))])
def test_block_parts_match_jax_and_moe_reads_the_mesh(over):
    """MLA mixers, MoE FFNs and cross-attention blocks: the block builds
    the JAX tree and its forward matches JAX's.  A MoE block switched to
    ``dispatch="shardmap"`` reads the mesh from the context: on a world of
    one it is the global path bit for bit."""
    from repro.nn import mla as jmla
    from repro.nn import moe as jmoe
    from repro_torch.nn import mla, moe
    jcfg, tcfg = _block_cfgs("attn")
    over, jover = dict(over), dict(over)
    if "mixer" in over:
        kw = dict(d_model=64, n_heads=2, q_lora_rank=32, kv_lora_rank=24,
                  qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
        over["mla"], jover["mla"] = mla.MLACfg(**kw), jmla.MLACfg(**kw)
    if "ffn" in over:
        kw = dict(d_model=64, d_ff=32, n_experts=4, top_k=2, n_shared=1)
        over["moe"], jover["moe"] = moe.MoECfg(**kw), jmoe.MoECfg(**kw)
    if "cross" in over:
        jover["cross"] = jattn.AttnCfg(64, 2, 2, 32, cross=True)
    jcfg = dataclasses.replace(jcfg, **jover)
    tcfg = dataclasses.replace(tcfg, **over)
    p = jblocks.block_init(KEY, jcfg)
    mine = blocks.block_init(torch.Generator(), tcfg)
    assert tree_map(lambda t: tuple(t.shape), mine) == jax.tree.map(
        np.shape, p)
    x, enc = _rand(60, 2, 6, 64), _rand(61, 2, 5, 64)
    y, aux = blocks.block_forward(_t(p), tcfg, torch.tensor(x),
                                  enc=torch.tensor(enc),
                                  compute_dtype=torch.float32)
    jy, jaux = jblocks.block_forward(p, jcfg, jnp.asarray(x),
                                     enc=jnp.asarray(enc),
                                     compute_dtype=jnp.float32)
    _close(y, jy)
    _close(aux, jaux)
    if "ffn" in over:
        from _dist_ranks import world_of_one
        from repro_torch.nn.sharding import use_mesh
        sm = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, dispatch="shardmap"))
        with world_of_one() as mesh, use_mesh(mesh):
            y1, aux1 = blocks.block_forward(_t(p), sm, torch.tensor(x),
                                            enc=torch.tensor(enc),
                                            compute_dtype=torch.float32)
        assert torch.equal(y1, y) and torch.equal(aux1, aux)
