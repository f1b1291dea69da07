"""The eight architectures this slice adds to the port's LM side branch,
against the JAX package, at their ``make_smoke`` widths on the CPU.

For each of olmo-1b, codeqwen1.5-7b, deepseek-v3-671b, zamba2-7b,
deepseek-v2-236b, internvl2-2b, qwen3-4b and whisper-small: the config
equals the JAX config, the port's init and the bridge give the JAX tree,
and the forward and a prefill followed by 4 decode steps match the JAX
package in f32 at 2e-5 (2e-4 where the SSD runs, as tests/test_torch_lm.py
holds mamba2); whisper's encode, prefill and decode likewise, and
internvl2 with ``prefix_embeds``.  Units: MLA's expanded forward against
its absorbed decode step by step; ``moe_apply`` against JAX with capacity
overflow, the aux loss and shared experts (f32 at 2e-5, bf16 at 2e-2:
the combine adds a token's bf16 contributions in its own order), and
per-row routing against the reference mapped over rows; cross-attention
and its static decode cache; learned positions; and what still raises.
Weights cross over through the bridge; inputs are made with numpy from a
seed.
"""
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import lm as jlm
from repro.models import whisper as jwhisper
from repro.nn import attention as jattn
from repro.nn import mla as jmla
from repro.nn import moe as jmoe
from repro_torch.bridge import lm_params_from_numpy, whisper_params_from_numpy
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.kernels import ops
from repro_torch.models import lm, whisper
from repro_torch.nn import attention, mla, moe

LM_ARCHS = ["olmo-1b", "codeqwen1.5-7b", "deepseek-v3-671b", "zamba2-7b",
            "deepseek-v2-236b", "internvl2-2b", "qwen3-4b"]
NEW_ARCHS = LM_ARCHS + ["whisper-small"]
F32 = dict(rtol=2e-5, atol=2e-5)
SSD = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)
KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tol(name):
    return SSD if "zamba" in name else F32


def _close(got, expect, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(expect, np.float32), **tol)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(name, seed=0):
    """(JAX cfg, port cfg, JAX params, port params) of a smoke config."""
    jcfg = jget_arch(name).make_smoke()
    tcfg = get_arch(name).make_smoke()
    if get_arch(name).kind == "whisper":
        jp = jwhisper.whisper_init(jax.random.PRNGKey(seed), jcfg)
        tp = whisper_params_from_numpy(_np(jp), tcfg, device="cpu")
    else:
        jp = jlm.lm_init(jax.random.PRNGKey(seed), jcfg)
        tp = lm_params_from_numpy(_np(jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def _tokens(seed, B, L, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, L))


def _prefix(cfg, seed, B):
    """VLM patch embeddings (B, n_prefix, prefix_embed_dim) for a VLM
    config, else None."""
    if not cfg.prefix_embed_dim:
        return None
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.n_prefix, cfg.prefix_embed_dim)).astype(np.float32)


# the port's own config fields (DeepSeek-V3's published router, its
# expert share, YaRN): the JAX configs lack them, and the JAX twins keep
# their defaults
PORT_ONLY_FIELDS = {"score_func": "softmax", "score_correction": False,
                    "n_group": 1, "topk_group": 1, "routed_scaling": 1.0,
                    "first_expert": 0, "n_held": 0, "rope_scaling": None}


def _plain(x):
    """A config as plain data, dtypes by name (the JAX and torch dtype
    objects of MoECfg.router_dtype differ); a port-only field is left
    out where it holds its default, so that a twin equals its JAX
    config."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)
                if not (f.name in PORT_ONLY_FIELDS and getattr(x, f.name)
                        == PORT_ONLY_FIELDS[f.name])}
    if isinstance(x, (tuple, list)):
        return [_plain(v) for v in x]
    if isinstance(x, torch.dtype):
        return str(x).replace("torch.", "")
    if isinstance(x, type) and hasattr(x, "dtype"):
        return np.dtype(x).name
    return x


# -- configs and the bridge ------------------------------------------------------

@pytest.mark.parametrize("name", NEW_ARCHS)
@pytest.mark.parametrize("make", ["make_full", "make_smoke"])
def test_configs_equal_the_jax_configs(name, make):
    jcfg = getattr(jget_arch(name), make)()
    tcfg = getattr(get_arch(name), make)()
    assert _plain(tcfg) == _plain(jcfg)
    assert get_arch(name).kind == jget_arch(name).kind
    assert dataclasses.asdict(get_arch(name))["family"] == \
        jget_arch(name).family


@pytest.mark.parametrize("name", NEW_ARCHS)
def test_init_and_bridge_give_the_jax_tree(name):
    jcfg, tcfg, jp, tp = _pair(name)
    shapes = jax.tree.map(np.shape, jp)
    assert lm.tree_map(lambda t: tuple(t.shape), tp) == shapes
    init = whisper.whisper_init if tcfg.__class__.__name__ == "WhisperCfg" \
        else lm.lm_init
    mine = init(torch.Generator().manual_seed(0), tcfg)
    assert lm.tree_map(lambda t: tuple(t.shape), mine) == shapes
    bridge = whisper_params_from_numpy if init is whisper.whisper_init \
        else lm_params_from_numpy
    tree = _np(jp)
    dropped = dict(tree)
    dropped.pop("embed")
    with pytest.raises(ValueError, match="does not fit"):
        bridge(dropped, tcfg, device="cpu")
    with pytest.raises(ValueError, match="does not fit|lead with"):
        bridge(tree, dataclasses.replace(tcfg, d_model=tcfg.d_model * 2),
               device="cpu")


def test_every_architecture_is_ported():
    assert [get_arch(i).name for i in ARCH_IDS] == \
        [jget_arch(i).name for i in ARCH_IDS]


# -- forward, prefill and decode against JAX (f32) ---------------------------------

@pytest.mark.parametrize("name", LM_ARCHS)
def test_lm_forward_matches_jax(name):
    jcfg, tcfg, jp, tp = _pair(name)
    toks, pre = _tokens(1, 2, 20), _prefix(tcfg, 2, 2)
    logits, aux = lm.lm_forward(
        tp, tcfg, torch.tensor(toks),
        prefix_embeds=None if pre is None else torch.tensor(pre),
        compute_dtype=torch.float32)
    jl, jaux = jlm.lm_forward(
        jp, jcfg, jnp.asarray(toks),
        prefix_embeds=None if pre is None else jnp.asarray(pre),
        compute_dtype=jnp.float32)
    assert tuple(logits.shape) == (2, 20 + tcfg.n_prefix * (pre is not None),
                                   tcfg.vocab)
    _close(logits, jl, _tol(name))
    _close(aux, jaux, F32)          # the MoE layers' load-balance loss
    assert (float(aux) > 0) == any(b.ffn == "moe" for g in tcfg.groups
                                   for b in g.cycle)


@pytest.mark.parametrize("name", LM_ARCHS)
def test_lm_prefill_then_decode_matches_jax(name):
    jcfg, tcfg, jp, tp = _pair(name)
    B, L, S = 2, 12, 48
    toks, pre = _tokens(2, B, L + 4), _prefix(tcfg, 3, B)
    P = tcfg.n_prefix if pre is not None else 0
    jc = jlm.lm_init_cache(jcfg, B, S, dtype=jnp.float32)
    tc = lm.lm_init_cache(tcfg, B, S, dtype=torch.float32)
    assert lm.tree_map(lambda t: tuple(t.shape), tc) == jax.tree.map(
        np.shape, jc)
    tl, tc = lm.lm_prefill(
        tp, tcfg, torch.tensor(toks[:, :L]), tc,
        prefix_embeds=None if pre is None else torch.tensor(pre),
        compute_dtype=torch.float32)
    jl, jc = jlm.lm_prefill(
        jp, jcfg, jnp.asarray(toks[:, :L]), jc,
        prefix_embeds=None if pre is None else jnp.asarray(pre),
        compute_dtype=jnp.float32)
    assert tuple(tl.shape) == (B, 1, tcfg.vocab)
    _close(tl, jl, _tol(name))
    for i in range(4):
        tok = toks[:, L + i: L + i + 1]
        tl, tc = lm.lm_decode(tp, tcfg, torch.tensor(tok), tc, P + L + i,
                              compute_dtype=torch.float32)
        jl, jc = jlm.lm_decode(jp, jcfg, jnp.asarray(tok), jc,
                               jnp.int32(P + L + i),
                               compute_dtype=jnp.float32)
        _close(tl, jl, _tol(name))
    lm.tree_map(lambda a, b: _close(a, b, _tol(name)), tc, _np(jc))


def test_whisper_encode_prefill_and_decode_match_jax():
    jcfg, tcfg, jp, tp = _pair("whisper-small")
    B, L, S = 2, 10, 32
    rng = np.random.default_rng(4)
    fe = rng.standard_normal((B, tcfg.n_frames, tcfg.d_model)).astype(
        np.float32)
    toks = _tokens(5, B, L + 4)
    f32 = dict(compute_dtype=torch.float32)
    jf32 = dict(compute_dtype=jnp.float32)
    _close(whisper.whisper_encode(tp, tcfg, torch.tensor(fe), **f32),
           jwhisper.whisper_encode(jp, jcfg, jnp.asarray(fe), **jf32), F32)
    tl, _ = whisper.whisper_forward(tp, tcfg, torch.tensor(fe),
                                    torch.tensor(toks), **f32)
    jl, _ = jwhisper.whisper_forward(jp, jcfg, jnp.asarray(fe),
                                     jnp.asarray(toks), **jf32)
    _close(tl, jl, F32)
    tc = whisper.whisper_init_cache(tcfg, B, S, dtype=torch.float32)
    jc = jwhisper.whisper_init_cache(jcfg, B, S, dtype=jnp.float32)
    assert lm.tree_map(lambda t: tuple(t.shape), tc) == jax.tree.map(
        np.shape, jc)
    tl, tc = whisper.whisper_prefill(tp, tcfg, torch.tensor(fe),
                                     torch.tensor(toks[:, :L]), tc, **f32)
    jl, jc = jwhisper.whisper_prefill(jp, jcfg, jnp.asarray(fe),
                                      jnp.asarray(toks[:, :L]), jc, **jf32)
    _close(tl, jl, F32)
    cross = tc["0"]["cross"]["k"].clone()
    for i in range(4):
        tok = toks[:, L + i: L + i + 1]
        tl, tc = whisper.whisper_decode(tp, tcfg, torch.tensor(tok), tc,
                                        L + i, **f32)
        jl, jc = jwhisper.whisper_decode(jp, jcfg, jnp.asarray(tok), jc,
                                         jnp.int32(L + i), **jf32)
        _close(tl, jl, F32)
    assert torch.equal(tc["0"]["cross"]["k"], cross)     # static
    lm.tree_map(lambda a, b: _close(a, b, F32), tc, _np(jc))


def test_learned_positions_match_jax():
    """Learned absolute positions (``pos_embed="learned"``, no config of
    the registry uses them in an LM) in forward, prefill and decode."""
    over = dict(pos_embed="learned", max_positions=24)
    jcfg = dataclasses.replace(jget_arch("qwen3-4b").make_smoke(), **over)
    tcfg = dataclasses.replace(get_arch("qwen3-4b").make_smoke(), **over)
    jp = jlm.lm_init(KEY, jcfg)
    tp = lm_params_from_numpy(_np(jp), tcfg, device="cpu")
    toks = _tokens(6, 2, 10)
    _close(lm.lm_forward(tp, tcfg, torch.tensor(toks),
                         compute_dtype=torch.float32)[0],
           jlm.lm_forward(jp, jcfg, jnp.asarray(toks),
                          compute_dtype=jnp.float32)[0], F32)
    tc = lm.lm_init_cache(tcfg, 2, 24, dtype=torch.float32)
    jc = jlm.lm_init_cache(jcfg, 2, 24, dtype=jnp.float32)
    _, tc = lm.lm_prefill(tp, tcfg, torch.tensor(toks), tc,
                          compute_dtype=torch.float32)
    _, jc = jlm.lm_prefill(jp, jcfg, jnp.asarray(toks), jc,
                           compute_dtype=jnp.float32)
    for pos in (10, 23, 30):         # 30: past the table, clamped
        tl, _ = lm.lm_decode(tp, tcfg, torch.tensor([[3], [4]]), tc, pos,
                             compute_dtype=torch.float32)
        jl, _ = jlm.lm_decode(jp, jcfg, jnp.asarray([[3], [4]]), jc,
                              jnp.int32(pos), compute_dtype=jnp.float32)
        _close(tl, jl, F32)


# -- MLA ------------------------------------------------------------------------------

MLA = dict(d_model=64, n_heads=4, q_lora_rank=48, kv_lora_rank=32,
           qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)


@pytest.mark.parametrize("over", [{}, dict(q_lora_rank=0), dict(window=5)])
def test_mla_forward_matches_jax_and_its_absorbed_decode(over):
    """The expanded forward against JAX; then position by position, the
    absorbed decode (per-row positions: the rows 3 apart) gives the
    expanded forward's outputs and fills the cache that ``return_kv``
    gives."""
    jcfg = jmla.MLACfg(**{**MLA, **over})
    tcfg = mla.MLACfg(**{**MLA, **over})
    jp = jmla.mla_init(KEY, jcfg)
    tp = lm.tree_map(torch.tensor, _np(jp))
    x = np.random.default_rng(7).standard_normal((2, 12, 64)).astype(
        np.float32)
    y, (c_kv, k_rope) = mla.mla_forward(tp, tcfg, torch.tensor(x),
                                        compute_dtype=torch.float32,
                                        return_kv=True)
    jy = jmla.mla_forward(jp, jcfg, jnp.asarray(x), compute_dtype=jnp.float32)
    _close(y, jy, F32)
    # row b decodes from position start_b on, its cache holding the
    # forward's c_kv/k_rope of the positions before
    start = torch.tensor([0, 3])
    cache = mla.init_mla_cache(2, 16, tcfg, dtype=torch.float32)
    for b in range(2):
        s0 = int(start[b])
        cache["c_kv"][b, :s0] = c_kv[b, :s0]
        cache["k_rope"][b, :s0] = k_rope[b, :s0]
    rows = torch.arange(2)
    for t in range(9):
        pos = start + t
        yt, cache = mla.mla_decode(tp, tcfg, torch.tensor(x)[rows, pos][:, None],
                                   cache, pos, compute_dtype=torch.float32)
        _close(yt[:, 0], y[rows, pos], F32)
    for b in range(2):
        n = int(start[b]) + 9
        _close(cache["c_kv"][b, :n], c_kv[b, :n], F32)
        _close(cache["k_rope"][b, :n], k_rope[b, :n], F32)


# -- MoE ------------------------------------------------------------------------------

def _moe(n_shared=1, capacity_factor=0.5, **over):
    kw = dict(d_model=32, d_ff=24, n_experts=4, top_k=2, n_shared=n_shared,
              capacity_factor=capacity_factor, **over)
    jcfg, tcfg = jmoe.MoECfg(**kw), moe.MoECfg(**kw)
    jp = jmoe.moe_init(KEY, jcfg)
    return jcfg, tcfg, jp, lm.tree_map(torch.tensor, _np(jp))


@pytest.mark.parametrize("n_shared,cf,dtype", [
    (1, 0.5, "f32"), (0, 0.5, "f32"), (2, 1.25, "f32"), (1, 0.5, "bf16")])
def test_moe_apply_matches_jax(n_shared, cf, dtype):
    """Capacity overflow dropped the same way (capacity factor 0.5: about
    half the assignments are dropped), the aux loss, shared experts."""
    jcfg, tcfg, jp, tp = _moe(n_shared, cf)
    x = np.random.default_rng(8).standard_normal((2, 10, 32)).astype(
        np.float32)
    cd, jcd, tol = ((torch.float32, jnp.float32, F32) if dtype == "f32"
                    else (torch.bfloat16, jnp.bfloat16, BF16))
    y, aux = moe.moe_apply(tp, tcfg, torch.tensor(x), compute_dtype=cd)
    jy, jaux = jmoe.moe_apply(jp, jcfg, jnp.asarray(x), compute_dtype=jcd)
    assert y.dtype == cd
    _close(y.float(), np.asarray(jy, np.float32), tol)
    _close(aux, jaux, F32)
    # with no shared expert, a token whose every assignment was dropped
    # comes out exactly 0 on both sides
    if n_shared == 0 and cf < 1:
        zero = np.all(np.asarray(jy) == 0, axis=-1)
        assert zero.any() and np.array_equal(
            zero, (y == 0).all(dim=-1).numpy())


def test_moe_route_rows_is_the_reference_mapped_over_rows():
    jcfg, tcfg, jp, tp = _moe(1, 0.5)
    x = np.random.default_rng(9).standard_normal((3, 4, 32)).astype(
        np.float32)
    y, aux = moe.moe_apply(tp, tcfg, torch.tensor(x),
                           compute_dtype=torch.float32, route_rows=True)
    jy, jaux = jax.vmap(lambda r: jmoe.moe_apply(
        jp, jcfg, r[None], compute_dtype=jnp.float32))(jnp.asarray(x))
    _close(y, np.asarray(jy)[:, 0], F32)
    _close(aux, np.mean(np.asarray(jaux)), F32)
    # joint routing drops other assignments here
    yj, _ = moe.moe_apply(tp, tcfg, torch.tensor(x),
                          compute_dtype=torch.float32)
    assert not torch.allclose(y, yj)


def test_moe_shardmap_is_the_global_path_without_a_mesh_and_on_one_rank():
    """``dispatch="shardmap"`` without a mesh, and on a world of one (every
    expert local, the sums over one rank), is the global path bit for bit;
    a mesh without a ``"model"`` dimension is refused."""
    from _dist_ranks import world_of_one
    from repro_torch.launch.mesh import make_cells_mesh
    from repro_torch.nn.sharding import use_mesh
    jcfg, tcfg, jp, tp = _moe(1, 1.25)
    x = torch.tensor(np.random.default_rng(10).standard_normal(
        (1, 6, 32)).astype(np.float32))
    sm = dataclasses.replace(tcfg, dispatch="shardmap")
    a = moe.moe_apply(tp, sm, x, compute_dtype=torch.float32)
    b = moe.moe_apply(tp, tcfg, x, compute_dtype=torch.float32)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with world_of_one() as mesh:
        with use_mesh(mesh):
            c = moe.moe_apply(tp, sm, x, compute_dtype=torch.float32)
        with use_mesh(make_cells_mesh()), pytest.raises(ValueError,
                                                        match="'model'"):
            moe.moe_apply(tp, sm, x, compute_dtype=torch.float32)
    assert torch.equal(c[0], b[0]) and torch.equal(c[1], b[1])


# -- cross-attention ------------------------------------------------------------------

def test_cross_attention_matches_jax_and_its_decode_cache_is_static():
    kw = dict(d_model=48, n_heads=4, n_kv_heads=2, d_head=12, rope=False,
              causal=False, cross=True, d_kv_in=40, qk_norm=True)
    jcfg, tcfg = jattn.AttnCfg(**kw), attention.AttnCfg(**kw)
    jp = jattn.attn_init(KEY, jcfg)
    tp = lm.tree_map(torch.tensor, _np(jp))
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    enc = rng.standard_normal((2, 9, 40)).astype(np.float32)
    # impl="kernel" still takes the plain path: no launch, no CPU plan
    y, (k, v) = attention.attn_forward(tp, tcfg, torch.tensor(x),
                                       kv_src=torch.tensor(enc),
                                       compute_dtype=torch.float32,
                                       return_kv=True)
    jy, (jk, jv) = jattn.attn_forward(jp, jcfg, jnp.asarray(x),
                                      kv_src=jnp.asarray(enc),
                                      compute_dtype=jnp.float32,
                                      return_kv=True)
    _close(y, jy, F32)
    _close(k, jk, F32)
    cache = {"k": k, "v": v}
    yd, new = attention.attn_decode(tp, tcfg, torch.tensor(x[:, :1]), cache,
                                    torch.tensor([3, 7]),
                                    compute_dtype=torch.float32)
    jyd, _ = jattn.attn_decode(jp, jcfg, jnp.asarray(x[:, :1]),
                               {"k": jk, "v": jv}, jnp.int32(3),
                               compute_dtype=jnp.float32)
    assert new is cache and new["k"] is k        # never written
    _close(yd, jyd, F32)
    _close(yd[:, 0], y[:, 0], F32)               # decode = forward row 0


# -- flash_attention's head dims -------------------------------------------------------

def test_flash_plan_takes_d_head_112_as_the_kernel_switch_does():
    src = (Path(ops.__file__).parent / "csrc" /
           "flash_attention.cu").read_text()
    for kind in ("simt", "mma"):
        pairs = [(int(d), int(dv)) for d, dv in re.findall(
            rf"FLASH_CASE\({kind}, (\d+), (\d+)\)", src)]
        assert tuple(d for d, dv in pairs if d == dv) \
            == ops.FLASH_HEAD_DIMS, kind
        assert [p for p in pairs if p[0] != p[1]] \
            == list(ops.FLASH_HEAD_PAIRS), kind
    assert 112 in ops.FLASH_HEAD_DIMS
    for dtype in (torch.float32, torch.bfloat16):
        assert ops.flash_plan(dtype, 112) == ops.flash_plan(dtype)
        for bad in (96, 120, 48):
            with pytest.raises(ValueError, match="d_head"):
                ops.flash_plan(dtype, bad)
    # zamba2-7b's shared attention: 3584 / 32 heads
    attn = get_arch("zamba2-7b").make_full().groups[0].cycle[-1].attn
    assert attn.d_head == 112 and attn.d_head in ops.FLASH_HEAD_DIMS
