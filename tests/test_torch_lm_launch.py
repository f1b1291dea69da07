"""The port's LM training loop and launch layer on the CPU: the
synthetic token streams, the training CLI (the loss falls by more than
0.5 in 60 smoke steps, as ``tests/test_system.py`` requires of the JAX
package), the kernels' refusal under grad, ``PerfOpts`` as what
configures a step, the ring transform, parameter shapes on the meta
device, the roofline terms with the H100's constants (views counting no
bytes) and ``active_fraction`` against the JAX package's, and
``chip_smoke.py``'s ``lm_train`` phase run small."""
import dataclasses
import importlib.util
import sys
from pathlib import Path

import jax
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.launch import roofline as jroofline
from repro.models import lm as jlm
from repro.models import whisper as jwhisper
from repro_torch.configs import ARCH_IDS, SHAPES, get_arch, make_cfg
from repro_torch.data import lm_batch_stream, make_lm_batch, request_stream
from repro_torch.data.synthetic import RULE_A, RULE_C
from repro_torch.launch import roofline, steps
from repro_torch.launch import train as train_mod
from repro_torch.models import lm
from repro_torch.nn.core import count_params

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_make_lm_batch_follows_the_rule_and_shifts_the_labels():
    g = torch.Generator().manual_seed(0)
    b = make_lm_batch(g, vocab=97, batch=4, seq_len=50, structure=1.0,
                      device="cpu")
    toks, labels = b["tokens"], b["labels"]
    assert toks.shape == labels.shape == (4, 50)
    assert torch.equal(toks[:, 1:], labels[:, :-1])
    assert torch.equal(labels, (RULE_A * toks + RULE_C) % 97)
    b = make_lm_batch(g, vocab=97, batch=64, seq_len=128, structure=0.8,
                      device="cpu")
    follows = (b["labels"] == (RULE_A * b["tokens"] + RULE_C) % 97)
    # the rule, or a uniform draw that lands on it (1/97 of the rest)
    want = 0.8 + 0.2 / 97
    assert abs(follows.float().mean().item() - want) < 0.01
    assert 0 <= int(b["labels"].min()) and int(b["labels"].max()) < 97
    with pytest.raises(ValueError, match="CPU generator"):
        make_lm_batch(_NotCpu(), vocab=5, batch=1, seq_len=2, device="cpu")
    kw = dict(vocab=11, batch=2, seq_len=4, device="cpu")
    first = next(lm_batch_stream(3, **kw))
    stream = lm_batch_stream(3, **kw)
    assert torch.equal(next(stream)["tokens"], first["tokens"])
    assert not torch.equal(next(stream)["labels"], first["labels"])


class _NotCpu:
    """Stands for a generator on another device."""
    device = torch.device("meta")


def test_request_stream_is_the_reference_stream():
    from repro.data import request_stream as jstream
    got = list(request_stream(5, n_models=7, n=20))
    want = list(jstream(5, n_models=7, n=20))
    assert [vars(r) for r in got] == [vars(r) for r in want]


def test_training_cli_lowers_the_loss_by_more_than_half_a_nat(
        monkeypatch, capsys, tmp_path):
    """``python -m repro_torch.launch.train --arch qwen2-0.5b --steps 60
    --seq-len 64 --lr 3e-3 --device cpu`` (batch 8) with a checkpoint."""
    ckpt = tmp_path / "q.ckpt"
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", "qwen2-0.5b", "--steps", "60", "--seq-len", "64",
        "--lr", "3e-3", "--device", "cpu", "--ckpt", str(ckpt)])
    train_mod.main()
    out = capsys.readouterr().out
    last = out.strip().splitlines()[-1]
    final, first = (float(w.strip("()")) for w in
                    (last.split()[2], last.split()[4]))
    assert first - final > 0.5, out
    assert ckpt.stat().st_size > 0


def test_kernel_impl_is_refused_under_grad():
    """The kernels have no backward (nor have the reference's): a training
    step through ``impl="kernel"`` raises, on the CPU as on the card."""
    _, _, _, init_fn, step, batch_fn = train_mod.train_setup(
        "qwen2-0.5b", steps=2, batch=2, seq_len=16,
        opts=steps.PerfOpts(impl="kernel"), device="cpu")
    params, opt = init_fn(torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="no backward"):
        step(params, opt, batch_fn(torch.Generator().manual_seed(0)))


def test_perf_opts_tags_fsdp_refused_and_moe_shardmap_accepted():
    assert steps.PerfOpts().tag == "base"
    assert steps.PerfOpts(bf16_moments=True).tag == "bf16m"
    assert steps.PerfOpts(impl="chunked", ring=True).tag == "chunked-ring"
    assert steps.PerfOpts(impl="kernel", bf16_moments=True).tag == \
        "bf16m-kernel"
    # fsdp is accepted and tagged first, as the reference's
    assert steps.PerfOpts(fsdp=True).tag == "fsdp"
    assert steps.PerfOpts(fsdp=True, bf16_moments=True,
                          moe_shardmap=True).tag == "fsdp-bf16m-moesm"
    assert steps.PerfOpts(moe_shardmap=True, impl="chunked").tag == \
        "chunked-moesm"
    # every MoE block, and only those, switched to the expert-parallel
    # dispatch, as the reference's _apply_moe_shardmap does
    cfg = get_arch("deepseek-v3-671b").make_smoke()
    blocks = [b for g in steps._apply_moe_shardmap(cfg).groups
              for b in g.cycle]
    assert {b.moe.dispatch for b in blocks if b.ffn == "moe"} == \
        {"shardmap"}
    assert [dataclasses.replace(b, moe=None) for b in blocks] == [
        dataclasses.replace(b, moe=None) for g in cfg.groups
        for b in g.cycle]
    with pytest.raises(ValueError, match="impl"):
        steps.PerfOpts(impl="flash")
    arch = get_arch("qwen2-0.5b")
    with pytest.raises(ValueError, match="ring"):
        train_mod.make_train_fns(arch, arch.make_smoke(), lr_schedule=None,
                                 opts=steps.PerfOpts(ring=True))


def _opts_step(name, opts, monkeypatch):
    """One ``make_train_fns`` step configured by ``opts`` at smoke width,
    the loss computed beforehand through ``steps._loss_fn`` of the same
    impl, and the calls ``chunked_attention`` took during the step."""
    from repro_torch.nn import attention
    arch = get_arch(name)
    cfg = arch.make_smoke()
    init_fn, step = train_mod.make_train_fns(
        arch, cfg, lr_schedule=lambda s: 1e-3, opts=opts)
    params, opt = init_fn(torch.Generator().manual_seed(0))
    batch = train_mod.make_batch_fn(arch, cfg, batch=2, seq_len=16,
                                    device="cpu")(
        torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = float(steps._loss_fn(arch, cfg, opts.impl)(params, batch)[0])
    calls = []
    real = attention.chunked_attention
    monkeypatch.setattr(attention, "chunked_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    params, opt, m = step(params, opt, batch)
    return want, m, opt, params, len(calls)


@pytest.mark.parametrize("name", ["qwen2-0.5b", "whisper-small"])
def test_make_train_fns_honours_perf_opts(name, monkeypatch):
    """``impl`` picks the attention the step's loss runs (chunked for
    every self-attention of an LM; whisper's loss is its plain path),
    ``bf16_moments`` keeps Adam's moments in bf16: the first step's
    parameters equal those of f32 moments bit for bit (the update is
    computed in f32 before the moments are written back) and the moments
    are the f32 ones rounded."""
    runs = {bf16: _opts_step(name, steps.PerfOpts(
        impl="chunked", bf16_moments=bf16), monkeypatch)
        for bf16 in (False, True)}
    cfg = get_arch(name).make_smoke()
    n_attn = 0 if get_arch(name).kind == "whisper" else sum(
        g.repeats * sum(b.mixer == "attn" for b in g.cycle)
        for g in cfg.groups)
    for want, m, opt, _, calls in runs.values():
        assert float(m["loss"]) == want
        assert calls == n_attn
    (_, _, o32, p32, _), (_, _, o16, p16, _) = runs[False], runs[True]
    assert {t.dtype for t in o32["mu"] + o32["nu"]} == {torch.float32}
    assert {t.dtype for t in o16["mu"] + o16["nu"]} == {torch.bfloat16}
    for a, b in zip(lm.tree_leaves(p32), lm.tree_leaves(p16)):
        assert torch.equal(a, b)
    for a, b in zip(o32["mu"] + o32["nu"], o16["mu"] + o16["nu"]):
        assert torch.equal(a.to(torch.bfloat16), b)


def test_ring_transform_only_touches_windowed_attention():
    arch = get_arch("qwen3-4b")
    rcfg = steps._apply_ring(make_cfg(arch, "long_500k"))
    blk = rcfg.groups[0].cycle[0]
    assert blk.attn.ring and blk.attn.window == 8192
    assert not steps._apply_ring(make_cfg(arch, "decode_32k")) \
        .groups[0].cycle[0].attn.ring


def test_ring_cache_shrinks_cache_bytes():
    arch = get_arch("qwen3-4b")
    cfg = make_cfg(arch, "long_500k")
    S = SHAPES["long_500k"].seq_len
    full = lm.lm_init_cache(cfg, 1, S, device="meta")
    ring = lm.lm_init_cache(steps._apply_ring(cfg), 1, S, device="meta")
    fb, rb = count_params(full), count_params(ring)
    assert rb * 32 < fb             # 524288 / 8192 = 64x fewer slots


@pytest.mark.parametrize("name,smoke", [("qwen2-0.5b", False),
                                        ("whisper-small", False),
                                        ("deepseek-v3-671b", True),
                                        ("zamba2-7b", True)])
def test_param_shapes_match_the_reference_tree_without_storage(name, smoke):
    arch = get_arch(name)
    cfg = arch.make_smoke() if smoke else arch.make_full()
    shapes = steps.param_shapes(arch, cfg)
    leaves = lm.tree_leaves(shapes)
    assert all(t.device.type == "meta" for t in leaves)
    jarch = jget_arch(name)
    jcfg = jarch.make_smoke() if smoke else jarch.make_full()
    init = jwhisper.whisper_init if arch.kind == "whisper" else jlm.lm_init
    jsds = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), jcfg))
    assert [tuple(t.shape) for t in leaves] == \
        [x.shape for x in jax.tree.leaves(jsds)]
    assert count_params(shapes) == jroofline.count_params(jsds)


def test_roofline_terms_use_the_h100_constants():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW) == (989e12, 3.35e12)
    r = roofline.roofline({"flops": 989e12, "bytes accessed": 6.7e12},
                          {"total": 0.45e12}, chips=2,
                          model_flops_total=989e12)
    assert (r.compute_s, r.memory_s) == (1.0, 2.0)
    assert r.collective_s == 0.45e12 / roofline.NVLINK_BW
    assert r.bottleneck == "memory"
    assert r.model_flops == 989e12 / 2 and r.useful_ratio == 0.5
    assert roofline.model_flops(10, 3) == 180
    assert roofline.model_flops(10, 3, kind="prefill") == 60
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    out, cost = roofline.step_cost(torch.matmul, a, b)
    assert cost["flops"] == 2 * 8 * 16 * 4
    assert cost["bytes accessed"] == 4 * (8 * 16 + 16 * 4 + 8 * 4)
    assert torch.equal(out, a @ b)


def test_step_cost_counts_no_bytes_for_views():
    """Views and aliases move no bytes: a permute, a reshape, a
    transpose, ``detach`` and ``unbind`` count none; a matmul of a
    transposed view counts its operands and its output, once each."""
    a = torch.ones(8, 16)

    def views():
        return (a.permute(1, 0), a.reshape(4, 32), a.t(), a.detach(),
                a.unbind(0), a[2:5], a[None])
    _, cost = roofline.step_cost(views)
    assert cost["bytes accessed"] == 0 and cost["flops"] == 0
    _, cost = roofline.step_cost(lambda: a.t() @ a)
    assert cost["bytes accessed"] == 4 * (2 * 8 * 16 + 16 * 16)


def test_active_fraction_equals_the_reference_on_every_config():
    for aid in ARCH_IDS:
        for make in ("make_full", "make_smoke"):
            got = roofline.active_fraction(getattr(get_arch(aid), make)())
            want = jroofline.active_fraction(getattr(jget_arch(aid), make)())
            assert got == want, (aid, make)


def test_chip_smoke_lm_train_phase_runs_small_on_cpu():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    out = cs.phase_lm_train(
        "cpu", make="make_smoke",
        train=dict(steps=3, batch=2, seq_len=32, lr=3e-4), wide_steps=2,
        long_L=64, n_requests=2, max_prompt=40, max_seq=64, max_new=2)
    assert out["phase"] == "lm_train"
    for name in cs.LM_TRAIN_FULL:
        row = out["full"][name]
        assert row["lrs"][0] == 0.0 and len(row["lrs"]) == 3
        assert row["launches"] == {}
        assert row["step"]["counted_flops"] > row["step"]["model_flops"] * 0.5
        assert row["step"]["mfu"] is None          # no device time here
        assert out["serve"][name]["opt_step"] == 3
    assert out["long_context"]["loss_rel_diff"] <= cs.LONG_LOSS_TOL
    assert set(out["wide"]) == set(cs.LM_TRAIN_WIDE)
    assert len(out["others_smoke"]) == len(cs.ARCH_ORDER) - 4
    assert out["converge"]["loss_drop"] > 0.5
    # the CPU launches nothing; the card must launch one a layer a prefill
    for name, kern in (("qwen2-0.5b", "flash_attention"),
                       ("mamba2-130m", "ssd_scan")):
        layers = get_arch(name).make_smoke().n_layers
        assert out[f"{kern}_launches"] == 2 * layers
