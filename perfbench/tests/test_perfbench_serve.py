"""The serving cells at a tiny size on the CPU (the kernels' plain
versions): the plain reference against the port, the engine's prefill
and decode against the reference over the sequence it processed, whole
runs with and without a trace, the control and each planted fault
failing the check, the readers, and the bound arithmetic against
``chip_smoke.py``'s."""
import contextlib
import json
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from perfbench.counts import lm as clm
from perfbench.lib import check, faults, lm, runner, spec, trace
from perfbench.reference import qwen3 as ref
from perfbench.tests.tiny import REPO
from perfbench.tests.tiny_serve import CELL, REAL, serve_copy, smoke_config

sys.path.insert(0, str(REPO / "src"))
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(1)
    return serve_copy(tmp_path_factory.mktemp("serve"))


@pytest.fixture(scope="module")
def smoke():
    torch.set_num_threads(1)
    file = smoke_config()
    return file, lm.program_cfg(file)


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("seed, length", [(3, 40), (2**31 + 17, 64)])
def test_the_reference_is_the_ports_forward(smoke, seed, length):
    """Float32 on both sides, the same weights: the port's forward (the
    kernels' plain versions here) and the reference at every position."""
    from repro_torch.models.lm import lm_forward, lm_prefill, lm_init_cache
    file, cfg = smoke
    port = file["port"]
    w = lm.weights(port, seed, CPU)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        1, port["vocab"], length))
    with torch.no_grad():
        got, _ = lm_forward(w, cfg, toks[None], compute_dtype=torch.float32)
        last, _ = lm_prefill(w, cfg, toks[None], lm_init_cache(
            cfg, 1, 128, dtype=torch.float32), compute_dtype=torch.float32)
    (want,) = ref.forward(w, port, [toks], [torch.arange(length)])
    assert _rel(got[0], want) < 2e-5
    assert _rel(last[0, -1], want[-1]) < 2e-5
    # in the served bf16 the port stays near, and far from the control
    with torch.no_grad():
        bf, _ = lm_forward(w, cfg, toks[None])
    (fp8,) = ref.forward(w, port, [toks], [torch.arange(length)],
                         mm=ref.fp8_matmul)
    assert _rel(bf[0], want) < 0.05 < _rel(fp8, want)


def test_prefill_then_decode_through_the_cache_is_the_full_forward(smoke):
    """Two slots prefilled at their own padded buckets, then decoded
    together with a position a row, as the engine does, in float32:
    each row's logits are the reference's over the sequence processed,
    the padding included."""
    from repro_torch.models.lm import (lm_decode, lm_init_cache, lm_prefill,
                                       tree_map)
    file, cfg = smoke
    port = file["port"]
    w = lm.weights(port, 11, CPU)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, port["vocab"], n) for n in (5, 19)]
    buckets = [8, 32]
    f32 = torch.float32
    cache = lm_init_cache(cfg, 2, 64, dtype=f32)
    seqs, got = [], [[], []]
    with torch.no_grad():
        for i, (p, b) in enumerate(zip(prompts, buckets)):
            toks = np.zeros(b, np.int64)
            toks[: len(p)] = p
            seqs.append(list(toks))
            sub = tree_map(lambda c: c[:, i: i + 1], cache)
            logits, sub = lm_prefill(w, cfg, torch.from_numpy(toks)[None],
                                     sub, compute_dtype=f32)
            tree_map(lambda c, s: c[:, i: i + 1].copy_(s), cache, sub)
            got[i].append(logits[0, -1])
        pos = torch.tensor(buckets)
        for _ in range(6):
            nxt = [int(torch.argmax(g[-1])) for g in got]
            for s, t in zip(seqs, nxt):
                s.append(t)
            logits, cache = lm_decode(w, cfg, torch.tensor(nxt)[:, None],
                                      cache, pos, compute_dtype=f32)
            for i in range(2):
                got[i].append(logits[i, -1])
            pos = pos + 1
    wants = [torch.arange(b - 1, len(s)) for b, s in zip(buckets, seqs)]
    refs = ref.forward(w, port, [torch.tensor(s) for s in seqs], wants)
    for g, r in zip(got, refs):
        assert _rel(torch.stack(g), r) < 2e-5


@pytest.mark.parametrize("traced", [False, True])
def test_a_run_on_the_cpu(root, traced):
    out = runner.run_cell(CELL, 2**31 + 77, 0.5, traced, CPU,
                          time.perf_counter(), root=root,
                          pkg=root / "perfbench")
    w = out.pop("window")
    assert out.pop("setup")["cell_s"] > 0
    assert w["units"] > 0 and w["finished"] > 0 and w["requests"] > 0
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] == w["requests"]
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == {"token_gap", "logit_gap"}
    e2e, _ = spec.metrics_of(spec.benchmark(root), CELL)
    if traced:
        # no device number is ever read off a CPU run; the host clock's
        # tails are read on any platform
        assert set(out["metrics"]) == {"ttft_ms_p95.serve",
                                       "tpot_ms_p95.serve"}
        assert out["device"]["window_s"] > 0
    else:
        assert set(out["metrics"]) == {m["name"] for m in e2e} == {
            "setup_s", "served_tokens_per_s"}
        assert out["metrics"]["served_tokens_per_s"]["value"] == \
            pytest.approx(w["tokens_per_s"])
        assert all(m["value"] > 0 for m in out["metrics"].values())
    json.loads(json.dumps(out))


def test_the_same_seed_serves_the_same_requests(root):
    """The pool is fixed; a seed shuffles it: two seeds serve the same
    prompt lengths and budgets in another order."""
    cell = spec.cell(CELL, root / "perfbench")
    gen = spec.generator("serve", root / "perfbench")
    a, b, c = (gen.Traffic(cell, s, CPU) for s in (5, 5, 2**33 + 1))
    ra, rb, rc = ([t._next() for _ in range(16)] for t in (a, b, c))
    assert [(len(x.prompt), x.budget) for x in ra] == \
        [(len(x.prompt), x.budget) for x in rb]
    assert all((x.prompt == y.prompt).all() for x, y in zip(ra, rb))
    key = lambda rs: sorted(len(x.prompt) for x in rs)  # noqa: E731
    assert key(ra) == key(rc)
    assert [len(x.prompt) for x in ra] != [len(x.prompt) for x in rc]


def _traffic(root, seed, fault=None, seconds=0.5):
    c, d = runner.make_traffic(CELL, seed, CPU, root / "perfbench")
    with faults.planted(fault) if fault else contextlib.nullcontext():
        d.setup()
        d.window(seconds)
    d.free()
    return c["workload"]["limits"], d


def test_the_control_fails_and_the_program_passes(root):
    limits, d = _traffic(root, 2**31 + 3)
    assert check.verdict(d.readings(), limits)[0]
    ok, checks = check.verdict(d.readings(control=True), limits)
    assert not ok, checks


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_a_run_with_a_planted_fault_is_not_correct(root, fault):
    """The whole run, the chip's look skipped, with the timed path broken
    underneath."""
    with faults.planted(fault):
        out = runner.run_cell(CELL, 2**31 + 11, 0.5, False, CPU,
                              time.perf_counter(), root=root,
                              pkg=root / "perfbench")
    assert out["correct"] is False, out["checks"]


def test_faults_and_capture_leave_the_program_as_it_was(root):
    import repro_torch.serving.engine as eng
    before = (eng.lm_prefill, eng.lm_decode)
    with faults.planted("half_batch"):
        assert eng.lm_decode is not before[1]
    _traffic(root, 4)
    assert (eng.lm_prefill, eng.lm_decode) == before


def test_the_program_must_be_the_configuration(smoke):
    file = json.loads(json.dumps(smoke[0]))
    file["port"]["attn"]["n_kv_heads"] = 4
    with pytest.raises(ValueError, match="another model"):
        lm.program_cfg(file)


def test_readers_on_a_made_up_trace(root):
    cfg = spec.cell(REAL)["config"]
    port = cfg["port"]
    kern = ([("void (anonymous namespace)::flash_mma_kernel<128>(x)", 0.004)]
            + [("at::native::elementwise_kernel", 0.001)] * 4)
    tr = trace.Trace(window_s=2.0, busy_s=1.0, kernels=kern, device_ops=[],
                     idle_gaps=[])
    ctx = SimpleNamespace(platform="gpu", trace=tr, config=cfg,
                          work={"steps": 4, "tokens": 10,
                                "prefills": [64, 2048]},
                          window={"seconds": 10.0, "tokens": 40,
                                  "ttft_ms": list(range(1, 21)),
                                  "step_ms": [5.0] * 19 + [25.0]},
                          window_flops=989e12)
    read = lambda m: spec.reader(m).read(ctx)  # noqa: E731
    flash = 36 * (clm.flash_bound_s(1, 64, 64, 32, 8, 128, 2)
                  + clm.flash_bound_s(1, 2048, 2048, 32, 8, 128, 2))
    assert read("flash_attention_roofline.serve") == pytest.approx(
        100 * flash / 0.004)
    assert read("kernels_per_token.serve") == pytest.approx(5 / 10)
    # 0.1 s busy a token against 0.25 s of window a token
    assert read("idle_share.serve") == pytest.approx(60.0)
    assert read("mfu.serve") == pytest.approx(10.0)
    assert read("ttft_ms_p95.serve") == pytest.approx(19.05)
    assert read("tpot_ms_p95.serve") == pytest.approx(6.0)
    cpu = SimpleNamespace(**{**vars(ctx), "platform": "cpu"})
    none = {"flash_attention_roofline.serve", "kernels_per_token.serve",
            "idle_share.serve", "mfu.serve"}
    assert {m for m in none if spec.reader(m).read(cpu) is None} == none
    no_prefill = SimpleNamespace(**{**vars(ctx), "work": {
        **ctx.work, "prefills": []}})
    assert spec.reader("flash_attention_roofline.serve").read(
        no_prefill) is None


def _chip_smoke():
    import importlib.util
    s = importlib.util.spec_from_file_location("chip_smoke_bounds",
                                               REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("L", [512, 4096])
def test_bounds_are_chip_smokes(L):
    """The frozen copy against ``chip_smoke.py``'s own, at qwen3-4b's
    shapes: bytes bound at 512 positions, operations at 4096."""
    cs = _chip_smoke()
    f = cs.flash_bound_ms(1, L, L, 32, 8, 128, 2)[0]
    assert 1e3 * clm.flash_bound_s(1, L, L, 32, 8, 128, 2) == \
        pytest.approx(f, rel=1e-12)
    pairs = L * (L + 1) // 2
    ops = 4 * 128 * 32 * pairs / clm.BF16_FLOPS
    byts = 2 * (2 * L * 32 * 128 + 2 * L * 8 * 128) / 3.35e12
    assert f == pytest.approx(1e3 * max(ops, byts), rel=1e-12)
    assert (byts > ops) == (L == 512)


def test_model_flops_by_hand():
    port = {"d_model": 4, "vocab": 10,
            "groups": [{"cycle": ["attn"], "repeats": 3}],
            "attn": {"n_heads": 2, "n_kv_heads": 1, "d_head": 2},
            "mlp": {"d_ff": 6, "gated": True}}
    layer = 2 * 4 * (2 * 4 + 2 * 2) + 2 * 4 * 6 * 3
    body, per_key = clm.token_body(port)
    assert (body, per_key) == (3 * layer, 4 * 2 * 2 * 3)
    assert clm.head_flops(port) == 2 * 4 * 10
    assert clm.prompt_flops(port, 3) == 3 * body + 6 * per_key + 80
    assert clm.attn_layers(port) == 3
    assert clm.prefill_launches(port, 8) == [
        ("flash_attention", 3, clm.flash_bound_s(1, 8, 8, 2, 1, 2, 2))]
