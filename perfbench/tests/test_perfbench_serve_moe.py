"""The MLA/MoE serving cell at a tiny size on the CPU (the kernels' plain
versions): the plain reference against the port, whole runs with and
without a trace, the control and each planted fault failing the check,
the parent's lack of the configuration failing at set-up, the span
attribution and the readers, and the operation counts."""
import contextlib
import json
import math
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from perfbench.counts import moe_lm as counts
from perfbench.generators import serve_moe
from perfbench.lib import faults, faults_moe, moe_lm, runner, spec
from perfbench.reference import deepseek_v3 as ref
from perfbench.tests.tiny import REPO
from perfbench.tests.tiny_serve_moe import (CELL, REAL, TINY_PORT,
                                            serve_moe_copy, tiny_config)

sys.path.insert(0, str(REPO / "src"))
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(1)
    return serve_moe_copy(tmp_path_factory.mktemp("serve_moe"))


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("seed, length", [(3, 40), (2**31 + 17, 64)])
def test_the_reference_is_the_ports_forward(seed, length):
    """Float32 on both sides, the same weights (YaRN past its 16 original
    positions, the published router, the share of experts 4-7): the
    port's forward and the reference at every position; in bf16 the
    port stays near, the float8 control far."""
    from repro_torch.models.lm import lm_forward
    file = tiny_config()
    torch.set_num_threads(1)
    cfg = moe_lm.program_cfg(file)
    w = moe_lm.weights(file["port"], seed, CPU)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        1, TINY_PORT["vocab"], length))
    with torch.no_grad():
        got, _ = lm_forward(w, cfg, toks[None], compute_dtype=torch.float32)
        bf, _ = lm_forward(w, cfg, toks[None])
    (want,) = ref.forward(w, file["port"], [toks], [torch.arange(length)])
    (fp8,) = ref.forward(w, file["port"], [toks], [torch.arange(length)],
                         mm=ref.fp8_matmul)
    assert _rel(got[0], want) < 2e-5
    rows = lambda x: [_rel(x[i], want[i]) for i in range(length)]  # noqa
    assert np.median(rows(bf[0])) < 0.05 < np.median(rows(fp8))


def test_the_file_states_the_published_config():
    file = json.loads((REPO / "perfbench" / "configs"
                       / "deepseek-v3-ep32.json").read_text())
    bench = spec.benchmark(REPO)
    entry = next(c for c in bench["configs"] if c["name"] == file["name"])
    assert set(entry["reduced"]) == {k for k, v in file["published"].items()
                                     if file[k] != v}
    assert (file["num_hidden_layers"], file["n_routed_experts"],
            file["num_nextn_predict_layers"]) == (16, 8, 0)
    port = file["port"]
    assert port["dense_layers"] + port["moe_layers"] \
        == file["num_hidden_layers"]
    assert port["moe"]["n_held"] == file["n_routed_experts"]
    assert port["moe"]["n_experts"] == file["published"]["n_routed_experts"]
    y = file["rope_scaling"]
    assert port["mla"]["yarn"] == {
        "factor": y["factor"],
        "original_max_positions": y["original_max_position_embeddings"],
        "beta_fast": y["beta_fast"], "beta_slow": y["beta_slow"],
        "mscale": y["mscale"], "mscale_all_dim": y["mscale_all_dim"]}


def test_program_cfg_refuses_another_model():
    file = tiny_config()
    moe_lm.program_cfg(file)
    for key, value in (("n_held", 8), ("routed_scaling", 1.0)):
        bad = json.loads(json.dumps(file))
        bad["port"]["moe"][key] = value
        with pytest.raises(ValueError, match="another model"):
            moe_lm.program_cfg(bad)
    gone = json.loads(json.dumps(file))
    gone["program"]["make"] = "make_nothing"
    with pytest.raises(AttributeError):
        moe_lm.program_cfg(gone)


@pytest.mark.parametrize("traced", [False, True])
def test_whole_runs_on_the_cpu(root, traced):
    out = runner.run_cell(CELL, 2**31 + 5, 0.5, traced, CPU,
                          time.perf_counter(), root=root,
                          pkg=root / "perfbench")
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    names = set(out["metrics"])
    if traced:
        # the device readers read nothing off a card
        assert names == {"held_expert_tokens.serve_moe",
                         "tpot_ms_p95.serve", "ttft_ms_p95.serve"}
    else:
        assert names == {"setup_s", "served_tokens_per_s"}


@pytest.mark.parametrize("fault", ["control", "v2_router", "no_mscale",
                                   "unchanged", "half_batch", "altered"])
def test_the_control_and_the_faults_fail_the_check(root, fault,
                                                   monkeypatch):
    monkeypatch.setattr(faults, "SITES", {**faults.SITES,
                                          **faults_moe.SITES})
    _, tr = runner.make_traffic(CELL, 2**31 + 7919 * 20, CPU,
                                root / "perfbench")
    with (faults.planted(fault) if fault != "control"
          else contextlib.nullcontext()):
        tr.setup()
        tr.window(0.5)
    tr.free()
    limits = json.loads((root / "perfbench" / "workloads"
                         / f"{CELL}.json").read_text())["limits"]
    ok, checks = runner.check.verdict(tr.readings(control=fault
                                                  == "control"), limits)
    assert not ok, checks


def test_the_witness_holds_the_reference_to_the_programs_experts(root):
    """``witness``: the program's expert ids at every position of each
    kept request (its prefill's, then one decode step's row a position)
    and the gaps again with the reference's router held to them; the
    widest rows and tokens beside the router's closest call."""
    _, tr = runner.make_traffic(CELL, 2**31 + 5, CPU, root / "perfbench")
    tr.witness = True
    tr.setup()
    tr.window(0.5)
    tr.free()
    tr.readings()
    port = tr.port
    for r in tr.kept:
        ids = tr._program_ids(r)
        assert tuple(ids.shape) == (port["moe_layers"], r.bucket + r.budget,
                                    port["moe"]["top_k"])
        assert int(ids.min()) >= 0 \
            and int(ids.max()) < port["moe"]["n_experts"]
    forced = tr.where["forced"]
    assert all(math.isfinite(v) for v in forced.values())
    assert len(tr.where["widest_rows"]) == min(10, len(tr.where["row_gaps"]))
    assert tr.where["row_margin_p50"] >= 0


def test_the_reference_forced_to_its_own_choice_is_itself(monkeypatch):
    file = tiny_config()
    port = file["port"]
    w = moe_lm.weights(port, 3, CPU)
    seqs = [torch.from_numpy(np.random.default_rng(3).integers(
        1, port["vocab"], 40))]
    wants = [torch.arange(40)]
    chosen = []
    route = ref.route

    def recorded(*args, **kw):
        out = route(*args, **kw)
        chosen.append(out[1])
        return out
    monkeypatch.setattr(ref, "route", recorded)
    (x,) = ref.forward(w, port, seqs, wants)
    monkeypatch.setattr(ref, "route", route)
    (forced,) = ref.forward(w, port, seqs, wants,
                            force=[torch.stack(chosen)])
    assert torch.equal(x, forced)


def test_the_parent_fails_at_set_up_without_the_maker(root, monkeypatch):
    """A program without ``make_ep32`` (the parent's) fails at set-up,
    before it makes a weight."""
    import repro_torch.configs.deepseek_v3_671b as mod
    monkeypatch.delattr(mod, "make_ep32")
    monkeypatch.setattr(moe_lm, "weights", None)
    file = json.loads((REPO / "perfbench" / "configs"
                       / "deepseek-v3-ep32.json").read_text())
    cell = {"config": file, "mix": spec.cell(REAL)["mix"]}
    tr = serve_moe.Traffic(cell, 1, CPU)
    with pytest.raises(AttributeError, match="make_ep32"):
        tr.setup()


class _Ev:
    def __init__(self, dev, corr, linked, start, dur=0):
        self.dev, self.corr, self.linked = dev, corr, linked
        self.start, self.dur = start, dur

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self.dev else DeviceType.CPU

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return self.linked

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.dur


def test_kernels_go_to_the_innermost_span_around_their_launch():
    from repro_torch.obs.profiling import Span
    spans = [Span("mla.decode", 100, 200, -1, 1),
             Span("moe.route", 300, 400, -1, 2),
             Span("moe.experts", 400, 500, -1, 2),
             Span("outer", 600, 900, -1, 3), Span("inner", 650, 700, 3, 3)]
    events = [_Ev(False, 1, 0, 150), _Ev(True, 0, 1, 10_000, 2_000_000),
              _Ev(False, 2, 0, 350), _Ev(True, 0, 2, 10_000, 1_000_000),
              _Ev(False, 3, 0, 450), _Ev(True, 0, 3, 10_000, 3_000_000),
              _Ev(False, 4, 0, 660), _Ev(True, 0, 4, 10_000, 4_000_000),
              _Ev(False, 5, 0, 800), _Ev(True, 0, 5, 10_000, 5_000_000),
              _Ev(False, 6, 0, 950), _Ev(True, 0, 6, 10_000, 6_000_000),
              _Ev(True, 0, 99, 10_000, 7_000_000)]
    got = serve_moe._device_ms_by_span(events, spans, 2)
    assert got == {"mla.decode": 1.0, "moe.route": 0.5,
                   "moe.experts": 1.5, "inner": 2.0, "outer": 2.5}


def _reader(name):
    return spec.reader(name)


def test_the_readers():
    cfg = json.loads((REPO / "perfbench" / "configs"
                      / "deepseek-v3-ep32.json").read_text())
    work = {"prefills": [4096, 2048],
            "span_device_ms": {"mla.decode": 120.0, "moe.route": 2.0,
                               "moe.experts": 3.0, "moe.shared": 1.5},
            "counts_per_step": {"moe.routed": 9984.0, "moe.held": 312.0}}
    bound = sum(s for b in (4096, 2048)
                for _, n, s in [counts.prefill_launches(cfg["port"], b)[0]]
                for _ in range(n))
    trace = SimpleNamespace(kernels=[
        ("void (anonymous namespace)::flash_mma_kernel<192, 128>(x)",
         4 * bound), ("void (anonymous namespace)::flash_mma_kernel<128, "
                      "128>(x)", 1.0)])
    ctx = SimpleNamespace(platform="gpu", trace=trace, work=work, config=cfg,
                          window={"seconds": 2.0, "step_ms": [1.0] * 19
                                  + [9.0]},
                          window_flops=989e12)
    assert _reader("flash_mla_roofline.serve_moe").read(ctx) \
        == pytest.approx(25.0)
    assert _reader("mla_decode_ms.serve_moe").read(ctx) == 120.0
    assert _reader("moe_ms.serve_moe").read(ctx) == 6.5
    assert _reader("held_expert_tokens.serve_moe").read(ctx) == 3.0
    assert _reader("mfu.serve").read(ctx) == pytest.approx(50.0)
    assert _reader("tpot_ms_p95.serve").read(ctx) \
        == pytest.approx(1.0 + 0.05 * 8.0)
    # nothing to read: the parent's program, or the CPU
    empty = SimpleNamespace(**{**vars(ctx), "work": {"prefills": []}})
    for name in ("flash_mla_roofline", "mla_decode_ms", "moe_ms",
                 "held_expert_tokens"):
        assert _reader(f"{name}.serve_moe").read(empty) is None
    cpu = SimpleNamespace(**{**vars(ctx), "platform": "cpu"})
    for name in ("flash_mla_roofline", "mla_decode_ms", "moe_ms"):
        assert _reader(f"{name}.serve_moe").read(cpu) is None
    assert _reader("mfu.serve").read(cpu) is None


def test_the_counts():
    port = json.loads((REPO / "perfbench" / "configs"
                       / "deepseek-v3-ep32.json").read_text())["port"]
    # one (192, 128) launch at 4096: 128 heads, 4096 * 4097 / 2 pairs
    pairs = 4096 * 4097 // 2
    assert counts.flash_bound_s(1, 4096, 4096, 128, 128, 192, 128) \
        == pytest.approx(2 * 320 * 128 * pairs / counts.BF16_FLOPS)
    launches = counts.prefill_launches(port, 4096)
    assert [(k, n) for k, n, _ in launches] == [("flash_mla", 16)]
    body, per_key = counts.decode_token(port)
    # per key and layer: scores over latent + rope, the latent's sum
    assert per_key == 16 * (2 * 128 * (512 + 64) + 2 * 128 * 512)
    mla_proj = 2 * (7168 * 1536 + 1536 * 128 * 192 + 7168 * 576
                    + 128 * 128 * 7168)
    absorb = 2 * 128 * 512 * 256
    ffn = 3 * 6 * 7168 * 18432 + 13 * (2 * 7168 * 256 + 6 * 7168 * 2048
                                       * (1 + 8 * 8 / 256))
    assert body == pytest.approx(16 * (mla_proj + absorb) + ffn)
    assert counts.head_flops(port) == 2 * 7168 * 129280
    L = 100
    expand = 2 * 512 * 128 * 256
    want = L * (16 * (mla_proj + expand) + ffn) \
        + 16 * 2 * 128 * 320 * L * (L + 1) // 2 + 2 * 7168 * 129280
    assert counts.prompt_flops(port, L) == pytest.approx(want)
