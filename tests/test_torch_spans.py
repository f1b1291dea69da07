"""The span recorder (``repro_torch.obs.profiling``) and the spans at the
decision and training paths' layer boundaries, on the CPU at a tiny size:
off it records nothing and changes no output; on, the spans nest as the
layers do, the buffer is bounded, and the spans lie on the clock of
``torch.profiler``'s events."""
import json
import time

import pytest
import torch

from repro_torch.core import env as tenv
from repro_torch.core import t2drl as tt2
from repro_torch.obs import profiling

torch.set_num_threads(1)

CFG = tt2.T2DRLCfg(env=tenv.EnvCfg(U=3, M=4, T=2, K=2), L=2, warmup=2)

# (name, parent's name) of one frame decision then one slot decision
DECISION = [("t2drl.greedy_frame_cache", None),
            ("ddqn.act", "t2drl.greedy_frame_cache"),
            ("ddqn.amend_caching", "t2drl.greedy_frame_cache"),
            ("t2drl.greedy_slot_action", None),
            ("env.observe", "t2drl.greedy_slot_action"),
            ("sampler.reverse_sample", "t2drl.greedy_slot_action"),
            ("sampler.draws", "sampler.reverse_sample"),
            ("ops.ddpm_chain", "sampler.reverse_sample"),
            ("d3pg.amend_actions", "t2drl.greedy_slot_action")]


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.take()
    yield
    profiling.take()


def _decide(cells: int = 8, seed: int = 3):
    """One frame decision and one slot decision for ``cells`` cells."""
    g = torch.Generator().manual_seed(seed)
    policy = tt2.policy_init(CFG, seed, device="cpu")
    models = tenv.make_models(g, CFG.env)
    env = tenv.env_reset_batch([torch.Generator().manual_seed(seed + c)
                                for c in range(cells)], CFG.env)
    env = tenv.env_advance_frame(env, CFG.env)
    rho = tt2.greedy_frame_cache(policy, CFG, models, env.gamma_idx, g)
    env = tenv.env_set_cache(env, rho)
    b, xi = tt2.greedy_slot_action(policy, CFG, env, models, g)
    return rho, b, xi, g.get_state()


def test_off_records_nothing_and_on_changes_no_output():
    assert not profiling.ON
    off = _decide()
    assert profiling.take() == ([], 0)
    with profiling.recording():
        on = _decide()
    assert not profiling.ON
    for a, b in zip(off, on):
        assert torch.equal(a, b)       # outputs and the generator's state
    assert len(profiling.take().spans) == len(DECISION)


def test_decision_spans_nest_as_the_layers():
    with profiling.recording():
        _decide()
    log = profiling.take()
    assert log.dropped == 0
    spans = log.spans
    got = [(s.name, spans[s.parent].name if s.parent >= 0 else None)
           for s in spans]
    assert got == DECISION
    roots = [s for s in spans if s.parent < 0]
    assert len({s.trace for s in roots}) == 2
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert s.trace == p.trace
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    # roots come one after the other on the host's one thread
    assert roots[0].end_ns <= roots[1].start_ns


def test_the_buffer_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "CAPACITY", 3)
    with profiling.recording():
        with profiling.span("a"):
            with profiling.span("b"):
                pass
        with profiling.span("c"):
            with profiling.span("d"):       # the buffer is full: dropped
                pass
        with profiling.span("e"):
            pass
        with pytest.raises(RuntimeError, match="open"):
            with profiling.span("f"):
                profiling.take()
    log = profiling.take()
    assert [s.name for s in log.spans] == ["a", "b", "c"]
    assert [s.parent for s in log.spans] == [-1, 0, -1]
    assert [s.trace for s in log.spans] == [1, 1, 2]
    assert log.dropped == 3
    assert profiling.take() == ([], 0)


def test_spans_lie_on_the_profilers_clock():
    """Under a profile of the host's activity each span opens a
    ``record_function`` range of its name, which lies inside the span on
    the profiler's timeline to within 50 us."""
    from torch.profiler import ProfilerActivity, profile
    with profiling.recording():
        _decide()                      # warm the ops and record_function
        profiling.take()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _decide()
    spans = profiling.take().spans
    names = {n for n, _ in DECISION}
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in names:
            ranges.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    assert sorted(ranges) == sorted(names)
    slack = 50_000
    for s in spans:
        r0, r1 = ranges[s.name].pop(0)
        assert s.start_ns - slack <= r0 and r1 <= s.end_ns + slack, \
            (s.name, r0 - s.start_ns, s.end_ns - r1)
    assert not any(ranges.values())


def test_training_spans_in_the_fused_episode():
    cfg = tt2.T2DRLCfg(env=tenv.EnvCfg(U=3, M=4, T=3, K=2), L=2, warmup=2)
    gens = tt2.cell_generators(5, 2, "cpu")
    ts = tt2.t2drl_init_batch(gens, cfg)
    steps = tt2._training_steps(cfg, 2)
    ts, _ = tt2._episode_core_fused(ts, cfg, gens, steps[0])
    with profiling.recording():
        ts, _ = tt2._episode_core_fused(ts, cfg, gens, steps[1])
    spans = profiling.take().spans
    parent = {}
    for s in spans:
        parent.setdefault(s.name, set()).add(
            spans[s.parent].name if s.parent >= 0 else None)
    T, K = cfg.env.T, cfg.env.K
    count = lambda n: sum(s.name == n for s in spans)  # noqa: E731
    assert count("t2drl.cacher_act") == T
    assert count("t2drl.act") == count("env.step_slot") == T * K
    assert count("replay.add") == T
    assert count("t2drl.ddqn_updates") == 1
    updates = count("t2drl.slot_updates")
    assert 0 < updates <= T * K
    assert count("d3pg.update_stacked") == updates * cfg.updates_per_slot
    for name in ("t2drl.cacher_act", "t2drl.act", "env.step_slot",
                 "t2drl.slot_updates", "replay.add", "t2drl.ddqn_updates"):
        assert parent[name] == {None}, name
    assert parent["d3pg.update_stacked"] == {"t2drl.slot_updates"}
    assert parent["replay.sample"] <= {"t2drl.slot_updates",
                                       "t2drl.ddqn_updates"}
    assert "t2drl.slot_updates" in parent["replay.sample"]


def test_stage_is_a_span_and_profiler_trace_carries_the_spans(tmp_path):
    with profiling.stage("probe", n=1) as info:
        time.sleep(0.001)
    assert info["n"] == 1 and info["wall_s"] >= 1e-3
    assert profiling.take().spans == []          # off: no span
    with profiling.recording():
        with profiling.stage("probe"):
            pass
    assert [s.name for s in profiling.take().spans] == ["probe"]
    with profiling.profiler_trace(str(tmp_path)) as prof:
        assert profiling.ON and prof is not None
        _decide()
    assert not profiling.ON                     # its state before
    assert len(profiling.take().spans) == len(DECISION)
    trace = json.loads((tmp_path / "trace.json").read_text())
    shown = {e.get("name") for e in trace["traceEvents"]}
    assert {n for n, _ in DECISION} <= shown


@pytest.mark.cuda
def test_a_span_contains_its_kernel_on_a_card_only_profile():
    """On the card: a span that launches a kernel of about 1 ms and
    synchronises contains that kernel's interval from a profile of the
    card's activity alone, to within 50 us."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run pytest -m cuda --noconftest "
                    "tests/test_torch_spans.py on the card")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profiling.recording(annotate=False):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                with profiling.span("sleep"):
                    torch.cuda._sleep(2_000_000)
                    torch.cuda.synchronize()
                time.sleep(0.002)
    spans = profiling.take().spans
    kernels = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == DeviceType.CUDA)
    assert len(spans) == len(kernels) == 5
    slack = 50_000
    for s, (k0, k1) in zip(spans, kernels):
        assert k1 - k0 > 300_000                   # a kernel of ~1 ms
        assert s.start_ns - slack <= k0 and k1 <= s.end_ns + slack, \
            (k0 - s.start_ns, s.end_ns - k1)
