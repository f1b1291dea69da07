"""The reduction of the program's spans (``perfbench/lib/spans.py``) on
made-up spans and device intervals, its readers on a made-up reduction,
and a collection over a tiny decision cell on the CPU."""
import sys
from types import SimpleNamespace

import pytest
import torch

from perfbench.lib import runner, spans, spec
from perfbench.tests.tiny import REPO, tiny_copy

sys.path.insert(0, str(REPO / "src"))

from repro_torch.obs import profiling  # noqa: E402
from repro_torch.obs.profiling import Span  # noqa: E402

# two decisions: a frame decision (cacher root, then slot root) and a
# slot decision; ns on one clock
MADE_UP = [Span("t2drl.greedy_frame_cache", 0, 100, -1, 1),
           Span("ddqn.act", 10, 40, 0, 1),
           Span("ddqn.amend_caching", 50, 90, 0, 1),
           Span("t2drl.greedy_slot_action", 120, 300, -1, 2),
           Span("env.observe", 130, 150, 3, 2),
           Span("sampler.reverse_sample", 160, 260, 3, 2),
           Span("sampler.draws", 165, 200, 5, 2),
           Span("ops.ddpm_chain", 210, 250, 5, 2),
           Span("t2drl.greedy_slot_action", 400, 500, -1, 3)]


def test_self_times_are_lengths_less_the_childrens_union():
    ms = spans.self_ms(MADE_UP)
    want = [100 - 30 - 40, 30, 40, 180 - 20 - 100, 20, 100 - 35 - 40, 35,
            40, 100]
    assert ms == pytest.approx([w / 1e6 for w in want])


# the device is busy 0-20, 95-105, 140-205 and 290-600: gaps 20-95,
# 105-140 and 205-290
DEVICE = [(0, 20), (95, 105), (140, 180), (170, 205), (290, 600)]


def test_gaps_go_to_the_innermost_span_and_the_rest_outside():
    by_name, outside = spans.split_gaps(MADE_UP, DEVICE)
    assert by_name == {"ddqn.act": 20,                      # 20-40
                       "t2drl.greedy_frame_cache": 15,      # 40-50, 90-95
                       "ddqn.amend_caching": 40,            # 50-90
                       "t2drl.greedy_slot_action": 40,      # 120-130, 260-290
                       "env.observe": 10,                   # 130-140
                       "sampler.reverse_sample": 15,        # 205-210, 250-260
                       "ops.ddpm_chain": 40}                # 210-250
    assert outside == 15                                    # 105-120
    assert sum(by_name.values()) + outside == 75 + 35 + 85


def test_decisions_and_the_reduction():
    assert spans.decisions(MADE_UP) == [
        (True, 100 / 1e6 + 180 / 1e6, 100 / 1e6, 180 / 1e6),
        (False, 100 / 1e6, None, 100 / 1e6)]
    sp = spans.reduce(MADE_UP, 0, {"decisions": 2, "frame_decisions": 1},
                      MADE_UP, DEVICE, 4)
    row = sp.table["t2drl.greedy_slot_action"]
    assert row["n"] == 2 and row["total_ms"] == pytest.approx(280 / 1e6)
    assert row["self_ms_median"] == pytest.approx(80 / 1e6)
    # idle a unit of the profiled stretch's work (4 units, made up)
    assert row["idle_ms"] == pytest.approx(40 / 1e6 / 4)
    assert sp.idle_in_program_ms == pytest.approx(180 / 1e6 / 4)
    assert sp.idle_outside_ms == pytest.approx(15 / 1e6 / 4)
    ctx = SimpleNamespace(platform="gpu", spans=sp)
    read = lambda name: spec.reader(name).read(ctx)  # noqa: E731
    assert read("frame_host_ms.decide") == pytest.approx(280 / 1e6)
    assert read("cacher_host_ms.decide") == pytest.approx(100 / 1e6)
    assert read("slot_host_ms.decide") == pytest.approx(140 / 1e6)
    assert read("idle_in_program_ms.decide") == pytest.approx(45 / 1e6)
    # nothing is read off a CPU run or without spans
    for ctx in (SimpleNamespace(platform="cpu", spans=sp),
                SimpleNamespace(platform="gpu", spans=None),
                SimpleNamespace(platform="gpu")):
        assert spec.reader("frame_host_ms.decide").read(ctx) is None


def test_the_training_readers_per_slot():
    made = [Span("t2drl.act", 0, 10, -1, 1),
            Span("env.step_slot", 10, 16, -1, 2),
            Span("t2drl.slot_updates", 20, 60, -1, 3),
            Span("replay.sample", 20, 24, 2, 3),
            Span("d3pg.update_stacked", 24, 60, 2, 3),
            Span("replay.add", 60, 62, -1, 4),
            Span("t2drl.cacher_act", 70, 72, -1, 5),
            Span("t2drl.ddqn_updates", 80, 100, -1, 6),
            Span("replay.sample", 81, 83, 7, 6)]
    sp = spans.reduce(made, 0, {"slots": 2, "episodes": 1})
    ctx = SimpleNamespace(platform="gpu", spans=sp)
    got = {n: spec.reader(n).read(ctx) for n in
           ("act_ms.train", "env_step_ms.train", "replay_ms.train",
            "update_ms.train")}
    assert got == pytest.approx({"act_ms.train": 12 / 2e6,
                                 "env_step_ms.train": 6 / 2e6,
                                 "replay_ms.train": 8 / 2e6,
                                 "update_ms.train": 54 / 2e6})


def test_collect_over_a_tiny_decision_cell(tmp_path):
    """The window runs with the recorder off and leaves no span; the
    spans stretch then holds every layer's span, five stretches' worth,
    and the recorder is off again after it."""
    root = tiny_copy(tmp_path)
    torch.set_num_threads(1)
    cpu = torch.device("cpu")
    cell, traffic = runner.make_traffic("decide-tiny", 2**31 + 5, cpu,
                                        root / "perfbench")
    traffic.setup()
    traffic.window(0.1)
    run, work = traffic.stretch()
    sp = spans.collect(run, work, cpu)
    assert not profiling.ON
    assert sp.before == 0 and sp.dropped == 0
    n = 5 * work["decisions"]
    assert sp.units == {"decisions": n,
                        "frame_decisions": 5 * work["frame_decisions"]}
    assert sp.table["t2drl.greedy_slot_action"]["n"] == n
    assert sp.table["ops.ddpm_chain"]["n"] == n
    assert len(sp.decisions) == n
    # the window ends at a frame's end: 30 decisions from a frame's first
    frames = -(-n // traffic.K)
    assert sum(f for f, *_ in sp.decisions) == frames
    assert sp.table["ddqn.act"]["n"] == frames
    assert sp.idle_in_program_ms == 0.0     # no device intervals here
    line = spans.line(sp, spans.builds())
    assert line["builds"] == 0 and line["before"] == 0
    assert set(line["names"]) >= {"env.observe", "sampler.draws",
                                  "d3pg.amend_actions"}
    traffic.free()


def test_collect_reads_nothing_without_the_recorder(monkeypatch):
    monkeypatch.setattr(spans, "recorder", lambda: None)
    assert spans.collect(lambda: None, {"decisions": 1},
                         torch.device("cpu")) is None
    assert spans.line(None, 0)["recorder"] is False
