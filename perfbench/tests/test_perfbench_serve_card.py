"""On the card: the serving cell at its own size passes its check, and
the control and each planted fault fail it (a run's 51 s window for the
program and the control, 20 s with a fault planted).  Skips where there
is no card; run on the card with ``python3 -m pytest -m cuda
perfbench/tests``."""
import contextlib
import sys

import pytest
import torch

from perfbench.lib import check, faults, runner
from perfbench.tests.tiny import REPO

sys.path.insert(0, str(REPO / "src"))
CELL = "serve-qwen3-4b-chat-b28"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _readings(card, seed, fault=None):
    c, d = runner.make_traffic(CELL, seed, card)
    with faults.planted(fault) if fault else contextlib.nullcontext():
        d.setup()
        d.window(20.0 if fault else 51.0)
    d.free()
    return c["workload"]["limits"], d


@pytest.mark.cuda
def test_the_serving_cell_passes_and_its_control_fails(card):
    limits, d = _readings(card, 2**31 + 99)
    assert check.verdict(d.readings(), limits)[0]
    ok, checks = check.verdict(d.readings(control=True), limits)
    assert not ok, checks


@pytest.mark.cuda
@pytest.mark.parametrize("fault", faults.FAULTS)
def test_a_planted_fault_fails_the_serving_cell(card, fault):
    limits, d = _readings(card, 2**31 + 101, fault)
    ok, checks = check.verdict(d.readings(), limits)
    assert not ok, checks
