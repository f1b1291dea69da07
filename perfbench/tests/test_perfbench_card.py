"""On the card: the decision cells at their own size pass their check,
and the control fails it.  Skips where there is no card; run on the
card with ``python3 -m pytest -m cuda perfbench/tests``."""
import sys
import time

import pytest
import torch

from perfbench.lib import check, runner
from perfbench.tests.tiny import REPO

sys.path.insert(0, str(REPO / "src"))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["decide-table2-c4096",
                                  "decide-u18l10-c4096"])
def test_a_decision_cell_passes_and_its_control_fails(card, cell):
    out = runner.run_cell(cell, 2**31 + 99, 1.0, False, card,
                          time.perf_counter())
    assert out["correct"], out["checks"]
    c, d = runner.make_traffic(cell, 2**31 + 99, card)
    d.setup()
    d.window(1.0)
    d.free()
    assert not check.verdict(d.readings(control=True),
                             c["workload"]["limits"])[0]
