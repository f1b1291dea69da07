"""The output check at a tiny size on the CPU: sound runs pass, the
control (the reference in TF32 in the program's place) fails some
number of each cell, and so does a run with each planted fault."""
import contextlib
import sys
import time

import pytest
import torch

from perfbench.lib import check, faults, runner
from perfbench.tests.tiny import REPO, TINY_CELLS, tiny_copy

sys.path.insert(0, str(REPO / "src"))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("bench"))


def _readings(root, cell, seed, fault=None):
    torch.set_num_threads(1)
    c, d = runner.make_traffic(cell, seed, torch.device("cpu"),
                              root / "perfbench")
    with faults.planted(fault) if fault else contextlib.nullcontext():
        d.setup()
        d.window(0.1)
    d.free()
    return c["workload"]["limits"], d


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_the_control_fails_and_the_program_passes(root, cell):
    limits, d = _readings(root, cell, 2**31 + 3)
    assert check.verdict(d.readings(), limits)[0]
    ok, checks = check.verdict(d.readings(control=True), limits)
    assert not ok, checks


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
@pytest.mark.parametrize("fault", faults.FAULTS)
def test_a_run_with_a_planted_fault_is_not_correct(root, cell, fault):
    """The whole run, the chip's look skipped, with the timed path broken
    underneath."""
    torch.set_num_threads(1)
    with faults.planted(fault):
        out = runner.run_cell(cell, 2**31 + 11, 0.1, False,
                              torch.device("cpu"), time.perf_counter(),
                              root=root, pkg=root / "perfbench")
    assert out["correct"] is False, out["checks"]


def test_faults_leave_the_program_as_it_was():
    import repro_torch.core.t2drl as t2
    before = t2.env_step_slot
    with faults.planted("altered"):
        assert t2.env_step_slot is not before
    assert t2.env_step_slot is before
