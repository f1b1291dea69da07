"""The operation and byte counts against hand arithmetic and against the
chain bounds that PERF.md's kernel table lists."""
import pytest

from perfbench import counts as c
from perfbench.lib import spec

CTRL = (86, 128, 128, 128, 20)        # Table 2's denoiser, S = 50


def test_chain_by_hand_at_a_small_shape():
    # widths (A + S + T, h, A) = (2 + 3 + 16, 4, 2), R = 3 rows, L = 2
    dims, S, R, L = (21, 4, 2), 3, 3, 2
    step = (2 * (2 + 16) * 4 + 4) + (2 * 4 * 2 + 2) + 5 * 2
    assert c.chain_fwd(dims, S, R, L).flops == R * (2 * S * 4 + L * step)
    weights = 21 * 4 + 4 + 4 * 2 + 2
    assert c.chain_fwd(dims, S, R, L).nbytes == 4 * (
        weights + 2 * R * 2 + R * S + L * R * 2 + L * (3 + 16))
    rec = c.chain_fwd(dims, S, R, L, record=True).nbytes
    assert rec - c.chain_fwd(dims, S, R, L).nbytes == 4 * L * R * (2 + 4)
    bstep = 2 + (2 * 21 * 4 + 4) + (2 * 4 * 2 + 2) + 2 * 4 * 2
    assert c.chain_bwd(dims, S, R, L).flops == R * (
        L * bstep + (L - 1) * (2 * 2 * 4 + 2 * 2))


def test_mlp_adam_and_soft_update_by_hand():
    dims, R = (3, 5, 2), 7
    assert c.n_params(dims) == 3 * 5 + 5 + 5 * 2 + 2
    assert c.mlp_fwd(dims, R).flops == R * ((2 * 15 + 5) + (2 * 10 + 2))
    assert c.mlp_bwd(dims, R).flops == R * ((2 * 15 + 5) + (2 * 10 + 2)
                                            + 2 * 10)
    assert c.mlp_bwd(dims, R, weights=False, inputs=True).flops == \
        R * (2 * 15 + 2 * 10)
    assert c.adam(10) == c.Work(160, 280)
    assert c.soft_update(10) == c.Work(30, 120)


@pytest.mark.parametrize("work, B, ms, by", [
    ("fwd", 1, 3.96e-4, "operations"),      # R = 64
    ("fwd", 8, 0.003169, "operations"),     # B = 8 learners, R = 64
    ("bwd", 8, 0.006415, "operations"),
    ("fwd1", 1, 5.61e-5, "bytes"),          # the control's R = 1 chain
])
def test_chain_bounds_match_the_kernel_table(work, B, ms, by):
    w = {"fwd": c.chain_fwd(CTRL, 50, 64, 5),
         "bwd": c.chain_bwd(CTRL, 50, 64, 5),
         "fwd1": c.chain_fwd(CTRL, 50, 1, 5)}[work] * B
    seconds, bound_by = c.bound_s(w)
    assert seconds * 1e3 == pytest.approx(ms, rel=2e-3)
    assert bound_by == by


def test_widths_of_the_configurations():
    n = c.nets_of(spec.cell("train-u18l10-b64")["config"])
    assert (n.S, n.A, n.L) == (82, 36, 10)
    assert n.actor == (134, 128, 128, 128, 36)
    assert n.critic == (118, 256, 256, 1)
    assert n.qnet == (3, 128, 128, 1024)


def test_update_scales_with_the_minibatch_chains():
    n = c.nets_of(spec.cell("train-table2-b64")["config"])
    u = c.d3pg_update(n)
    chains = (c.chain_fwd(n.actor, n.S, 64, 5) * 1
              + c.chain_fwd(n.actor, n.S, 64, 5, record=True)
              + c.chain_bwd(n.actor, n.S, 64, 5))
    assert chains.flops < u.flops < 2 * chains.flops
