"""The allocator's host time a decision: the median length of the
``t2drl.greedy_slot_action`` span over every decision (``env.observe``,
``sampler.reverse_sample`` with its draws and the ``ops.ddpm_chain``
launch, ``d3pg.amend_actions``)."""
from perfbench.lib import spans


def read(ctx):
    sp = spans.of(ctx)
    return None if sp is None else spans.median(
        [slot for _, _, _, slot in sp.decisions])
