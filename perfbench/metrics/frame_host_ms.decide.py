"""The host time of a frame decision: the median, over the spans
stretch's frame decisions, of the host time their two roots cover
(``t2drl.greedy_frame_cache`` and the slot's
``t2drl.greedy_slot_action``).  The window's p95 falls among these
decisions."""
from perfbench.lib import spans


def read(ctx):
    sp = spans.of(ctx)
    return None if sp is None else spans.median(
        [host for frame, host, _, _ in sp.decisions if frame])
