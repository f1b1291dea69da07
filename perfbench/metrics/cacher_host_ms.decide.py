"""The cacher's host time a frame decision: the median length of the
``t2drl.greedy_frame_cache`` span (the Q-net over C rows and its argmax,
``ddqn.act``, and the amender, ``ddqn.amend_caching``)."""
from perfbench.lib import spans


def read(ctx):
    sp = spans.of(ctx)
    return None if sp is None else spans.median(
        [cacher for frame, _, cacher, _ in sp.decisions if frame])
