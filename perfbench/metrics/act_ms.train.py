"""Host ms a slot in acting: the ``t2drl.act`` spans (the stacked acting
chain, exploration noise and amender for all B cells) and the frame's
``t2drl.cacher_act``, over the traced episode's slots."""
from perfbench.lib import spans


def read(ctx):
    return spans.ms_per(ctx, ("t2drl.act", "t2drl.cacher_act"), "slots")
