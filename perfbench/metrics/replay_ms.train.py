"""Host ms a slot in the replay buffers: minibatch draws
(``replay.sample``, in the D3PG and the DDQN updates) and the frame's
write of its slot items (``replay.add``), over the traced episode's
slots."""
from perfbench.lib import spans


def read(ctx):
    return spans.ms_per(ctx, ("replay.sample", "replay.add"), "slots")
