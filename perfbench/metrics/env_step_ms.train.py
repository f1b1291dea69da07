"""Host ms a slot in the env's slot step (``env.step_slot``: rates,
rewards and the per-cell draws of the next slot), over the traced
episode's slots."""
from perfbench.lib import spans


def read(ctx):
    return spans.ms_per(ctx, ("env.step_slot",), "slots")
