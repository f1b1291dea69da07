"""Device kernels per cell-slot trained (the host's dispatch of the fused
episode core, the agents and the env's per-cell draws), from the traced
episode."""
from perfbench.lib import readers


def read(ctx):
    return readers.per_unit(ctx, "cell_slots")
