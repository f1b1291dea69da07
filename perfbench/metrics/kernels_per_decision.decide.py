"""Device kernels per decision for all C cells (observe, the allocator,
the sampler and, at a frame's first slot, the cacher), from the traced
decisions."""
from perfbench.lib import readers


def read(ctx):
    return readers.per_unit(ctx, "decisions")
