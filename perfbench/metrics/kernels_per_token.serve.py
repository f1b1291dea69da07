"""Device kernels per token in the traced stretch: its decode steps'
and prefills' kernels (copies and fills left out) over the tokens they
produced."""
from perfbench.lib import readers


def read(ctx):
    return readers.per_unit(ctx, "tokens")
