"""``ddpm_chain``'s share of its roofline in the controller's decisions:
the least time of one chain over all C cells' rows a decision, over the
device time of the kernels named in ``NAMES``."""
from perfbench import counts
from perfbench.lib import readers

NAMES = ("ddpm_chain_kernel",)


def read(ctx):
    n, w = counts.nets_of(ctx.config), ctx.work
    works = [(w["decisions"], counts.slot_decision(n, w["cells"]))]
    return readers.roofline(ctx, NAMES, works)
