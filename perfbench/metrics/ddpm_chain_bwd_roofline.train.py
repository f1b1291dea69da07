"""``ddpm_chain_bwd``'s share of its roofline: the least time of each
update's chain gradient over the minibatch, over the device time of the
kernels named in ``NAMES`` (the backward and its cross-cluster sum)."""
from perfbench import counts
from perfbench.lib import readers

NAMES = ("ddpm_chain_bwd_kernel", "ddpm_chain_bwd_reduce_kernel")


def read(ctx):
    n, w = counts.nets_of(ctx.config), ctx.work
    works = [(w["updates"],
              counts.chain_bwd(n.actor, n.S, n.batch, n.L) * w["learners"])]
    return readers.roofline(ctx, NAMES, works)
