"""``ddpm_chain``'s share of its roofline in training: the least time of
the chains' work (each slot's acting chain over one row a learner; each
update's target chain and recording policy chain over the minibatch),
over the device time of the kernels named in ``NAMES``."""
from perfbench import counts
from perfbench.lib import readers

NAMES = ("ddpm_chain_kernel",)


def read(ctx):
    n, w = counts.nets_of(ctx.config), ctx.work
    B = w["learners"]
    works = [(w["slots"], counts.chain_fwd(n.actor, n.S, 1, n.L) * B),
             (w["updates"], counts.chain_fwd(n.actor, n.S, n.batch, n.L) * B),
             (w["updates"], counts.chain_fwd(n.actor, n.S, n.batch, n.L,
                                             record=True) * B)]
    return readers.roofline(ctx, NAMES, works)
