"""The whole step's share of the card's f32 peak: the operations of the
measured window's work (``perfbench.counts``) over its length."""
from perfbench.lib import readers


def read(ctx):
    return readers.mfu(ctx)
