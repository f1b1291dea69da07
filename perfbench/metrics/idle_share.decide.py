"""The device's idle share of the measured window: one minus the traced
device busy time per decision over the window's host time per decision."""
from perfbench.lib import readers


def read(ctx):
    return readers.idle_share(ctx, "decisions")
