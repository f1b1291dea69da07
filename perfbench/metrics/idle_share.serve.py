"""The device's idle share of the measured window: one minus the traced
device busy time per token (decoded, or first from a prefill) over the
window's host time per token."""
from perfbench.lib import readers


def read(ctx):
    return readers.idle_share(ctx, "tokens")
