"""The 95th percentile of the measured window's decode steps, each from
the call into ``Engine.step`` until its tokens are in host memory: the
time per output token of every busy slot."""
import numpy as np


def read(ctx):
    return float(np.percentile(ctx.window["step_ms"], 95))
