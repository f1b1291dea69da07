"""The 95th percentile of the measured window's times to first token:
from the end of the step that freed a request's slot (its arrival, in
the closed loop) until its first token is in host memory, the prefills
queued ahead of it included.  A per-layer reading here: in a loop that
keeps every slot busy, which requests queue behind another's prefill
follows the seed's order, and the tail swings with it."""
import numpy as np


def read(ctx):
    ttft = ctx.window["ttft_ms"]
    return float(np.percentile(ttft, 95)) if ttft else None
