"""The whole step's share of the card's bf16 dense peak: the model's
operations in the measured window (``perfbench/counts/lm.py``: each
prompt's own tokens, one token a busy slot a step; no padding, no idle
slot) over its host-clock length times 989 TFLOP/s."""
from perfbench.counts import lm


def read(ctx):
    if ctx.platform != "gpu":
        return None
    return 100.0 * ctx.window_flops / (ctx.window["seconds"]
                                       * lm.BF16_FLOPS)
