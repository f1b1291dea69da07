"""``flash_attention``'s share of its roofline in the traced stretch's
prefills: the least time of each launch at its shape (1, bucket, 32, 8, 128
for qwen3-4b; ``counts/lm.py``) summed, over the device time of the
kernels named in ``NAMES``.  Decode's attention is not this kernel."""
from perfbench.counts import lm
from perfbench.lib import readers

NAMES = ("flash_mma_kernel", "flash_simt_kernel")


def read(ctx):
    bound = sum(n * s for b in ctx.work["prefills"]
                for k, n, s in lm.prefill_launches(ctx.config["port"], b)
                if k == "flash_attention")
    t = readers.kernel_seconds(ctx, NAMES) if ctx.platform == "gpu" else 0
    return 100.0 * bound / t if t > 0 and bound > 0 else None
