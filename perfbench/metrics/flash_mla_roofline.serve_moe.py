"""``flash_attention``'s share of its roofline at MLA's head pair in the
traced stretch's prefills: the least time of each launch at (1, bucket,
128, 128, (192, 128)) (``counts/moe_lm.py``) summed, over the device time
of the kernels named in ``NAMES``.  Decode's attention is not this
kernel."""
from perfbench.counts import moe_lm
from perfbench.lib import readers

NAMES = ("flash_mma_kernel<192", "flash_simt_kernel<float, 192")


def read(ctx):
    bound = sum(n * s for b in ctx.work["prefills"]
                for k, n, s in moe_lm.prefill_launches(ctx.config["port"], b)
                if k == "flash_mla")
    t = readers.kernel_seconds(ctx, NAMES) if ctx.platform == "gpu" else 0
    return 100.0 * bound / t if t > 0 and bound > 0 else None
