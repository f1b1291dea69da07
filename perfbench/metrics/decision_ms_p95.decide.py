"""The 95th percentile over every decision of the measured window of one
slot's decision for all C cells, on the host's clock: from the call into
the decision until (b, xi) are in host memory."""


def read(ctx):
    return ctx.window["ms_p95"]
