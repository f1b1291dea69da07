"""Device ms a decode step of the kernels launched under the program's
``mla.decode`` spans (every layer's absorbed MLA decode over the latent
cache), from the generator's profiled decode steps (``work``'s
``span_device_ms``; none where the program has no such span)."""


def read(ctx):
    if ctx.platform != "gpu":
        return None
    return ctx.work.get("span_device_ms", {}).get("mla.decode")
