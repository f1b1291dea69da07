"""Device ms a decode step of the kernels launched under the program's
``moe.*`` spans (the router, the held experts' dispatch, products and
combine, the shared expert), from the generator's profiled decode steps
(``work``'s ``span_device_ms``; none where the program has no such
span)."""


def read(ctx):
    if ctx.platform != "gpu":
        return None
    ms = [v for k, v in ctx.work.get("span_device_ms", {}).items()
          if k.startswith("moe.")]
    return sum(ms) if ms else None
