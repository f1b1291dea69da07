"""Tokens a held expert takes a decode step in one MoE layer: the
program's ``moe.held`` counter (assignments that reached a held expert,
summed on the device over the generator's profiled decode steps) a step,
over the MoE layers and the experts held.  A uniform router gives
``max_batch * top_k / n_experts`` (96 * 8 / 256 = 3)."""


def read(ctx):
    held = ctx.work.get("counts_per_step", {}).get("moe.held")
    if held is None:
        return None
    port = ctx.config["port"]
    return held / (port["moe_layers"] * port["moe"]["n_held"])
