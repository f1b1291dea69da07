"""Faults planted in an MLA/MoE program (DeepSeek-V3's), beside those of
``lib/faults.py``, to show that the output check fails them:

- ``v2_router``: DeepSeek-V2's router in the published one's place:
  softmax scores, no correction bias, no groups, the weights
  renormalised but not scaled by ``routed_scaling``;
- ``no_mscale``: YaRN's mscale^2 left out of MLA's softmax scale (the
  rope's frequencies stay stretched), in prefill and decode.

``calibrate_moe.py --fault <name>`` plants one; the benchmark's own runs
plant none.
"""
from __future__ import annotations

import dataclasses
import math

FAULTS = ("v2_router", "no_mscale")


def _v2_router(fn):
    def route(xt, router, cfg):
        v2 = dataclasses.replace(cfg, score_func="softmax",
                                 score_correction=False, n_group=1,
                                 topk_group=1, routed_scaling=1.0)
        return fn(xt, router, v2)
    return route


def _no_mscale(fn):
    def scale(cfg):
        return 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    return scale


SITES = {
    "v2_router": (("repro_torch.nn.moe", "_route", _v2_router),),
    "no_mscale": (("repro_torch.nn.mla", "_scale", _no_mscale),),
}
