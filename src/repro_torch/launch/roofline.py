"""Roofline terms of a step on the H100 (port of
``repro.launch.roofline``).

Three terms per step and chip, from H100 SXM constants (NVIDIA's data
sheet, dense, at the full 700 W power limit):

  compute    = FLOPs / (989 TFLOP/s bf16)
  memory     = bytes / (3.35 TB/s HBM3)
  collective = collective bytes / (900 GB/s NVLink)

The reference reads FLOPs and bytes from XLA's ``cost_analysis`` of the
compiled step; here ``step_cost`` counts them while the step runs:
FLOPs from ``torch.utils.flop_counter.FlopCounterMode`` (matrix
products, attention, convolutions), bytes as every dispatched op's
tensor inputs read once and outputs written once (XLA's "bytes
accessed" without fusion), views and other aliases counting none.
Collective bytes come from the partitioned HLO in the reference; their
counterpart, bytes counted from torch.distributed's collectives, comes
with the dry run (ROADMAP A.12 step 4), so ``coll`` is empty here.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.nn.core import count_params  # noqa: F401

# H100 SXM hardware constants (per chip)
PEAK_FLOPS = 989e12      # bf16, dense
HBM_BW = 3.35e12         # bytes/s
NVLINK_BW = 900e9        # bytes/s, NVLink 4 (the data sheet's figure)


@dataclasses.dataclass
class Roofline:
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: Optional[float] = None
    useful_ratio: Optional[float] = None

    def as_dict(self):
        return dataclasses.asdict(self)


def roofline(cost: dict, coll: Dict[str, float], *, chips: int,
             model_flops_total: Optional[float] = None) -> Roofline:
    """cost: per-chip {"flops", "bytes accessed"} (``step_cost``)."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    cb = float(coll.get("total", 0.0))
    terms = {"compute": flops / PEAK_FLOPS, "memory": byts / HBM_BW,
             "collective": cb / NVLINK_BW}
    mf = model_flops_total / chips if model_flops_total else None
    return Roofline(
        flops_per_chip=flops, bytes_per_chip=byts, coll_bytes_per_chip=cb,
        compute_s=terms["compute"], memory_s=terms["memory"],
        collective_s=terms["collective"],
        bottleneck=max(terms, key=terms.get), model_flops=mf,
        useful_ratio=(mf / flops if (mf and flops) else None))


class _ByteCounter(TorchDispatchMode):
    """Sums the bytes of every dispatched op's tensor inputs and outputs,
    except ops that only alias their input (views, ``detach``,
    ``unbind``, ``_unsafe_view``), which move no bytes."""

    ALIASES = (torch.ops.aten._unsafe_view.default,)

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func in self.ALIASES:
            return out
        for t in torch.utils._pytree.tree_leaves((args, kwargs, out)):
            if isinstance(t, torch.Tensor):
                self.bytes += t.numel() * t.element_size()
        return out


def step_cost(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once, counting its FLOPs and bytes.
    Returns (fn's result, {"flops", "bytes accessed"})."""
    flops = FlopCounterMode(display=False)
    byts = _ByteCounter()
    with flops, byts:
        out = fn(*args, **kwargs)
    return out, {"flops": float(flops.get_total_flops()),
                 "bytes accessed": float(byts.bytes)}


def model_flops(n_params_active: float, tokens: float,
                kind: str = "train") -> float:
    """MODEL_FLOPS = 6·N·D for training; 2·N·D for inference forward."""
    factor = 6.0 if kind == "train" else 2.0
    return factor * n_params_active * tokens


def active_fraction(cfg) -> float:
    """Active/total parameter fraction for MoE CompositeLM configs (1.0 for
    dense).  Routed expert params count as top_k/n_experts active."""
    try:
        groups = cfg.groups
    except AttributeError:
        return 1.0
    total = 0.0
    active = 0.0
    for g in groups:
        for b in g.cycle:
            d = b.d_model
            if b.mixer == "attn" and b.attn:
                a = b.attn
                w = d * (a.n_heads + 2 * a.n_kv_heads) * a.d_head \
                    + a.n_heads * a.d_head * d
            elif b.mixer == "mla" and b.mla:
                m = b.mla
                qd = m.qk_nope_dim + m.qk_rope_dim
                if m.q_lora_rank:
                    w = d * m.q_lora_rank + m.q_lora_rank * m.n_heads * qd
                else:
                    w = d * m.n_heads * qd
                w += d * (m.kv_lora_rank + m.qk_rope_dim)
                w += m.kv_lora_rank * m.n_heads * (m.qk_nope_dim
                                                   + m.v_head_dim)
                w += m.n_heads * m.v_head_dim * d
            elif b.mixer == "ssm" and b.ssm:
                s = b.ssm
                w = d * (2 * s.d_inner + 2 * s.n_groups * s.d_state
                         + s.n_heads) + s.d_inner * d
            else:
                w = 0.0
            n_rep = g.repeats if not b.shared else 1
            total += w * n_rep
            active += w * n_rep
            if b.ffn == "mlp" and b.mlp:
                f = 3 * d * b.mlp.d_ff if b.mlp.gated else 2 * d * b.mlp.d_ff
                total += f * n_rep
                active += f * n_rep
            elif b.ffn == "moe" and b.moe:
                mo = b.moe
                routed = 3 * d * mo.d_ff * mo.n_experts
                shared = 3 * d * mo.d_ff * mo.n_shared
                total += (routed + shared) * n_rep
                active += (routed * mo.top_k / mo.n_experts + shared) * n_rep
    if total == 0:
        return 1.0
    return active / total
