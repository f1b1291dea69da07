"""Roofline terms of a step on the H100 (port of
``repro.launch.roofline``).

Three terms per step and chip, from H100 SXM constants (NVIDIA's data
sheet, dense, at the full 700 W power limit):

  compute    = FLOPs / (989 TFLOP/s bf16)
  memory     = bytes / (3.35 TB/s HBM3)
  collective = collective bytes / (900 GB/s NVLink)

The reference reads FLOPs and bytes from XLA's ``cost_analysis`` of the
compiled (partitioned) step; here ``step_cost`` counts them while the
step runs, in one ``TorchDispatchMode`` (``_StepCounter``): FLOPs from
``torch.utils.flop_counter``'s formulas (matrix products, attention,
convolutions; with no mesh the count is ``FlopCounterMode``'s), bytes
as every dispatched op's tensor inputs read once and outputs written
once (XLA's "bytes accessed" without fusion), views and other aliases
counting none.  On DTensors the mode lets DTensor
dispatch first (it returns ``NotImplemented`` to a DTensor op), so it
counts the local ops of this rank, per chip as the reference's
partitioned module is, and the collectives DTensor issues: the
``_c10d_functional`` all_reduce, all_gather_into_tensor,
reduce_scatter_tensor and all_to_all_single, each by its output's bytes,
which ``collective_bytes`` sums per kind with the reference's wire
factors, where the reference parses them out of the partitioned HLO.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.nn.core import count_params  # noqa: F401

# H100 SXM hardware constants (per chip)
PEAK_FLOPS = 989e12      # bf16, dense
HBM_BW = 3.35e12         # bytes/s
NVLINK_BW = 900e9        # bytes/s, NVLink 4 (the data sheet's figure)

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

# approximate wire-bytes factor per algorithm (ring), relative to the
# output bytes (the reference's)
_WIRE_FACTOR = {
    "all-gather": 1.0,        # each device receives (n-1)/n of the output
    "all-reduce": 2.0,        # reduce-scatter + all-gather
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

# torch's functional collectives by the reference's kinds
_C10D_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "permute_tensor": "collective-permute",
}


def collective_bytes(records) -> Dict[str, float]:
    """Sum the output bytes of each collective in ``records`` ((kind,
    bytes) pairs, as ``_StepCounter`` gathers them), keyed by kind;
    ``"total"`` applies the wire factors; ``"counts"`` the number of
    each kind."""
    out: Dict[str, float] = {k: 0.0 for k in COLLECTIVE_OPS}
    count: Dict[str, int] = {k: 0 for k in COLLECTIVE_OPS}
    for kind, nbytes in records:
        out[kind] += nbytes
        count[kind] += 1
    out["total"] = sum(out[k] * _WIRE_FACTOR[k] for k in COLLECTIVE_OPS)
    out["counts"] = count  # type: ignore[assignment]
    return out


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


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in torch.utils._pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class _StepCounter(TorchDispatchMode):
    """Counts, per dispatched op on plain tensors, its FLOPs (the flop
    counter's formulas), its bytes (tensor inputs and outputs, except ops
    that only alias their input: views, ``_unsafe_view``) and, for torch's
    functional collectives, (kind, output bytes) in ``collectives``.  A
    DTensor op is handed back to DTensor (``NotImplemented``), whose local
    ops and collectives come here in turn; so are the fake tensors its
    sharding propagation infers shapes on, which are not this rank's
    work."""

    ALIASES = (torch.ops.aten._unsafe_view.default,)

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        if any(issubclass(t, FakeTensor) for t in types):
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if func.namespace == "_c10d_functional":
            kind = _C10D_KINDS.get(packet.__name__)
            if kind is not None:
                self.collectives.append((kind, _tensor_bytes(out)))
            return out
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        if not (func.is_view or func in self.ALIASES):
            self.bytes += _tensor_bytes((args, kwargs, out))
        return out


def step_cost(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once, counting this rank's FLOPs and
    bytes and the collectives it issues.  Returns (fn's result, {"flops",
    "bytes accessed", "collectives": ``collective_bytes`` of them})."""
    counter = _StepCounter()
    with counter:
        out = fn(*args, **kwargs)
    return out, {"flops": float(counter.flops),
                 "bytes accessed": float(counter.bytes),
                 "collectives": collective_bytes(counter.collectives)}


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
