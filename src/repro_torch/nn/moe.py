"""Mixture-of-Experts with shared experts and top-k routed experts
(DeepSeek-V2/V3 style), sort-based capacity dispatch; port of
``repro.nn.moe``'s global-scatter path.

The router's softmax picks each token's top-k experts, whose weights are
renormalised; the (token, expert) assignments are sorted by expert
(stably), ranked within their expert, and those past the capacity
(``_capacity``) go to a sentinel row, so they are dropped.  The kept rows
are scattered into a dense (E, capacity, D) buffer, the SwiGLU experts
run as batched products, and each token sums its experts' outputs times
their weights; shared experts are a dense SwiGLU added on top, and the
Switch-style load-balance loss comes back beside the output.  The
products are plain ``einsum``s, as the reference's are (no Pallas kernel
there).

The combine adds a token's k bf16 contributions one at a time
(``index_add_``), in an order that need not be XLA's, so the output
agrees with the reference to bf16 rounding, not bit for bit.

``route_rows=True`` routes each batch row on its own (its own capacity
and sort), what the reference gives when it maps a one-row call over the
rows, as its serving engine maps its decode step.  The expert-parallel
mesh path (the reference's ``dispatch="shardmap"`` under a mesh) is
multi-device work: with a ``mesh`` it raises; without one, ``"shardmap"``
falls through to this path, as the reference's does.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .core import silu
from .mlp import MLPCfg, mlp_apply, mlp_init

_MESH_TODO = ("the expert-parallel MoE dispatch over a device mesh is not "
              "ported yet (ROADMAP A.12: multi-device)")


@dataclasses.dataclass(frozen=True)
class MoECfg:
    d_model: int
    d_ff: int                      # per routed expert
    n_experts: int                 # routed experts
    top_k: int
    n_shared: int = 0              # shared experts (each of size d_ff)
    capacity_factor: float = 1.25
    aux_coef: float = 0.001
    router_dtype: object = torch.float32
    dispatch: str = "gspmd"        # "gspmd" | "shardmap" (mesh only)


def moe_init(generator: torch.Generator, cfg: MoECfg, *,
             dtype=torch.float32) -> dict:
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    dev = generator.device

    def normal(shape, std):
        return torch.randn(shape, generator=generator, device=dev) * std
    p = {"router": {"w": normal((d, E), 1.0 / math.sqrt(d))},
         "up": normal((E, d, f), 1.0 / math.sqrt(d)).to(dtype),
         "gate": normal((E, d, f), 1.0 / math.sqrt(d)).to(dtype),
         "down": normal((E, f, d), 1.0 / math.sqrt(f)).to(dtype)}
    if cfg.n_shared:
        p["shared"] = mlp_init(generator, _shared_cfg(cfg), dtype=dtype)
    return p


def _shared_cfg(cfg: MoECfg) -> MLPCfg:
    return MLPCfg(cfg.d_model, cfg.d_ff * cfg.n_shared)


def _capacity(T: int, cfg: MoECfg) -> int:
    cap = int(math.ceil(T * cfg.top_k * cfg.capacity_factor / cfg.n_experts))
    return max(cap, cfg.top_k)


def moe_apply(p, cfg: MoECfg, x, *, compute_dtype=torch.bfloat16,
              route_rows: bool = False, mesh=None):
    """x: (B, L, D) -> (y (B, L, D) in the compute dtype, aux loss f32).
    ``route_rows``: each of the B rows routed on its own (the aux loss is
    then the mean of the rows').  ``mesh`` stands where the reference
    reads ``current_mesh()``: the device mesh of an expert-parallel run.
    The port has no mesh until ROADMAP A.12, so it takes only ``None`` and
    refuses any other value naming that item."""
    if mesh is not None:
        raise NotImplementedError(_MESH_TODO)
    B, L, D = x.shape
    G = B if route_rows else 1          # routing groups
    T = B * L // G                      # tokens per group
    E, K = cfg.n_experts, cfg.top_k
    cap = _capacity(T, cfg)
    dev = x.device
    xt = x.reshape(G * T, D)

    logits = torch.matmul(xt.float(), p["router"]["w"].float())
    probs = torch.softmax(logits, dim=-1)                    # (G*T, E)
    w, ids = torch.topk(probs, K, dim=-1)                    # (G*T, K)
    w = w / (torch.sum(w, dim=-1, keepdim=True) + 1e-9)      # renormalise

    # flatten the assignments, each keyed by (group, expert), and sort
    group = torch.arange(G * T, device=dev) // T
    key = (ids + (group * E)[:, None]).reshape(-1)
    flat_w = w.reshape(-1)
    flat_tok = torch.arange(G * T, device=dev).repeat_interleave(K)
    order = torch.argsort(key, stable=True)
    e_sorted, t_sorted, w_sorted = key[order], flat_tok[order], flat_w[order]

    # rank of each assignment within its (group, expert); past the
    # capacity it goes to the sentinel row
    starts = torch.searchsorted(e_sorted, torch.arange(G * E, device=dev))
    rank = torch.arange(e_sorted.numel(), device=dev) - starts[e_sorted]
    keep = rank < cap
    n_slots = G * E * cap
    slot = torch.where(keep, e_sorted * cap + rank,
                       torch.full_like(rank, n_slots))

    # dispatch
    tok = xt[t_sorted].to(compute_dtype)
    tok = torch.where(keep[:, None], tok, torch.zeros_like(tok))
    buf = torch.zeros((n_slots + 1, D), dtype=compute_dtype, device=dev)
    buf.index_add_(0, slot, tok)
    h = buf[:n_slots].reshape(G, E, cap, D)

    # expert FFN (SwiGLU)
    up = torch.einsum("gecd,edf->gecf", h, p["up"].to(compute_dtype))
    gate = torch.einsum("gecd,edf->gecf", h, p["gate"].to(compute_dtype))
    out = torch.einsum("gecf,efd->gecd", silu(gate) * up,
                       p["down"].to(compute_dtype))

    # combine
    out_flat = torch.cat([out.reshape(n_slots, D),
                          torch.zeros((1, D), dtype=compute_dtype,
                                      device=dev)])
    contrib = out_flat[slot] * w_sorted[:, None].to(compute_dtype)
    y = torch.zeros((G * T, D), dtype=compute_dtype, device=dev)
    y.index_add_(0, t_sorted, contrib)
    y = y.reshape(B, L, D)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], _shared_cfg(cfg), x,
                          compute_dtype=compute_dtype)

    # Switch-style load balance, per group
    frac = torch.zeros(G * E, device=dev).index_add_(
        0, key, torch.ones_like(flat_w)).reshape(G, E) / (T * K)
    mean_prob = torch.mean(probs.reshape(G, T, E), dim=1)
    aux = cfg.aux_coef * E * torch.sum(frac * mean_prob, dim=-1)
    return y, torch.mean(aux)
