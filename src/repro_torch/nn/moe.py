"""Mixture-of-Experts with shared experts and top-k routed experts
(DeepSeek-V2/V3 style), sort-based capacity dispatch; port of
``repro.nn.moe``: the global-scatter path and the expert-parallel one
(``moe_apply_shardmap``'s body, ``_local_dispatch_combine``).

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
rows, as its serving engine maps its decode step.

Expert parallelism: with ``dispatch="shardmap"`` and a current mesh
(``repro_torch.nn.sharding.use_mesh``) that has a ``"model"`` dimension
whose size n divides E, each rank (SPMD, one process a rank) holds only
its E/n expert slice: the experts are DTensors on ``P("model", None,
None)`` (``moe_spec``), and the rank takes its slice as the local shard,
as the reference's ``shard_map`` ``in_specs`` hand it over.  It routes
the tokens of its data shard (x on the batch axes; every rank of a
``"model"`` group holds the same rows), dispatches them locally into the
full (E·cap, D) buffer, runs its experts, combines their contributions
and sums the (T, D) outputs over the ``"model"`` group in one
``all_reduce``; the aux loss is averaged over the whole mesh.  Under
autograd the tokens' and the router's gradients are summed over the
``"model"`` group (each rank's is its experts' part), and an expert
slice's gradient stays on its rank.  Plain tensors under a mesh must
already be this rank's slice (``expert_slice`` cuts a whole tree); a
tree whose expert leaves hold another number of experts is refused.
Without a mesh ``"shardmap"`` falls through to the global path, as the
reference's does; the global path is the same code with every expert
local and no collective.

The global path (``"gspmd"``) under a mesh keeps the reference's
``constrain``s of the dispatch buffer and the experts' output on
``P("model", None, None)``: the routing and the combine run on the
tokens gathered whole on every rank (local code between those
boundaries), the experts as DTensor products on the rank's slice.

The router's options (defaults: the softmax router above) give
DeepSeek-V3's published one (``topk_method: noaux_tc``): sigmoid scores
(``score_func``); a per-expert correction (``score_correction``: the
router's ``"correction"`` leaf, the release's ``e_score_correction_bias``)
added for the selection only; group-limited selection over ``n_group``
groups of experts, a group scored by the sum of its two best corrected
scores (by its best where there is no correction), the best
``topk_group`` groups kept and the top-k experts chosen among theirs;
the weights the chosen experts' uncorrected scores, renormalised, times
``routed_scaling``.

The expert share (``n_held`` > 0): this device holds experts
[``first_expert``, ``first_expert + n_held``) of ``n_experts``, as one
chip of an expert-parallel deployment does, without a mesh.  The router
keeps its ``n_experts`` outputs and routes every token over all of them;
assignments to experts not held contribute nothing, the held experts
compute their part, and the shared experts run for every token.  The
share path is dropless, with no capacity.  Up to
``SHARE_DENSE_MAX_TOKENS`` tokens (a decode step's), every held expert
runs on every token and each token weights its output by the routing
weight it gave that expert (0 where it chose another): no sort, no
buffer and no read to the host, at the price of products over rows the
step reads the held weights for anyway.  Above it (a prefill), the
assignments to held experts are sorted by expert into a buffer (n_held,
rows, D) sized by the held experts' counts, which the layer reads to
the host once (its one synchronise).  It returns no load-balance loss
(DeepSeek-V3 is trained without one).  Spans (``obs.profiling``):
``moe.route``, ``moe.experts`` (dispatch, the held experts' products,
combine) and ``moe.shared``; counters ``moe.routed`` (assignments) and
``moe.held`` (those that reached a held expert, on the device).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.obs import profiling

from .core import silu
from .mlp import MLPCfg, mlp_apply, mlp_init, mlp_spec
from .sharding import (P, Region, batch_spec, constrain, current_mesh,
                       is_dtensor)


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
    dispatch: str = "gspmd"        # "gspmd" | "shardmap" (expert-parallel
    # under a mesh; the global path without one)
    score_func: str = "softmax"    # "softmax" | "sigmoid"
    score_correction: bool = False  # per-expert bias, for selection only
    n_group: int = 1               # group-limited routing: expert groups
    topk_group: int = 1            # groups kept per token
    routed_scaling: float = 1.0    # on the renormalised routed weights
    first_expert: int = 0          # the expert share: first expert held
    n_held: int = 0                # experts held (0: all, capacity path)


def moe_init(generator: torch.Generator, cfg: MoECfg, *,
             dtype=torch.float32) -> dict:
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    n = cfg.n_held or E
    dev = generator.device

    def normal(shape, std):
        return torch.randn(shape, generator=generator, device=dev) * std
    p = {"router": {"w": normal((d, E), 1.0 / math.sqrt(d))},
         "up": normal((n, d, f), 1.0 / math.sqrt(d)).to(dtype),
         "gate": normal((n, d, f), 1.0 / math.sqrt(d)).to(dtype),
         "down": normal((n, f, d), 1.0 / math.sqrt(f)).to(dtype)}
    if cfg.score_correction:
        p["router"]["correction"] = normal((E,), 0.1)
    if cfg.n_shared:
        p["shared"] = mlp_init(generator, _shared_cfg(cfg), dtype=dtype)
    return p


def moe_spec(cfg: MoECfg) -> dict:
    if cfg.n_held:
        raise ValueError("an expert share holds its own experts; it has "
                         "no mesh layout")
    s = {"router": {"w": P(None, None)},
         "up": P("model", None, None),
         "gate": P("model", None, None),
         "down": P("model", None, None)}
    if cfg.score_correction:
        s["router"]["correction"] = P(None)
    if cfg.n_shared:
        s["shared"] = mlp_spec(_shared_cfg(cfg))
    return s


def _shared_cfg(cfg: MoECfg) -> MLPCfg:
    return MLPCfg(cfg.d_model, cfg.d_ff * cfg.n_shared)


def _capacity(T: int, cfg: MoECfg) -> int:
    cap = int(math.ceil(T * cfg.top_k * cfg.capacity_factor / cfg.n_experts))
    return max(cap, cfg.top_k)


def _model_share(mesh, E: int) -> tuple:
    """(first expert, experts, ``"model"`` group) of this rank on
    ``mesh``."""
    names = mesh.mesh_dim_names or ()
    if "model" not in names:
        raise ValueError(f"the expert-parallel MoE needs a 'model' mesh "
                         f"dimension; this mesh has {names}")
    n = mesh["model"].size()
    if E % n:
        raise ValueError(f"{E} experts do not split over a 'model' "
                         f"dimension of {n}")
    e_loc = E // n
    return mesh.get_local_rank("model") * e_loc, e_loc, \
        mesh.get_group("model")


def expert_slice(tree, mesh):
    """``tree`` (plain tensors: a MoE layer's parameters, or a model's)
    with the expert leaves of every MoE in it cut to this rank's E/n
    experts on ``mesh``'s ``"model"`` dimension (copies, so the whole
    tree can be freed), as the expert-parallel path takes them."""
    if isinstance(tree, (list, tuple)):
        return type(tree)(expert_slice(v, mesh) for v in tree)
    if not isinstance(tree, dict):
        return tree
    if "router" not in tree:
        return {k: expert_slice(v, mesh) for k, v in tree.items()}
    d = tree["up"].dim() - 3                 # experts lead (E, ...) leaves
    e0, e_loc, _ = _model_share(mesh, tree["up"].shape[d])
    return {k: v.narrow(d, e0, e_loc).clone() if k in ("up", "gate", "down")
            else v for k, v in tree.items()}


def _all_reduce(t, group):
    """Sum ``t`` over ``group`` in place; a gloo group takes a host copy
    of a device tensor."""
    if t.device.type == "cpu" or dist.get_backend(group) != "gloo":
        dist.all_reduce(t, group=group)
        return t
    host = t.cpu()
    dist.all_reduce(host, group=group)
    return t.copy_(host)


class _ToModelGroup(torch.autograd.Function):
    """Identity forward; the gradient summed over the ``"model"`` group
    backward.  Marks a replicated tensor (the tokens, the router) entering
    the per-rank expert share, whose gradient on each rank is only its
    experts' part."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.group), None


class _SumModelGroup(torch.autograd.Function):
    """The experts' partial outputs summed over the ``"model"`` group
    forward; the gradient passed through backward (every rank holds the
    same downstream loss)."""

    @staticmethod
    def forward(ctx, t, group):
        return _all_reduce(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _MeshMean(torch.autograd.Function):
    """The mean over every rank of the mesh forward, 1/n of the gradient
    backward."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.n = mesh.size()
        t = t.clone()
        for name in mesh.mesh_dim_names:
            _all_reduce(t, mesh.get_group(name))
        return t / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def _expert_parallel_dtensor(p, cfg: MoECfg, x, mesh, compute_dtype,
                             route_rows):
    """The expert-parallel layer on DTensors: the shard_map's in_specs
    taken as local shards (tokens on the batch axes, the router whole,
    the experts on ``"model"``; ``Region`` gives the router's and the
    experts' local gradients as partial over the batch axes), the local
    body, and y back on the tokens' placements."""
    from torch.distributed.tensor import Replicate, Shard
    reg = Region(x)
    x_pl = constrain(x, batch_spec(None, None)).placements
    xl = reg.open(x, batch_spec(None, None))
    model = (mesh.mesh_dim_names or ()).index("model")
    local = {"router": {k: reg.take(t, P(*(None,) * t.dim()))
                        for k, t in p["router"].items()}}
    for k in ("up", "gate", "down"):
        w = constrain(p[k], P("model", None, None))
        if not isinstance(w.placements[model], Shard):
            raise ValueError(f"{cfg.n_experts} experts do not split over "
                             f"a 'model' dimension of {mesh.size(model)}")
        local[k] = reg.take(w)
    y, aux = _moe_local(local, cfg, xl, mesh, compute_dtype, route_rows)
    return reg.give(y, x_pl), reg.give(aux, (Replicate(),) * mesh.ndim)


def _gspmd_dtensor(p, cfg: MoECfg, x, mesh, compute_dtype, route_rows):
    """The global path under a mesh: routing, dispatch and combine on the
    tokens gathered whole (identical on every rank), the dispatch buffer
    and the experts' output crossing the reference's ``constrain`` on
    ``P("model", None, None)``, the experts as DTensor products."""
    from torch.distributed.tensor import Replicate
    repl = (Replicate(),) * mesh.ndim
    reg = Region(x)
    xl = reg.open(x, P(None, None, None))
    router = {k: reg.take(t, P(*(None,) * t.dim()))
              for k, t in p["router"].items()}

    def experts(h):
        h = constrain(reg.give(h, repl), P(None, "model", None, None))
        out = constrain(_expert_ffn(p, h, compute_dtype),
                        P(None, "model", None, None))
        return reg.take(out, P(None, None, None, None))

    y, aux = _route_dispatch_combine(xl, router, cfg, compute_dtype,
                                     route_rows, experts, 0, cfg.n_experts)
    y = reg.give(y.reshape(xl.shape[:2] + (-1,)), repl)
    return constrain(y, batch_spec(None, None)), reg.give(aux, repl)


def _expert_ffn(p, h, compute_dtype):
    """SwiGLU experts on the (G, E, cap, D) buffer ``h``."""
    w_up, w_gate, w_down = (p[k].to(compute_dtype)
                            for k in ("up", "gate", "down"))
    up = torch.einsum("gecd,edf->gecf", h, w_up)
    gate = torch.einsum("gecd,edf->gecf", h, w_gate)
    return torch.einsum("gecf,efd->gecd", silu(gate) * up, w_down)


def _route(xt, router: dict, cfg: MoECfg):
    """(weights (N, K) f32, expert ids (N, K), scores (N, E)) of the
    tokens ``xt`` (N, D) under the router's options (module
    docstring)."""
    logits = torch.matmul(xt.float(), router["w"].float())
    if cfg.score_func == "softmax":
        probs = torch.softmax(logits, dim=-1)                # (N, E)
    elif cfg.score_func == "sigmoid":
        probs = torch.sigmoid(logits)
    else:
        raise ValueError(f"score_func {cfg.score_func!r}")
    choice = probs
    if cfg.score_correction:
        choice = probs + router["correction"].float()
    if cfg.n_group > 1:
        g = choice.reshape(choice.shape[0], cfg.n_group, -1)
        score = (torch.topk(g, 2, dim=-1)[0].sum(dim=-1)
                 if cfg.score_correction else g.amax(dim=-1))
        kept = torch.topk(score, cfg.topk_group, dim=-1)[1]
        drop = torch.ones_like(score, dtype=torch.bool).scatter_(1, kept,
                                                                 False)
        choice = g.masked_fill(drop[..., None], -math.inf).flatten(1)
    ids = torch.topk(choice, cfg.top_k, dim=-1)[1]           # (N, K)
    w = torch.gather(probs, 1, ids)
    w = w / (torch.sum(w, dim=-1, keepdim=True) + 1e-9)      # renormalise
    if cfg.routed_scaling != 1.0:
        w = w * cfg.routed_scaling
    return w, ids, probs


def _route_dispatch_combine(xt3, router, cfg: MoECfg, compute_dtype,
                            route_rows, experts, e0: int, e_loc: int):
    """Route the (B, L, D) tokens ``xt3`` (plain tensors), dispatch every
    kept assignment into the full (G, E, cap, D) buffer, run
    ``experts(buffer)`` on experts [e0, e0 + e_loc) (its result (G,
    e_loc, cap, D)), and combine their contributions.  Returns (y (G·T,
    D) in the compute dtype, this rank's aux loss)."""
    B, L, D = xt3.shape
    G = B if route_rows else 1          # routing groups
    T = B * L // G                      # tokens per group
    E, K = cfg.n_experts, cfg.top_k
    cap = _capacity(T, cfg)
    dev = xt3.device
    xt = xt3.reshape(G * T, D)
    w, ids, probs = _route(xt, router, cfg)                  # (G*T, K)

    # flatten the assignments, each keyed by (group, expert), and sort
    group_of = torch.arange(G * T, device=dev) // T
    key = (ids + (group_of * E)[:, None]).reshape(-1)
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

    # dispatch every kept assignment into the full buffer
    tok = xt[t_sorted].to(compute_dtype)
    tok = torch.where(keep[:, None], tok, torch.zeros_like(tok))
    buf = torch.zeros((n_slots + 1, D), dtype=compute_dtype, device=dev)
    buf.index_add_(0, slot, tok)
    out = experts(buf[:n_slots].reshape(G, E, cap, D))

    # combine experts [e0, e0 + e_loc)'s contributions
    n_mine = G * e_loc * cap
    out_flat = torch.cat([out.reshape(n_mine, D),
                          torch.zeros((1, D), dtype=compute_dtype,
                                      device=dev)])
    e_of = e_sorted % E
    valid = keep & (e_of >= e0) & (e_of < e0 + e_loc)
    row = ((e_sorted // E) * e_loc + e_of - e0) * cap + rank
    row = torch.where(valid, row, torch.full_like(row, n_mine))
    w_mine = torch.where(valid, w_sorted, torch.zeros_like(w_sorted))
    contrib = out_flat[row] * w_mine[:, None].to(compute_dtype)
    y = torch.zeros((G * T, D), dtype=compute_dtype, device=dev)
    y.index_add_(0, t_sorted, contrib)

    # Switch-style load balance, per group
    frac = torch.zeros(G * E, device=dev).index_add_(
        0, key, torch.ones_like(flat_w)).reshape(G, E) / (T * K)
    mean_prob = torch.mean(probs.reshape(G, T, E), dim=1)
    aux = torch.mean(cfg.aux_coef * E * torch.sum(frac * mean_prob, dim=-1))
    return y, aux


def _moe_local(p, cfg: MoECfg, x, mesh, compute_dtype, route_rows):
    """The routed experts on plain tensors: the global path without a
    mesh; on a mesh, the expert-parallel body (``x`` this rank's rows,
    ``p``'s experts this rank's E/n slice).  Returns (y (B, L, D),
    aux)."""
    E = cfg.n_experts
    e0, e_loc, group = (0, E, None) if mesh is None else \
        _model_share(mesh, E)
    if p["up"].shape[0] != e_loc:
        raise ValueError(
            f"the expert leaves hold {p['up'].shape[0]} experts; this "
            f"rank's slice is {e_loc} of {E} (cut a whole tree with "
            "expert_slice, or pass DTensors)")
    xt, router = x, p["router"]
    if group is not None:
        xt = _ToModelGroup.apply(xt, group)
        router = {k: _ToModelGroup.apply(t, group) for k, t in router.items()}
    y, aux = _route_dispatch_combine(
        xt, router, cfg, compute_dtype, route_rows,
        lambda h: _expert_ffn(p, h[:, e0:e0 + e_loc], compute_dtype),
        e0, e_loc)
    if group is not None:
        y = _SumModelGroup.apply(y, group)
        aux = _MeshMean.apply(aux, mesh)
    return y.reshape(x.shape), aux


SHARE_DENSE_MAX_TOKENS = 256    # the share's dense path up to here


def _moe_share(p, cfg: MoECfg, x, compute_dtype):
    """The expert share's dropless routed part on plain tensors: (y (B,
    L, D) in the compute dtype, aux 0)."""
    B, L, D = x.shape
    N = B * L
    xt = x.reshape(N, D)
    K, n_held = cfg.top_k, cfg.n_held
    aux = x.new_zeros((), dtype=torch.float32)
    if p["up"].shape[0] != n_held:
        raise ValueError(f"the expert leaves hold {p['up'].shape[0]} "
                         f"experts; the share holds {n_held}")
    with profiling.span("moe.route"):
        w, ids, _ = _route(xt, p["router"], cfg)
        local = (ids - cfg.first_expert).reshape(-1)         # (N·K,)
        held = (local >= 0) & (local < n_held)
        key = torch.where(held, local, torch.full_like(local, n_held))
        profiling.count("moe.routed", key.numel())
        profiling.count("moe.held", held.sum())
    if N <= SHARE_DENSE_MAX_TOKENS:
        with profiling.span("moe.experts"):
            wm = torch.zeros((N, n_held + 1), device=x.device).scatter_add_(
                1, key.reshape(N, K), w)[:, :n_held]     # (N, n_held)
            h = xt.to(compute_dtype).expand(n_held, N, D)
            out = _expert_ffn(p, h[None], compute_dtype)[0]  # (e, N, D)
            y = torch.einsum("end,ne->nd", out, wm.to(compute_dtype))
        return y.reshape(B, L, D), aux
    counts = torch.bincount(key, minlength=n_held + 1)
    per = counts[:n_held].tolist()                           # the one read
    y = torch.zeros((N, D), dtype=compute_dtype, device=x.device)
    n, cap = sum(per), max(per)
    if n == 0:
        return y.reshape(B, L, D), aux
    with profiling.span("moe.experts"):
        order = torch.argsort(key, stable=True)[:n]          # held first
        e_sorted = key[order]
        starts = torch.cumsum(counts, 0) - counts
        slot = e_sorted * cap + torch.arange(n, device=x.device) \
            - starts[e_sorted]
        tok = order // K
        buf = torch.zeros((n_held * cap, D), dtype=compute_dtype,
                          device=x.device)
        buf[slot] = xt[tok].to(compute_dtype)
        out = _expert_ffn(p, buf.reshape(1, n_held, cap, D), compute_dtype)
        contrib = out.reshape(n_held * cap, D)[slot] \
            * w.reshape(-1)[order][:, None].to(compute_dtype)
        y.index_add_(0, tok, contrib)
    return y.reshape(B, L, D), aux


def moe_apply(p, cfg: MoECfg, x, *, compute_dtype=torch.bfloat16,
              route_rows: bool = False):
    """x: (B, L, D) -> (y (B, L, D) in the compute dtype, aux loss f32).
    ``route_rows``: each of the B rows routed on its own (the aux loss is
    then the mean of the rows').  With ``cfg.dispatch == "shardmap"``
    under a current mesh, the expert-parallel path (module docstring):
    ``x`` is this rank's data shard, or a DTensor, and ``y`` its rows.
    With ``cfg.n_held`` the expert share's dropless path (module
    docstring), where ``route_rows`` changes nothing; it takes no
    mesh."""
    mesh = current_mesh()
    if cfg.n_held:
        if mesh is not None or is_dtensor(x):
            raise ValueError("the expert share runs without a mesh")
        y, aux = _moe_share(p, cfg, x, compute_dtype)
    elif mesh is not None and is_dtensor(x):
        fn = (_expert_parallel_dtensor if cfg.dispatch == "shardmap"
              else _gspmd_dtensor)
        y, aux = fn(p, cfg, x, mesh, compute_dtype, route_rows)
    else:
        y, aux = _moe_local(p, cfg, x, mesh if cfg.dispatch == "shardmap"
                            else None, compute_dtype, route_rows)
    if "shared" in p:
        with profiling.span("moe.shared"):
            y = y + mlp_apply(p["shared"], _shared_cfg(cfg), x,
                              compute_dtype=compute_dtype)
    return y, aux
