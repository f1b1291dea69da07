"""Fleet-scale request-level serving twin (DESIGN.md §11), port of
``repro.fleet.twin``.

A trained (or restored) greedy policy serves C edge cells against Poisson
request traffic, and every request's latency is measured: one FIFO queue
per (cell, model), a Lindley recursion over its unfinished work W
(seconds), so the k-th same-tick arrival waits W + (k-1)·s; uncached
models take the cloud path (no edge queue); service and transmission
points per (cell, model) come from the policy's allocation each slot
through the env's ``slot_metrics``; arrivals follow the popularity
state's Zipf mix reshaped by the scenario schedule and the cell's active
users.  Counters stream into int32 totals and a fixed-bin latency
histogram; quantiles are recovered on the host.  See
``repro.fleet.twin`` for the model in full.

The reference nests scans over frames, slots and ticks, mapped over the
cells.  Here the C cells share one leading axis and only the queue
recursion is sequential:

- one trained policy serves the fleet, so a slot's allocation is one
  ``greedy_slot_action`` over the C cells' states (the diffusion actor:
  one ``ddpm_chain`` launch at R = C) and one batched env step;
- a slot's arrival rate is fixed across its ticks, so each cell draws its
  whole slot's (ticks, M) Poisson counts in one call;
- the recursion work -> room -> admitted -> work runs over the ticks on
  (C, M) tensors; every latency, histogram bin and counter of the slot is
  then one batched pass over (ticks, C, M, max_arrivals), with one
  ``scatter_add_`` into the (C, hist_bins) int32 histogram.

Counters are int32 and the latency and wait sums f32, as in the
reference.  Draws are the port's own: cell c draws from
``cell_generators(seed, C)[c]`` (the chain's x_L and noises, then its env
step, then its arrivals), so cell 0 of a fleet draws what a one-cell
fleet from the same seed draws; ``jax.random`` streams are not replayed.
``latency_quantiles``, ``_frame_series`` and ``summarize_fleet`` are the
reference's host-side numpy, copied.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.agents.base import FrameObs, SlotObs
from repro_torch.core.env import (MB_BITS, env_advance_frame, env_reset_batch,
                                  env_set_cache, env_step_slot,
                                  make_user_masks, masked_mean, radio_rates,
                                  schedule_frame_P, schedule_slot_mod,
                                  zipf_logits)
from repro_torch.core.quality import cloud_delay
from repro_torch.core.t2drl import (T2DRLCfg, _agents, _broadcast_mods,
                                    cell_generators, export_policy,
                                    greedy_slot_action)
from repro_torch.device import resolve_device
from repro_torch.diffusion.sampler import _draw_stacked

COUNT_KEYS = ("arrivals", "admitted", "dropped", "truncated", "slo_viol",
              "deadline_miss")


@dataclasses.dataclass(frozen=True)
class FleetCfg:
    """Static twin configuration; field for field the reference's
    ``FleetCfg`` (see ``repro.fleet.twin.FleetCfg``): ticks per slot,
    Poisson rate per active user (requests/s), the per-(cell, model, tick)
    arrival bound (truncations are counted), the queue capacity in
    requests, the latency SLO (s) and the histogram's bins on [0,
    hist_max) seconds (the last bin absorbs overflow)."""
    ticks_per_slot: int = 20
    arrivals_per_user_s: float = 0.01
    max_arrivals: int = 8
    queue_cap: float = 64.0
    slo: float = 40.0
    hist_bins: int = 256
    hist_max: float = 240.0


def _zipf_mix(gamma_idx, cfg):
    """(..., M) Zipf popularity mix of the current skewness state."""
    return torch.softmax(zipf_logits(gamma_idx, cfg), dim=-1)


def _slot_action(policy, tcfg: T2DRLCfg, env, models, gens, masks):
    """The fleet's greedy ``(b, xi)``, (C, U) each: the learned allocator
    over all C cells at once (the diffusion actor's chain draws x_L and
    noises per cell from the cell's generator, one ``ddpm_chain`` launch
    at R = C); SCHRS and RCARS through their per-cell-generator closure."""
    alloc, _ = _agents(tcfg)
    if not alloc.learns:
        return alloc.act_stacked({}, SlotObs(None, env, models, masks), gens,
                                 {})
    d3 = tcfg.d3pg_cfg()
    chain = {}
    if d3.actor_kind == "diffusion":
        x_L, noises = _draw_stacked(gens, (d3.action_dim,), d3.L,
                                    env.h.device)
        chain = {"x_L": x_L, "noises": noises.transpose(0, 1)}
    return greedy_slot_action(policy, tcfg, env, models, None, masks,
                              **chain)


def _frame_cache(policy, tcfg: T2DRLCfg, env, models, gens):
    """The fleet's greedy caching vectors (C, M): the DDQN's greedy over the
    C popularity states (draws nothing), a classical cacher's exported
    resident set in every cell, static/random caching per cell (random
    from the cell's generator)."""
    _, cacher = _agents(tcfg)
    obs = FrameObs(env.gamma_idx, models)
    C, M = models.c.shape
    if cacher.learns or cacher.step_frame is not None:
        return cacher.greedy(policy, obs).expand(C, M)
    return cacher.act_stacked({}, obs, gens, {"eps": 0.0})[1]


def _tick_recursion(work, n, serv, cached, fcfg: FleetCfg, dt: float):
    """The Lindley recursion over one slot's ticks: ``n`` (ticks, C, M)
    truncated arrivals; returns the backlog each tick starts from and the
    admitted counts, (ticks, C, M) each, and the backlog after the last
    tick (C, M)."""
    serv_c = torch.where(cached, serv, torch.zeros_like(serv))
    safe = torch.clamp_min(serv, 1e-6)
    works, adms = [], []
    for i in range(n.shape[0]):
        depth = work / safe
        room = torch.floor(torch.clamp_min(fcfg.queue_cap - depth, 0.0))
        adm = torch.where(cached, torch.minimum(n[i], room), n[i])
        works.append(work)
        adms.append(adm)
        work = torch.clamp_min(work + adm * serv_c - dt, 0.0)
    return torch.stack(works), torch.stack(adms), work


def _slot_pass(counts, hist, W, adm, n_raw, n, serv, trans, cached,
               fcfg: FleetCfg, tau: float):
    """Every latency, histogram bin and counter of one slot, in one pass
    over (ticks, C, M, A); adds into ``counts`` (int32 counters, f32 sums,
    (C,) each) and ``hist`` (C, bins) in place."""
    A = fcfg.max_arrivals
    k = torch.arange(1, A + 1, dtype=torch.float32, device=W.device)
    valid = k <= adm[..., None]                               # (T, C, M, A)
    wait = torch.where(cached[..., None],
                       W[..., None] + (k - 1.0) * serv[..., None],
                       torch.zeros((), device=W.device))
    lat = trans[..., None] + wait + serv[..., None]
    v = valid.to(torch.float32)
    idx = torch.clamp((lat / fcfg.hist_max * fcfg.hist_bins)
                      .to(torch.int32), 0, fcfg.hist_bins - 1)
    C = W.shape[1]
    hist.scatter_add_(1, idx.transpose(0, 1).reshape(C, -1).to(torch.int64),
                      valid.transpose(0, 1).reshape(C, -1)
                      .to(torch.int32))
    late = (trans + serv > tau).to(torch.float32)             # no queueing

    def add(key, x):                                          # integral x
        counts[key] += x.sum(dim=(0, 2)).to(torch.int32)

    add("arrivals", n.to(torch.int32))
    add("admitted", adm.to(torch.int32))
    add("dropped", torch.where(cached, n - adm,
                               torch.zeros((), device=W.device))
        .to(torch.int32))
    add("truncated", (n_raw - n).to(torch.int32))
    add("deadline_miss", (adm * late).to(torch.int32))
    counts["slo_viol"] += (valid & (lat > fcfg.slo)).sum(
        dim=(0, 2, 3)).to(torch.int32)
    counts["lat_sum"] += (v * lat).sum(dim=(0, 2, 3))
    counts["wait_sum"] += (v * wait).sum(dim=(0, 2, 3))


def fleet_run(policy, models, tcfg: T2DRLCfg, fcfg: FleetCfg, generators,
              masks=None, mods=None):
    """One episode horizon of request-level serving for C =
    ``len(generators)`` cells.

    ``policy`` (an ``export_policy`` dict) serves every cell; ``models``
    carries (C, M) leaves, ``masks`` an optional (C, U) active-user mask,
    ``mods`` an optional schedule with (C,)-leading leaves; cell c draws
    from ``generators[c]``.  Returns ``(counts, hist, curves, snaps)`` as
    the reference's ``fleet_run`` does, on the device: counters (C,)
    (int32, the sums f32, plus ``end_backlog``), the (C, hist_bins) int32
    histogram, ``{"backlog", "depth"}`` (C, T, K) per-slot curves, and
    per-frame cumulative ``{"counts", "hist"}`` snapshots leading with
    (C, T)."""
    ec = tcfg.env
    M, U, C = ec.M, ec.U, len(generators)
    dev = models.c.device
    dt = ec.tau / fcfg.ticks_per_slot
    gens = list(generators)
    n_active = (torch.full((C,), float(U), device=dev) if masks is None
                else torch.sum(masks, dim=-1))
    env = env_reset_batch(gens, ec, schedule_slot_mod(mods, 0))

    # cloud-fallback service point until a model is first observed: cloud
    # compute plus backhaul-inclusive transmission, radio legs at the equal
    # split over the reset slot's channel draws (the reference's comment)
    d_in_mean = 0.5 * (ec.d_in_mb[0] + ec.d_in_mb[1]) * MB_BITS
    r_up0, r_dw0 = radio_rates(env.h, torch.full((U,), 1.0 / U, device=dev),
                               ec)
    work = torch.zeros((C, M), device=dev)
    serv = cloud_delay(models.a3, models.b1, models.b2)
    trans = ((masked_mean(env.d_in / r_up0, masks) + d_in_mean / ec.r_bc)
             [:, None] + models.d_op * (masked_mean(1.0 / r_dw0, masks)
                                        + 1.0 / ec.r_cb)[:, None])
    counts = {k: torch.zeros(C, dtype=torch.int32, device=dev)
              for k in COUNT_KEYS}
    counts.update(lat_sum=torch.zeros(C, device=dev),
                  wait_sum=torch.zeros(C, device=dev))
    hist = torch.zeros((C, fcfg.hist_bins), dtype=torch.int32, device=dev)
    backlog, depth = [], []
    snaps = {"counts": [], "hist": []}

    for t in range(ec.T):
        env = env_advance_frame(env, ec, schedule_frame_P(mods, t),
                                schedule_slot_mod(mods, t * ec.K))
        env = env_set_cache(env, _frame_cache(policy, tcfg, env, models,
                                              gens))
        for k in range(ec.K):
            g = t * ec.K + k
            b, xi = _slot_action(policy, tcfg, env, models, gens, masks)
            env1, _, m = env_step_slot(env, ec, models, b, xi, masks,
                                       schedule_slot_mod(mods, g + 1))
            # per-model service point observed from this slot's allocation
            w = torch.nn.functional.one_hot(env.req, M).to(torch.float32)
            if masks is not None:
                w = w * masks[..., None]
            cnt = torch.sum(w, dim=-2)                        # (C, M)
            seen = cnt > 0
            safe = torch.clamp_min(cnt, 1.0)
            serv = torch.where(seen, torch.einsum(
                "cum,cu->cm", w, m["delay_gt"]) / safe, serv)
            trans = torch.where(seen, torch.einsum(
                "cum,cu->cm", w, m["delay_up"] + m["delay_dw"]) / safe,
                trans)
            # the slot's arrival mix: Zipf(gamma) reshaped by the scenario
            p = _zipf_mix(env.gamma_idx, ec)                  # (C, M)
            rate_scale = 1.0
            mod_g = schedule_slot_mod(mods, g)
            if mod_g is not None:
                bp = mod_g.burst_prob[..., None]
                hot = torch.nn.functional.one_hot(
                    mod_g.burst_model, M).to(torch.float32)
                p = (1.0 - bp) * p + bp * hot
                rate_scale = mod_g.din_scale
            rate = (fcfg.arrivals_per_user_s * n_active * rate_scale
                    * dt)[:, None] * p
            cached = env.rho > 0
            n_raw = torch.stack([
                torch.poisson(rate[c].expand(fcfg.ticks_per_slot, M)
                              .contiguous(), generator=gens[c])
                for c in range(C)], dim=1)                    # (T, C, M)
            n = torch.clamp_max(n_raw, float(fcfg.max_arrivals))
            W, adm, work = _tick_recursion(work, n, serv, cached, fcfg, dt)
            _slot_pass(counts, hist, W, adm, n_raw, n, serv, trans, cached,
                       fcfg, ec.tau)
            # depth: the deepest single queue, what queue_cap bounds
            backlog.append(torch.sum(work, dim=-1))
            depth.append(torch.amax(work / torch.clamp_min(serv, 1e-6),
                                    dim=-1))
            env = env1
        snaps["counts"].append({k: v.clone() for k, v in counts.items()})
        snaps["hist"].append(hist.clone())

    counts["end_backlog"] = torch.sum(work, dim=-1)
    curves = {"backlog": torch.stack(backlog, 1).reshape(C, ec.T, ec.K),
              "depth": torch.stack(depth, 1).reshape(C, ec.T, ec.K)}
    snaps = {"counts": {k: torch.stack([s[k] for s in snaps["counts"]], 1)
                        for k in snaps["counts"][0]},
             "hist": torch.stack(snaps["hist"], 1)}
    return counts, hist, curves, snaps


def _host(tree):
    """A tree of tensors as numpy (one copy per leaf)."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def latency_quantiles(hist, hist_max: float, qs: Sequence[float] = (0.5,
                      0.95, 0.99)):
    """Recover latency quantiles from a fixed-bin histogram (host-side).

    Linear interpolation inside the containing bin; a quantile landing in
    the overflow (last) bin is reported as ``hist_max``.  Returns
    ``{q: seconds}`` (NaN when the histogram is empty)."""
    hist = np.asarray(hist, np.float64)
    edges = np.linspace(0.0, hist_max, hist.size + 1)
    total = hist.sum()
    c = np.cumsum(hist)
    out = {}
    for q in qs:
        if total <= 0:
            out[q] = float("nan")
            continue
        target = q * total
        i = int(np.searchsorted(c, target))
        i = min(i, hist.size - 1)
        if i == hist.size - 1:
            out[q] = float(hist_max)
            continue
        prev = c[i - 1] if i > 0 else 0.0
        frac = (target - prev) / max(hist[i], 1e-12)
        out[q] = float(edges[i] + frac * (edges[i + 1] - edges[i]))
    return out


def simulate_fleet(ts, tcfg: T2DRLCfg, fcfg: FleetCfg = FleetCfg(), *,
                   num_cells: Optional[int] = None, seed: int = 0,
                   mods=None, user_counts: Optional[Sequence[int]] = None,
                   policy=None, cell: int = 0, writer=None, tags=None,
                   device=None):
    """Deploy a trained (or restored) policy against request-level traffic.

    ``ts`` is a train state from ``train_t2drl`` or
    ``repro_torch.checkpoint.load_train_state``, single or batched, on
    ``resolve_device(device)`` (the card unless ``device="cpu"``); only its
    model zoo and the exported policy are used.  An unbatched ``ts`` is
    replicated to ``num_cells`` cells (same zoo, independent traffic); a
    batched one fixes the fleet size to its cells.  ``seed`` seeds the
    cells' generators (``cell_generators``); ``mods`` a scenario schedule
    (the traffic trace, broadcast to the cells if unbatched);
    ``user_counts`` per-cell active users; ``policy`` a pre-exported
    policy; ``cell`` the learner of a batched independent state that
    serves the whole fleet; ``writer`` a ``MetricWriter`` receiving one
    ``fleet_frame`` record a frame and a ``fleet_summary``; ``tags``
    fields stamped on each record.  Returns the reference's metric dict
    (``summarize_fleet``, with ``"frames"``)."""
    dev = resolve_device(device)
    models = ts["models"]
    if models.c.device != dev:
        raise ValueError(f"the train state lies on {models.c.device}, "
                         f"not on {dev}")
    batched = models.a1.dim() == 2
    pol = export_policy(ts, tcfg, cell=cell) if policy is None else policy
    if batched:
        B = models.a1.shape[0]
        if num_cells is not None and num_cells != B:
            raise ValueError(f"ts is batched over {B} cells; "
                             f"num_cells={num_cells} does not match")
        num_cells = B
    else:
        num_cells = num_cells or 1
        models = type(models)(*(x.expand((num_cells,) + tuple(x.shape))
                                for x in models))
    masks = None
    if user_counts is not None:
        if len(user_counts) != num_cells:
            raise ValueError("user_counts must have one entry per cell")
        masks = make_user_masks(tcfg.env, user_counts).to(dev)
    mods = _broadcast_mods(mods, num_cells)
    gens = cell_generators(seed, num_cells, dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        run = fleet_run(pol, models, tcfg, fcfg, gens, masks, mods)
    counts, hist, curves, snaps = (_host(x) for x in run)
    wall = time.perf_counter() - t0
    out = summarize_fleet(counts, hist, curves, tcfg, fcfg, wall,
                          snaps=snaps)
    if writer is not None:
        tags = tags or {}
        writer.ensure_manifest(tcfg, extra={"fleet": dataclasses.asdict(fcfg),
                                            **tags}, device=dev)
        fr = out["frames"]
        for i in range(len(fr["frame"])):
            writer.write("fleet_frame",
                         **{k: v[i] for k, v in fr.items()}, **tags)
        skip = ("backlog_curve", "hist", "frames")
        writer.write("fleet_summary",
                     metrics={k: v for k, v in out.items()
                              if k not in skip}, **tags)
    return out


def _frame_series(snaps, curves, fcfg: FleetCfg):
    """Diff per-frame cumulative snapshots into fleet-level per-frame
    series (host-side NumPy).  ``snaps`` leaves lead with ``(C, T)``."""
    hist = np.asarray(snaps["hist"]).sum(axis=0)         # (T, bins) cumulative
    hist = np.diff(hist, axis=0, prepend=np.zeros((1, hist.shape[1])))
    cnt = {k: np.diff(np.asarray(v).sum(axis=0).astype(np.float64),
                      prepend=0.0)
           for k, v in snaps["counts"].items()}          # each (T,)
    backlog = np.asarray(curves["backlog"])              # (C, T, K)
    T = backlog.shape[1]
    out = {"frame": list(range(T)), "p50_s": [], "p95_s": [], "p99_s": [],
           "drop_rate": [], "slo_viol_rate": [], "mean_backlog_s": []}
    for t in range(T):
        q = latency_quantiles(hist[t], fcfg.hist_max)
        out["p50_s"].append(q[0.5])
        out["p95_s"].append(q[0.95])
        out["p99_s"].append(q[0.99])
        out["drop_rate"].append(
            float(cnt["dropped"][t] / max(cnt["arrivals"][t], 1.0)))
        out["slo_viol_rate"].append(
            float(cnt["slo_viol"][t] / max(cnt["admitted"][t], 1.0)))
        out["mean_backlog_s"].append(float(backlog[:, t].mean()))
    return out


def summarize_fleet(counts, hist, curves, tcfg: T2DRLCfg, fcfg: FleetCfg,
                    wall_s: float, snaps=None):
    """Reduce per-cell twin outputs (numpy) to the fleet-level metric dict.
    With ``snaps`` (per-frame cumulative snapshots from ``fleet_run``) the
    result additionally carries ``"frames"`` — per-frame latency
    quantiles, drop / SLO rates, and mean backlog series."""
    c = {k: float(np.sum(np.asarray(v))) for k, v in counts.items()}
    hist_all = np.sum(np.asarray(hist), axis=0)
    q = latency_quantiles(hist_all, fcfg.hist_max)
    backlog = np.asarray(curves["backlog"])          # (C, T, K)
    C = backlog.shape[0]
    flat_backlog = backlog.reshape(C, -1)
    depth = np.asarray(curves["depth"]).reshape(C, -1)
    adm = max(c["admitted"], 1.0)
    sim_s = tcfg.env.T * tcfg.env.K * tcfg.env.tau
    out = {
        "num_cells": C,
        "sim_seconds": float(sim_s),
        "requests": c["arrivals"],
        "admitted": c["admitted"],
        "dropped": c["dropped"],
        "truncated": c["truncated"],
        "drop_rate": c["dropped"] / max(c["arrivals"], 1.0),
        "slo_viol_rate": c["slo_viol"] / adm,
        "deadline_miss_rate": c["deadline_miss"] / adm,
        "mean_latency_s": c["lat_sum"] / adm,
        "mean_wait_s": c["wait_sum"] / adm,
        "p50_s": q[0.5], "p95_s": q[0.95], "p99_s": q[0.99],
        "end_backlog_s": c["end_backlog"],
        "mean_backlog_s": float(flat_backlog.mean()),
        "peak_backlog_s": float(flat_backlog.max()),
        "peak_queue_depth": float(depth.max()),
        "backlog_curve": flat_backlog,
        "hist": hist_all,
        "wall_s": wall_s,
        "requests_per_min": c["arrivals"] / max(wall_s, 1e-9) * 60.0,
    }
    if snaps is not None:
        out["frames"] = _frame_series(snaps, curves, fcfg)
    return out
