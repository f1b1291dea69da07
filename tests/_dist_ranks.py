"""What the ranks of ``tests/test_torch_dist.py`` run: torch and the port
only (no JAX in a rank).  ``battery`` runs every check of the file's one
world and returns numpy results for the parent to hold against the
single-process runs and the reference.  ``world_of_one`` gives a test a
mesh without spawning: a gloo world of the test's own process;
``fake_world`` a fake process group of n ranks (this process rank 0), as
the dry run uses.  The LM mesh cases (``train_lm_case``,
``serve_lm_case``) take ``mesh=None`` for the same run unsharded."""
import contextlib
import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.bridge import lm_params_from_numpy, train_state_to_numpy
from repro_torch.configs import get_arch
from repro_torch.core.t2drl import (cell_generators, run_training_sharded,
                                    t2drl_init_batch)
from repro_torch.device import make_generator
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_cells_mesh, make_host_mesh
from repro_torch.launch.train import make_train_fns
from repro_torch.models import lm as lm_mod
from repro_torch.nn import moe
from repro_torch.nn import sharding as shlib
from repro_torch.nn.sharding import current_mesh, use_mesh

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@contextlib.contextmanager
def world_of_one():
    """A gloo group of this one process (an in-process store) and its
    (1, 1) ``("data", "model")`` host mesh, destroyed on exit."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_host_mesh()
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def fake_world(n: int):
    """Rank 0 of a fake process group of ``n`` ranks (the dry run's),
    destroyed on exit, so no process group outlives the test."""
    from repro_torch.launch.dryrun import fake_world as fw
    with fw(n):
        yield


def _np(t) -> np.ndarray:
    if shlib.is_dtensor(t):
        t = t.full_tensor()
    return t.detach().float().cpu().numpy()


def train_case(case: dict, runner):
    """``runner(ts, cfg, gens, episodes, masks, train=, pop=)`` on the
    case's fresh state: (JAX-layout numpy state, history)."""
    cfg, B = case["cfg"], case["B"]
    gens = cell_generators(cfg.seed, B, "cpu")
    ts = t2drl_init_batch(gens, cfg)
    masks = (None if case.get("masks") is None
             else torch.tensor(case["masks"]))
    ts, hist = runner(ts, cfg, gens, case["episodes"], masks,
                      train=case.get("train", True), pop=case.get("pop"))
    return train_state_to_numpy(ts), hist


def moe_params(tree: dict, dtype) -> dict:
    """A numpy MoE tree as tensors, the experts (and shared MLP) in
    ``dtype``, the router in f32, as the reference's ``moe_init``."""
    def conv(v, d):
        if isinstance(v, dict):
            return {k: conv(x, torch.float32 if k == "router" else d)
                    for k, x in v.items()}
        return torch.tensor(v).to(d)
    return {k: conv(v, torch.float32 if k == "router" else dtype)
            for k, v in tree.items()}


def moe_case(case: dict, x: np.ndarray = None, whole: bool = False):
    """``moe_apply`` with ``dispatch="shardmap"`` on ``x`` (default: the
    case's), under whatever mesh is current, each rank holding its slice
    of the experts (``whole``: every rank the whole tree): (y as f32,
    aux)."""
    x = case["x"] if x is None else x
    cfg = moe.MoECfg(**case["cfg"], dispatch="shardmap")
    dt = DTYPES[case["dtype"]]
    p = moe_params(case["params"], dt)
    mesh = current_mesh()
    if mesh is not None and not whole:
        p = moe.expert_slice(p, mesh)
    y, aux = moe.moe_apply(p, cfg, torch.tensor(x).to(dt), compute_dtype=dt)
    return _np(y), float(aux)


def lm_case(case: dict, shardmap: bool = True, mesh=None):
    """deepseek-v3's smoke config with ``PerfOpts(moe_shardmap=True)``
    (or, ``shardmap=False``, the default options): the forward's logits,
    the loss and every leaf's gradient, and two train steps (metrics and
    the parameters after), f32 compute.  On ``mesh`` the parameters are
    DTensors by ``lm_spec`` (each rank holds its slice of the experts,
    whose leading dims come back in ``expert_rows``)."""
    arch = get_arch(case["arch"])
    cfg = arch.make_smoke()
    scfg = steps._apply_moe_shardmap(cfg) if shardmap else cfg
    params = lm_mod.lm_init(make_generator(0, "cpu"), cfg)
    if mesh is not None:
        params = steps.shard_tree(params, lm_mod.lm_spec(cfg), mesh)
    batch = {k: torch.tensor(v) for k, v in case["batch"].items()}
    with use_mesh(mesh):
        sbatch = batch if mesh is None else steps.shard_batch(batch, mesh)
        logits, aux = lm_mod.lm_forward(params, scfg, sbatch["tokens"],
                                        impl="plain",
                                        compute_dtype=torch.float32)
        leaves = lm_mod.tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = lm_mod.lm_loss(params, scfg, sbatch,
                                 compute_dtype=torch.float32)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    rows = [_local(gp["stacked"][str(i)]["ffn"][w]).shape[1]
            for gc, gp in zip(cfg.groups, params["groups"])
            for i, b in enumerate(gc.cycle)
            if b.ffn == "moe" and not b.shared
            for w in ("up", "gate", "down")]
    init_fn, step = make_train_fns(
        arch, cfg, lr_schedule=lambda s: 1e-3,
        opts=steps.PerfOpts(moe_shardmap=shardmap),
        compute_dtype=torch.float32, mesh=mesh)
    p, opt = init_fn(make_generator(0, "cpu"))
    metrics = []
    for _ in range(2):
        p, opt, m = step(p, opt, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"logits": _np(logits), "aux": float(aux.detach()),
            "loss": float(loss.detach()),
            "grads": [_np(g) for g in grads], "metrics": metrics,
            "params": [_np(t) for t in lm_mod.tree_leaves(p)],
            "expert_rows": rows}


def _local(t):
    return t.to_local() if shlib.is_dtensor(t) else t


# -- the LM's mesh half ---------------------------------------------------------------

LM_MESHES = (("tp", (1, 2)), ("dp", (2, 1)))
# the serving cases a mesh runs: the GQA split and the sequence-sharded
# cache need a "model" dimension of 2
LM_SERVE = {"tp": ("ssm", "gqa", "mla", "seq"), "dp": ("ssm", "mla")}
F32 = torch.float32


def with_heads(cfg, n_heads: int, n_kv_heads: int):
    """``cfg`` (an LMCfg of either package) with every attention block's
    heads set (d_head kept)."""
    groups = []
    for g in cfg.groups:
        cycle = tuple(dataclasses.replace(b, attn=dataclasses.replace(
            b.attn, n_heads=n_heads, n_kv_heads=n_kv_heads))
            if b.attn is not None else b for b in g.cycle)
        groups.append(dataclasses.replace(g, cycle=cycle))
    return dataclasses.replace(cfg, groups=tuple(groups))


def case_cfg(case: dict, get=get_arch):
    """The case's config from ``get``'s registry (the port's or the
    reference's): the arch's smoke config, heads as the case sets."""
    cfg = get(case["arch"]).make_smoke()
    if case.get("heads"):
        cfg = with_heads(cfg, *case["heads"])
    return cfg


def _sharded(params, cfg, mesh):
    return params if mesh is None else steps.shard_tree(
        params, lm_mod.lm_spec(cfg), mesh)


def train_lm_case(case: dict, mesh=None) -> dict:
    """The case's forward logits, loss and every gradient on its params
    (a JAX-layout numpy tree), then two train steps with
    ``PerfOpts(fsdp=True)`` from ``make_generator(0)``'s init, f32."""
    cfg = case_cfg(case)
    arch = get_arch(case["arch"])
    p = _sharded(lm_params_from_numpy(case["params"], cfg, "cpu"), cfg, mesh)
    batch = {k: torch.tensor(v) for k, v in case["batch"].items()}
    with use_mesh(mesh):
        sbatch = batch if mesh is None else steps.shard_batch(batch, mesh)
        logits, _ = lm_mod.lm_forward(p, cfg, sbatch["tokens"],
                                      impl="plain", compute_dtype=F32)
        leaves = lm_mod.tree_leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = lm_mod.lm_loss(p, cfg, sbatch, compute_dtype=F32)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    init_fn, step = make_train_fns(
        arch, cfg, lr_schedule=lambda s: 1e-3,
        opts=steps.PerfOpts(fsdp=True), compute_dtype=F32, mesh=mesh)
    tp, opt = init_fn(make_generator(0, "cpu"))
    from torch.distributed.tensor import Shard
    data_sharded = sum(1 for t in lm_mod.tree_leaves(tp)
                       if shlib.is_dtensor(t)
                       and isinstance(t.placements[0], Shard))
    metrics = []
    for _ in range(2):
        tp, opt, m = step(tp, opt, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"logits": _np(logits), "loss": float(loss.detach()),
            "grads": [_np(g) for g in grads], "metrics": metrics,
            "params": [_np(t) for t in lm_mod.tree_leaves(tp)],
            "fsdp_leaves": data_sharded}


def serve_lm_case(case: dict, mesh=None, seq_shard=None) -> dict:
    """Prefill of the case's prompts (``impl="kernel"``: the kernels'
    plain versions on the CPU, on each rank's heads), then a decode step
    per column of its ``decode`` tokens, f32; with ``seq_shard`` the
    cache is moved to the sequence-sharded layout before decoding.
    Returns the prefill's and each decode's logits and the last cache's
    leaves."""
    cfg = case_cfg(case)
    p = _sharded(lm_params_from_numpy(case["params"], cfg, "cpu"), cfg, mesh)
    tok = torch.tensor(case["tokens"])
    dec = torch.tensor(case["decode"])
    B, L = tok.shape
    cache = lm_mod.lm_init_cache(cfg, B, case["S"], dtype=F32)
    with use_mesh(mesh):
        if mesh is not None:
            cache = steps.shard_tree(cache, lm_mod.lm_cache_spec(cfg), mesh)
            tok, dec = (shlib.distribute(t, steps.batch_spec_for(mesh),
                                         mesh) for t in (tok, dec))
        logits, cache = lm_mod.lm_prefill(p, cfg, tok, cache, impl="kernel",
                                          compute_dtype=F32)
        if seq_shard and mesh is not None:
            cache = shlib.tree_map_specs(
                lambda s, t: shlib.constrain(t, s),
                lm_mod.lm_cache_spec(cfg, seq_shard=seq_shard), cache)
        out = [_np(logits)]
        for i in range(dec.shape[1]):
            lg, cache = lm_mod.lm_decode(p, cfg, dec[:, i:i + 1], cache,
                                         L + i, compute_dtype=F32)
            out.append(_np(lg))
    placements = [str(getattr(t, "placements", None))
                  for t in lm_mod.tree_leaves(cache)]
    return {"logits": out, "cache": [_np(t) for t in
                                     lm_mod.tree_leaves(cache)],
            "cache_placements": placements}


def lm_mesh_battery(spec: dict) -> dict:
    out = {}
    for name, shape in LM_MESHES:
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        out[name] = {"train": train_lm_case(spec["train"], mesh), **{
            k: serve_lm_case(spec[k], mesh,
                             seq_shard="model" if k == "seq" else None)
            for k in LM_SERVE[name]}}
    return out


def battery(rank: int, n: int, spec: dict) -> dict:
    out = {"train": {}}
    cells = make_cells_mesh()
    for name, case in spec["train"].items():
        out["train"][name] = train_case(
            case, lambda *a, **k: run_training_sharded(*a, mesh=cells, **k))
    try:
        B = n + 1
        cfg = spec["train"]["base"]["cfg"]
        gens = cell_generators(cfg.seed, B, "cpu")
        run_training_sharded(t2drl_init_batch(gens, cfg), cfg, gens, 1,
                             mesh=cells)
        out["odd_B"] = None
    except ValueError as e:
        out["odd_B"] = str(e)

    model = init_device_mesh("cpu", (n,), mesh_dim_names=("model",))
    with use_mesh(model):
        out["moe"] = {name: moe_case(case)
                      for name, case in spec["moe"].items()}
        try:    # a whole plain tree on the expert-parallel path is refused
            moe_case(next(iter(spec["moe"].values())), whole=True)
            out["moe_whole"] = None
        except ValueError as e:
            out["moe_whole"] = str(e)
    out["lm"] = lm_case(spec["lm"], mesh=model)
    out["lm_gspmd"] = lm_case(spec["lm"], shardmap=False, mesh=model)
    out["lm_mesh"] = lm_mesh_battery(spec["lm_mesh"])
    data = init_device_mesh("cpu", (n, 1), mesh_dim_names=("data", "model"))
    case = spec["moe_data"]
    rows = case["x"].shape[0] // n
    with use_mesh(data):
        out["moe_data"] = moe_case(case,
                                   case["x"][rank * rows:(rank + 1) * rows])
    return out
