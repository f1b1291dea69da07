"""What the ranks of ``tests/test_torch_dist.py`` run: torch and the port
only (no JAX in a rank).  ``battery`` runs every check of the file's one
world and returns numpy results for the parent to hold against the
single-process runs and the reference.  ``world_of_one`` gives a test a
mesh without spawning: a gloo world of the test's own process."""
import contextlib

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.bridge import train_state_to_numpy
from repro_torch.configs import get_arch
from repro_torch.core.t2drl import (cell_generators, run_training_sharded,
                                    t2drl_init_batch)
from repro_torch.device import make_generator
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_cells_mesh, make_host_mesh
from repro_torch.launch.train import make_train_fns
from repro_torch.models import lm as lm_mod
from repro_torch.nn import moe
from repro_torch.nn.sharding import use_mesh

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


def _np(t) -> np.ndarray:
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


def moe_case(case: dict, x: np.ndarray = None):
    """``moe_apply`` with ``dispatch="shardmap"`` on ``x`` (default: the
    case's), under whatever mesh is current: (y as f32, aux)."""
    x = case["x"] if x is None else x
    cfg = moe.MoECfg(**case["cfg"], dispatch="shardmap")
    dt = DTYPES[case["dtype"]]
    p = moe_params(case["params"], dt)
    y, aux = moe.moe_apply(p, cfg, torch.tensor(x).to(dt), compute_dtype=dt)
    return _np(y), float(aux)


def lm_case(case: dict, shardmap: bool = True):
    """deepseek-v3's smoke config with ``PerfOpts(moe_shardmap=True)``
    (or, ``shardmap=False``, the default options): the forward's logits,
    the loss and every leaf's gradient, and two train steps (metrics and
    the parameters after), f32 compute."""
    arch = get_arch(case["arch"])
    cfg = arch.make_smoke()
    scfg = steps._apply_moe_shardmap(cfg) if shardmap else cfg
    params = lm_mod.lm_init(make_generator(0, "cpu"), cfg)
    batch = {k: torch.tensor(v) for k, v in case["batch"].items()}
    logits, aux = lm_mod.lm_forward(params, scfg, batch["tokens"],
                                    impl="plain",
                                    compute_dtype=torch.float32)
    leaves = lm_mod.tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = lm_mod.lm_loss(params, scfg, batch,
                             compute_dtype=torch.float32)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    init_fn, step = make_train_fns(
        arch, cfg, lr_schedule=lambda s: 1e-3,
        opts=steps.PerfOpts(moe_shardmap=shardmap),
        compute_dtype=torch.float32)
    p, opt = init_fn(make_generator(0, "cpu"))
    metrics = []
    for _ in range(2):
        p, opt, m = step(p, opt, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"logits": _np(logits), "aux": float(aux.detach()),
            "loss": float(loss.detach()),
            "grads": [_np(g) for g in grads], "metrics": metrics,
            "params": [_np(t) for t in lm_mod.tree_leaves(p)]}


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
        out["lm"] = lm_case(spec["lm"])
    data = init_device_mesh("cpu", (n, 1), mesh_dim_names=("data", "model"))
    case = spec["moe_data"]
    rows = case["x"].shape[0] // n
    with use_mesh(data):
        out["moe_data"] = moe_case(case,
                                   case["x"][rank * rows:(rank + 1) * rows])
    return out
