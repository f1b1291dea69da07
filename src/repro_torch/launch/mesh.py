"""Device meshes and rank processes (port of ``repro.launch.mesh``).

The port runs one process per rank (SPMD, as ``torchrun
--nproc-per-node=N`` starts them, or ``spawn_ranks`` below), each with
the default process group initialised.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over that group:

- ``make_cells_mesh()``: 1-D ``("cells",)`` over every rank, for sharding
  independent edge cells (``repro_torch.core.t2drl.run_training_sharded``);
- ``make_host_mesh()``: ``(1, 1)`` ``("data", "model")`` over a world of
  one rank, for smoke runs of the mesh code paths.

Without an initialised process group they raise and say how to start
ranks; they never invent a world of one.  The mesh's device type is
``"cuda"`` under NCCL and ``"cpu"`` otherwise: a gloo group (the CPU, or
several ranks sharing one card, which NCCL refuses) moves device tensors
through host copies.  ``batch_sharding`` and ``replicated`` give the
placements of a batch-leading and of a replicated tensor on a mesh.
"""
from __future__ import annotations

import datetime
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.nn.sharding import P, batch_axes, placements

_HOW = ("no torch.distributed process group is initialised: start one "
        "process per rank (torchrun --nproc-per-node=N, or "
        "repro_torch.launch.mesh.spawn_ranks) and call "
        "torch.distributed.init_process_group in each")


def _world() -> int:
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(_HOW)
    return dist.get_world_size()


def mesh_device_type() -> str:
    """``"cuda"`` where the default group's backend is NCCL, else
    ``"cpu"``."""
    _world()
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_cells_mesh(n_devices: int | None = None):
    """1-D ``("cells",)`` mesh over every rank of the default group.
    ``n_devices`` (default: the world size) must equal the world size."""
    world = _world()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"a cells mesh of {n} devices needs a world of "
                         f"{n} ranks; this one has {world}")
    return init_device_mesh(mesh_device_type(), (n,),
                            mesh_dim_names=("cells",))


def make_host_mesh():
    """``(1, 1)`` ``("data", "model")`` mesh over a world of one rank."""
    world = _world()
    if world != 1:
        raise ValueError(f"the host mesh is one rank; this world has "
                         f"{world} (build a mesh over all of them)")
    return init_device_mesh(mesh_device_type(), (1, 1),
                            mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: (16, 16) = 256 ranks, dims (data, model).  Multi-pod:
    (2, 16, 16) = 512 ranks, dims (pod, data, model).  The world must
    have exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = _world()
    n = 1
    for s in shape:
        n *= s
    if world != n:
        raise ValueError(f"the {'multi-pod' if multi_pod else 'single-pod'}"
                         f" production mesh {shape} needs a world of {n} "
                         f"ranks; this one has {world}")
    return init_device_mesh(mesh_device_type(), shape,
                            mesh_dim_names=axes)


def batch_sharding(mesh, *rest) -> tuple:
    """Placements of a tensor whose dim 0 is the batch, over the mesh's
    batch dimensions (``"pod"`` first), the rest as ``rest`` names."""
    ba = batch_axes(mesh)
    lead = ba if len(ba) != 1 else ba[0]
    return placements(P(lead, *rest), mesh)


def replicated(mesh) -> tuple:
    """Placements of a tensor every rank holds whole."""
    return placements(P(), mesh)


# -- rank processes ------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, n: int, port: int, backend: str,
               device_type: str, timeout_s: float, args: tuple, out):
    """One rank: one intra-op thread, its card (rank modulo the cards)
    where ``device_type`` is ``"cuda"``, the group over
    ``tcp://localhost:port``, then ``fn(rank, n, *args)``; the result, or
    the traceback, goes to the parent."""
    torch.set_num_threads(1)
    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{port}", rank=rank,
            world_size=n, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out.put((rank, True, fn(rank, n, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:       # reported to the parent, which raises
        out.put((rank, False, traceback.format_exc()))
        raise


def spawn_ranks(fn, n: int, *, args: tuple = (), backend: str = "gloo",
                device_type: str = "cpu", timeout_s: float = 120.0) -> list:
    """Run ``fn(rank, n, *args)`` in ``n`` new processes (start method
    ``spawn``: CUDA cannot be forked), each rank in a ``backend`` group of
    ``n`` on a free localhost port, with ``timeout_s`` as the group's
    timeout and the whole run's deadline.  ``fn`` and ``args`` must be
    picklable (``fn`` a module-level function) and so must its result.
    Returns the ranks' results in rank order.  A rank that raises or
    dies, or a run past the deadline, kills every rank and raises
    ``RuntimeError``; nothing waits without a deadline."""
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, n, port, backend, device_type,
                               timeout_s, args, out), daemon=True)
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    results, failed = {}, {}
    try:
        while len(results) + len(failed) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                rank, ok, value = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = {r: f"exit code {p.exitcode}"
                        for r, p in enumerate(procs)
                        if r not in results and r not in failed
                        and p.exitcode not in (None, 0)}
                if dead and not failed:   # no traceback comes after 1 s
                    failed.update(dead)
                if failed:
                    break
                continue
            if ok:
                results[rank] = value
            else:
                failed[rank] = value
                # the other ranks' reports follow within a few seconds
                deadline = min(deadline, time.monotonic() + 5.0)
        if failed:
            raise RuntimeError("spawn_ranks: " + "\n".join(
                f"rank {r} of {n} failed:\n{failed[r]}"
                for r in sorted(failed)))
        if len(results) < n:
            raise RuntimeError(f"spawn_ranks: {n - len(results)} of {n} "
                               f"ranks did not finish in {timeout_s} s")
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        out.close()
    return [results[r] for r in range(n)]

