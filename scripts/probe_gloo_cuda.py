"""Which collectives a gloo group carries on CUDA tensors, two ranks
sharing ``cuda:0`` (NCCL refuses two ranks on one device): the
torch.distributed collectives, their functional forms and DTensor's
redistributions, under the backends ``"cpu:gloo,cuda:gloo"`` and
``"gloo"``.  Needs a card; prints one JSON line a backend (a rank that
dies is reported with the error ``spawn_ranks`` raised).

Usage: python scripts/probe_gloo_cuda.py
"""
import json
import sys
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402

BACKENDS = ("cpu:gloo,cuda:gloo", "gloo")


def rank_fn(rank: int, n: int) -> dict:
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    out = {"backend": str(dist.get_backend())}
    dev = torch.device("cuda", 0)
    mesh = init_device_mesh("cuda", (1, n), mesh_dim_names=("data", "model"))
    g = mesh.get_group("model")
    x = torch.arange(8, dtype=torch.float32, device=dev).reshape(4, 2) + rank

    def attempt(name, fn):
        try:
            r = fn()
            out[name] = ["ok", r.float().sum().item() if torch.is_tensor(r)
                         else r]
        except Exception as e:
            out[name] = ["FAIL", repr(e)[:300]]

    flat = x.reshape(-1).contiguous()
    attempt("all_reduce", lambda: dist.all_reduce(x.clone(), group=g))
    attempt("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
        torch.empty(8 * n, device=dev), flat, group=g))
    attempt("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(
        torch.empty(8 // n, device=dev), flat, group=g))
    attempt("all_to_all_single", lambda: dist.all_to_all_single(
        torch.empty(8, device=dev), flat, group=g))
    attempt("funcol_all_reduce", lambda: funcol.all_reduce(x, "sum", g))
    attempt("funcol_all_gather", lambda: funcol.all_gather_tensor(x, 0, g))
    attempt("funcol_reduce_scatter", lambda: funcol.reduce_scatter_tensor(
        x, "sum", 0, g))
    attempt("funcol_all_to_all", lambda: funcol.all_to_all_single(
        x, None, None, g))
    w = torch.randn(16, 8, generator=torch.Generator().manual_seed(0)).to(dev)

    def dtensor_ops():
        d = distribute_tensor(w, mesh, (Replicate(), Shard(0)),
                              src_data_rank=None)
        assert torch.equal(d.redistribute(
            mesh, (Replicate(), Replicate())).to_local(), w)
        assert torch.equal(d.redistribute(
            mesh, (Replicate(), Shard(1))).full_tensor(), w)
        a = distribute_tensor(torch.ones(4, 16, device=dev), mesh,
                              (Replicate(), Shard(1)), src_data_rank=None)
        return torch.matmul(a, d).full_tensor()

    attempt("dtensor_ops", dtensor_ops)
    return out


def main() -> None:
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "gpu": torch.cuda.get_device_name(0)}), flush=True)
    for backend in BACKENDS:
        try:
            res = spawn_ranks(rank_fn, 2, backend=backend,
                              device_type="cuda", timeout_s=120)
            print(json.dumps({"backend": backend, "rank0": res[0]}),
                  flush=True)
        except Exception:
            print(json.dumps({"backend": backend, "carried": False,
                              "error": traceback.format_exc()[-1500:]}),
                  flush=True)


if __name__ == "__main__":
    main()
