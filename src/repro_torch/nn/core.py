"""Core building blocks: initialisers, dtype policy, linear, norms,
embedding (port of ``repro.nn.core``).

Dtype policy as in the JAX package: a linear casts both operands to the
compute dtype and adds its bias in it; norms run in f32 and cast back; the
tied unembedding gives f32 logits (bf16 operands, f32 products and sums).
Each layer has its ``*_spec``, the PartitionSpec tree of its parameters
(the reference's, leaf for leaf): ``w`` is (d_in, d_out) in both trees.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .sharding import (P, batch_spec, constrain, current_mesh, is_dtensor,
                       local_contiguous)


def truncated_normal_init(generator: torch.Generator, shape, scale: float,
                          dtype=torch.float32) -> torch.Tensor:
    """Fan-in scaled normal truncated to [-2, 2] standard deviations, by
    the inverse CDF (as ``jax.random.truncated_normal``), on the
    generator's device."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    stddev = scale / math.sqrt(fan_in)
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = torch.rand(shape, generator=generator, device=generator.device)
    z = math.sqrt(2.0) * torch.erfinv(lo + u * (hi - lo))
    return (z.clamp_(-2.0, 2.0) * stddev).to(dtype)


def normal_init(generator: torch.Generator, shape, stddev: float,
                dtype=torch.float32) -> torch.Tensor:
    return (torch.randn(shape, generator=generator, device=generator.device)
            * stddev).to(dtype)


# -- linear ---------------------------------------------------------------------

def linear_init(generator: torch.Generator, d_in: int, d_out: int, *,
                bias: bool = False, dtype=torch.float32,
                scale: float = 1.0) -> dict:
    p = {"w": truncated_normal_init(generator, (d_in, d_out), scale, dtype)}
    if bias:
        p["b"] = torch.zeros(d_out, dtype=dtype, device=generator.device)
    return p


def linear(p: dict, x: torch.Tensor, *,
           compute_dtype=torch.bfloat16) -> torch.Tensor:
    """``x @ w (+ b)`` with both operands and the bias in the compute
    dtype; ``w`` is (d_in, d_out) as in the JAX tree."""
    x = local_contiguous(x.to(compute_dtype))   # matmul views x
    y = torch.matmul(x, p["w"].to(compute_dtype))
    if "b" in p:
        y = y + p["b"].to(compute_dtype)
    return y


def linear_spec(*, bias: bool = False, w_spec=P(None, None),
                b_spec=None) -> dict:
    s = {"w": w_spec}
    if bias:
        s["b"] = (b_spec if b_spec is not None
                  else P(w_spec[1]) if len(w_spec) == 2 else P(None))
    return s


# -- norms ----------------------------------------------------------------------

def rmsnorm_init(d: int, dtype=torch.float32, device=None) -> dict:
    return {"scale": torch.ones(d, dtype=dtype, device=device)}


def rmsnorm(p: dict, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def rmsnorm_spec() -> dict:
    return {"scale": P(None)}


def layernorm_init(d: int, *, elementwise: bool = True, dtype=torch.float32,
                   device=None) -> dict:
    if not elementwise:          # OLMo's non-parametric LayerNorm
        return {}
    return {"scale": torch.ones(d, dtype=dtype, device=device),
            "bias": torch.zeros(d, dtype=dtype, device=device)}


def layernorm(p: dict, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if "scale" in p:
        y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def layernorm_spec(*, elementwise: bool = True) -> dict:
    if not elementwise:
        return {}
    return {"scale": P(None), "bias": P(None)}


# -- embedding ------------------------------------------------------------------

def embedding_init(generator: torch.Generator, vocab: int, d: int, *,
                   dtype=torch.float32) -> dict:
    return {"table": normal_init(generator, (vocab, d), 1.0 / math.sqrt(d),
                                 dtype)}


def embedding_spec() -> dict:
    return {"table": P("model", None)}


def embed(p: dict, ids: torch.Tensor, *,
          compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The table's rows at ``ids``.  A DTensor table under a mesh is
    looked up on local shards (``_embed_local``)."""
    if is_dtensor(p["table"]) and current_mesh() is not None:
        return _embed_local(p["table"], ids).to(compute_dtype)
    return F.embedding(ids, p["table"]).to(compute_dtype)


def _embed_local(table, ids):
    """The lookup of a vocab-sharded table: each rank looks its ids up in
    its vocab slice (``P("model", None)``), ids outside it give zero rows,
    and the rows come back partial over the vocab's mesh dimensions (the
    caller's ``constrain`` sums them), their gradient to each rank's slice
    whole.  The table's local gradient is partial over the mesh
    dimensions the ids are split on."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = current_mesh()
    table = constrain(table, P("model", None))
    ids = constrain(ids, batch_spec(None))
    rows = [i for i, pl in enumerate(ids.placements)
            if isinstance(pl, Shard)]
    grad = tuple(Partial() if isinstance(pl, Replicate) and i in rows
                 else pl for i, pl in enumerate(table.placements))
    t, x = table.to_local(grad_placements=grad), ids.to_local()
    vocab = [i for i, pl in enumerate(table.placements)
             if isinstance(pl, Shard)]
    out_pl = list(ids.placements)
    if vocab:
        (i,) = vocab
        lo = mesh.get_local_rank(i) * t.shape[0]
        mine = (x >= lo) & (x < lo + t.shape[0])
        e = F.embedding(torch.where(mine, x - lo, torch.zeros_like(x)), t)
        e = e * mine[..., None].to(e.dtype)
        out_pl[i] = Partial()
    else:
        e = F.embedding(x, t)
    return DTensor.from_local(e, mesh, tuple(out_pl), run_check=False)


def unembed(p: dict, x: torch.Tensor, *,
            compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Tied-embedding logits ``x @ table.T`` in f32: the operands are
    rounded to the compute dtype, products and sums are taken in f32 (the
    JAX ``preferred_element_type=float32``)."""
    table = p["table"].to(compute_dtype).float()
    return torch.matmul(x.to(compute_dtype).float(), table.t())


# -- activations ------------------------------------------------------------------

def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def count_params(params) -> int:
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(v) for v in params)
    return int(params.numel())
