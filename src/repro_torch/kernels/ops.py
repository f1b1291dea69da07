"""Wrappers around the hand-written CUDA kernels.

A wrapper checks its inputs, then launches its kernel for CUDA tensors or
runs the plain version in ``ref.py`` for CPU tensors — only because the
tensors lie on the CPU.  For a CUDA tensor it launches or raises; there is
no fallback.  ``LAUNCHES[name]`` counts the kernel's launches (and nothing
else), so a run can show that its path went through the kernel.  One
launch is one call of the kernel's C entry point, however many grids it
starts: ``ssd_scan`` runs one grid for a single chunk and three (chunk
states, state recurrence, outputs) for more, and counts one either way.
``GRIDS[name]`` adds up the grids that the C entry points report they
started, and ``CLUSTERS[name]`` the thread-block clusters of the two
chain kernels' grids.  ``ddpm_chain`` has two plans (``chain_plan``): a
launch of the row-tiled plan counts one grid and no cluster, and also one
in ``ROW_TILED["ddpm_chain"]``.  ``PLAIN_PREFILLS["mla"]`` counts the
MLA prefills asked for the kernel (``impl="kernel"``) at a head pair the
kernel is not built for, which ran the plain products instead (the smoke
configs' widths), so that a run shows which prefills took no kernel.
``reset_launches`` zeroes all five.

``ddpm_step`` is differentiable in x and eps_hat: its
``torch.autograd.Function`` (``DdpmStep``) launches ``ddpm_step_bwd`` in
the backward (the plain version for CPU tensors).  ``ddpm_chain`` is
differentiable in the MLP's weights and biases: ``DdpmChain`` launches the
forward with its record of activations and, in the backward, one
``ddpm_chain_bwd``.  ``flash_attention`` and ``ssd_scan`` are
forward-only and refuse grad-enabled inputs.  ``flash_attention``'s
launches at a head pair of its own (q and k wider than v,
``FLASH_HEAD_PAIRS``: MLA's (192, 128)) count under that pair's key
(``"flash_mla"``), the others under ``"flash_attention"``.

``flash_plan`` (which kernel a dtype takes), ``ssd_plan`` (chunks,
scratch, shared memory), ``chain_plan`` (the cluster plan or the
row-tiled one; cluster size, rows per cluster or tile, shared memory) and
``chain_bwd_plan`` hold the host-side choices of a launch, so the CPU
tests reach them.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.obs import profiling

from . import build, ref

LAUNCHES = {"ddpm_step": 0, "ddpm_step_bwd": 0, "ddpm_chain": 0,
            "ddpm_chain_bwd": 0, "flash_attention": 0, "flash_mla": 0,
            "ssd_scan": 0}
GRIDS = dict(LAUNCHES)
CLUSTERS = {"ddpm_chain": 0, "ddpm_chain_bwd": 0}
ROW_TILED = {"ddpm_chain": 0}
PLAIN_PREFILLS = {"mla": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FN = {}
_P, _I64 = ctypes.c_void_p, ctypes.c_int64
_GRIDS = ctypes.POINTER(ctypes.c_int)   # out: grids the entry point started

CHAIN_MAX_LAYERS = 8


class _ChainNet(ctypes.Structure):
    """``struct ChainNet`` of ddpm_chain.cu: the MLP's widths, the pointers
    of its ``w`` (in, out) and ``b`` (out,) (learner 0's for stacked
    weights), the number of stacked learners and each layer's learner
    strides in floats, passed by value."""
    _fields_ = [("n_layers", ctypes.c_int),
                ("dims", ctypes.c_int * (CHAIN_MAX_LAYERS + 1)),
                ("w", ctypes.c_void_p * CHAIN_MAX_LAYERS),
                ("b", ctypes.c_void_p * CHAIN_MAX_LAYERS),
                ("learners", ctypes.c_int),
                ("w_lstride", ctypes.c_int64 * CHAIN_MAX_LAYERS),
                ("b_lstride", ctypes.c_int64 * CHAIN_MAX_LAYERS)]


# c_void_p for every pointer and the stream: a bare Python int would be
# passed as a 32-bit C int and cut the address
_SIGNATURES = {
    "ddpm_step_launch": (ctypes.c_int, [_P, _P, _P, _P, _I64, ctypes.c_float,
                                        ctypes.c_float, ctypes.c_float,
                                        ctypes.c_int, _GRIDS, _P]),
    "ddpm_step_bwd_launch": (ctypes.c_int, [_P, _P, _P, _I64, ctypes.c_float,
                                            ctypes.c_float, ctypes.c_int,
                                            _GRIDS, _P]),
    "ddpm_chain_launch": (ctypes.c_int, [_ChainNet] + [_P] * 7 + [_I64] * 4
                          + [ctypes.c_int, ctypes.c_int, _I64, _GRIDS, _P]),
    "ddpm_chain_bwd_launch": (ctypes.c_int, [_ChainNet] + [_P] * 7
                              + [_I64] * 4 + [ctypes.c_int, ctypes.c_int,
                                              _I64, _GRIDS, _P]),
    "flash_attention_launch": (ctypes.c_int, [_P, _P, _P, _P, _I64, _I64,
                                              _I64, _I64, _I64, _I64, _I64,
                                              ctypes.c_int, _I64,
                                              ctypes.c_float, ctypes.c_int,
                                              _GRIDS, _P]),
    "ssd_scan_launch": (ctypes.c_int, [_P] * 10 + [_I64] * 7
                        + [_GRIDS, _P]),
    "ssd_scan_smem_bytes": (_I64, [_I64, _I64]),
}

FLASH_HEAD_DIMS = (32, 64, 112, 128)   # flash_attention_launch's D = DV
# (q/k head size, v head size) pairs of their own, with their launch key
FLASH_HEAD_PAIRS = {(192, 128): "flash_mla"}
SMEM_LIMIT = 232448          # H100: 227 KB of shared memory per block


def reset_launches() -> None:
    for counts in (LAUNCHES, GRIDS, CLUSTERS, ROW_TILED, PLAIN_PREFILLS):
        for k in counts:
            counts[k] = 0


def _fn(lib: str, name: str):
    """``name`` from ``csrc/<lib>.cu``, built and typed at first use."""
    fn = _FN.get(name)
    if fn is None:
        fn = getattr(build.load(lib), name)
        fn.restype, fn.argtypes = _SIGNATURES[name]
        _FN[name] = fn
    return fn


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(name: str, *tensors) -> None:
    """What every kernel needs of a CUDA input: contiguous, on the current
    device."""
    current = torch.cuda.current_device()
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
        if t.device.index != current:
            raise ValueError(f"{name}: a tensor is on {t.device} but the "
                             f"current device is cuda:{current}")


def _check_no_grad(name: str, *tensors) -> None:
    """The LM kernels are forward-only, as the reference's Pallas kernels
    are: training runs through ``impl="plain"`` or ``"chunked"``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} has no backward (nor has the reference's kernel): "
            "train through impl='plain' or 'chunked', or call it under "
            "torch.no_grad()")


def _check_device(name: str, *tensors) -> torch.device:
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    return dev


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# -- ddpm_step ------------------------------------------------------------------

def ddpm_coefficients(alpha: float, alpha_bar: float, beta_tilde: float,
                      l_rev: int):
    """Host-side scalars of the fused update: c1 = 1/sqrt(alpha),
    c2 = (1-alpha)/(sqrt(1-alpha_bar) sqrt(alpha)), sigma = sqrt(beta_tilde)
    and exactly 0 at the last step (``l_rev == 0``)."""
    c1 = 1.0 / math.sqrt(alpha)
    c2 = (1.0 - alpha) / (math.sqrt(1.0 - alpha_bar) * math.sqrt(alpha))
    sigma = math.sqrt(beta_tilde) if l_rev > 0 else 0.0
    return c1, c2, sigma


def _check_ddpm(x, eps_hat, noise):
    for name, t in (("eps_hat", eps_hat), ("noise", noise)):
        if t.device != x.device:
            raise ValueError(f"ddpm_step: {name} is on {t.device}, x on "
                             f"{x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"ddpm_step: {name} is {t.dtype}, x is "
                            f"{x.dtype}")
        if t.shape != x.shape:
            raise ValueError(f"ddpm_step: {name} has shape "
                             f"{tuple(t.shape)}, x {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"ddpm_step takes float32 or bfloat16, not {x.dtype}")
    if torch.is_grad_enabled() and noise.requires_grad:
        raise ValueError("ddpm_step gives no gradient to noise (a drawn "
                         "constant); pass it detached")


def _launch_elementwise(name: str, ptrs, n: int, scalars, dtype, t):
    """One call of ``<name>_launch`` from ddpm_step.cu on ``t``'s stream;
    counts the launch and its grids."""
    _check_cuda(name, t)
    grids = ctypes.c_int(0)
    err = _fn("ddpm_step", f"{name}_launch")(
        *ptrs, n, *scalars, _DTYPE_CODE[dtype], ctypes.byref(grids),
        _stream(t))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    GRIDS[name] += grids.value


def _ddpm_fwd(x, eps_hat, noise, c1, c2, sigma):
    if x.device.type == "cpu":
        return ref.ddpm_step_ref(x, eps_hat, noise, c1, c2, sigma)
    if x.device.type != "cuda":
        raise ValueError(f"ddpm_step runs on cuda or cpu, not {x.device}")
    _check_cuda("ddpm_step", eps_hat, noise)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    _launch_elementwise("ddpm_step", (x.data_ptr(), eps_hat.data_ptr(),
                                      noise.data_ptr(), out.data_ptr()),
                        x.numel(), (c1, c2, sigma), x.dtype, x)
    return out


def _ddpm_bwd(g, c1, c2):
    if g.device.type == "cpu":
        return ref.ddpm_step_bwd_ref(g, c1, c2)
    if g.device.type != "cuda":
        raise ValueError(f"ddpm_step_bwd runs on cuda or cpu, not "
                         f"{g.device}")
    dx = torch.empty_like(g, memory_format=torch.contiguous_format)
    deps = torch.empty_like(dx)
    _launch_elementwise("ddpm_step_bwd", (g.data_ptr(), dx.data_ptr(),
                                          deps.data_ptr()),
                        g.numel(), (c1, c2), g.dtype, g)
    return dx, deps


class DdpmStep(torch.autograd.Function):
    """``ddpm_step`` with a gradient: the forward kernel, and a backward
    that launches ``ddpm_step_bwd`` (dx = c1 g, d(eps_hat) = -c2 g; none
    to the noise).  On CPU tensors both run their plain versions, which
    take any float dtype (the f64 gradcheck)."""

    @staticmethod
    def forward(ctx, x, eps_hat, noise, c1: float, c2: float, sigma: float):
        ctx.coef = (c1, c2)
        return _ddpm_fwd(x, eps_hat, noise, c1, c2, sigma)

    @staticmethod
    def backward(ctx, g):
        dx, deps = _ddpm_bwd(g.contiguous(), *ctx.coef)
        return dx, deps, None, None, None, None


def ddpm_step(x, eps_hat, noise, alpha: float, alpha_bar: float,
              beta_tilde: float, l_rev: int):
    """Fused reverse-diffusion update; x/eps_hat/noise: (..., A), float32
    or bfloat16, same shape/dtype/device.  The schedule values are host
    floats (``DiffusionSchedule.host``), so no device read is needed.
    Returns a new tensor of ``x.dtype``.  Differentiable in ``x`` and
    ``eps_hat`` (``DdpmStep``); ``noise`` must not require a gradient."""
    _check_ddpm(x, eps_hat, noise)
    c1, c2, sigma = ddpm_coefficients(alpha, alpha_bar, beta_tilde, l_rev)
    if torch.is_grad_enabled() and (x.requires_grad
                                    or eps_hat.requires_grad):
        return DdpmStep.apply(x, eps_hat, noise, c1, c2, sigma)
    return _ddpm_fwd(x, eps_hat, noise, c1, c2, sigma)


def ddpm_step_bwd(g, c1: float, c2: float):
    """The backward of ``ddpm_step`` for its coefficients (``c1``, ``c2``
    of ``ddpm_coefficients``): ``(c1 * g, -c2 * g)`` in ``g.dtype``,
    float32 or bfloat16."""
    if g.dtype not in _DTYPE_CODE:
        raise TypeError(f"ddpm_step_bwd takes float32 or bfloat16, not "
                        f"{g.dtype}")
    return _ddpm_bwd(g, c1, c2)


# -- ddpm_chain -------------------------------------------------------------------

class ChainPlan(NamedTuple):
    cluster: int       # CTAs per cluster, each owning a slice of every
                       # layer; 1: the row-tiled plan (no cluster)
    rows: int          # rows of x per cluster, or per CTA when row-tiled
    smem_bytes: int    # dynamic shared memory of one CTA

    @property
    def row_tiled(self) -> bool:
        return self.cluster == 1


_CHAIN_THREADS, _CHAIN_MAX_ROWS, _CHAIN_CLUSTERS = 256, 8, (2, 4, 8)
# The row-tiled plan (ddpm_chain_kernel_rows): a CTA owns 32 whole rows,
# holds every per-step weight, and covers any layer with one micro-tile a
# thread, so hidden layers up to 128 wide and A up to 64.
_ROWS_TILE, _ROWS_MAX_HIDDEN, _ROWS_MAX_A = 32, 128, 64
# From how many rows the row-tiled plan runs, as measured on an H100 at
# both decide widths (CUDA graph, Table 2 / U = 18, L = 10; PERF.md): 15
# clusters of 8 CTAs run at once, so the cluster plan takes 0.0565 / 0.111
# ms up to R = 120; from R = 121 a 16th cluster runs in a second wave whose
# time grows with its rows, to 0.110 / 0.218 ms at R = 128.  The row-tiled
# plan takes 0.086 / 0.173 ms at any R up to 4096, and passes the cluster
# plan at R = 123 / 125.
CHAIN_ROW_TILED_FROM = 125


def _chain_smem_bytes(dims, cluster: int, rows: int) -> int:
    """The shared-memory layout that ddpm_chain.cu carves (its launch
    refuses bytes that disagree): two mbarriers (16 bytes), every layer's
    weight and bias slice, the rows' state share of layer 0, two input
    buffers, the own slice of x, two noise slices and two time
    embeddings."""
    total = 4
    for i, o in zip(dims[:-1], dims[1:]):
        cs = _cdiv(o, cluster)
        total = _cdiv(total, 4) * 4                    # 16-byte aligned
        total += i * ((cs + 27) // 32 * 32 + 4) + cs   # padded weight rows
    cs0, csl = _cdiv(dims[1], cluster), _cdiv(dims[-1], cluster)
    total += (rows * cs0 + 2 * rows * max(dims) + 3 * rows * csl
              + 2 * _CHAIN_THREADS)
    return 4 * total


def _chain_rows_smem_bytes(dims, rows: int) -> int:
    """The shared-memory layout that ddpm_chain_kernel_rows carves (the
    launch refuses bytes that disagree): every layer's weights (layer 0
    only x's rows) and bias, each row padded to a multiple of 4 floats; two
    transposed activation buffers of the widest layer output by rows + 4
    floats; two steps' time-embedding share of layer 0."""
    total = 0
    for l, (i, o) in enumerate(zip(dims[:-1], dims[1:])):
        total += ((dims[-1] if l == 0 else i) + 1) * _cdiv(o, 4) * 4
    total += 2 * max(dims[1:]) * (rows + 4) + 2 * _cdiv(dims[1], 4) * 4
    return 4 * total


def _chain_bwd_smem_bytes(dims, cluster: int, rows: int) -> int:
    """The shared-memory layout that ddpm_chain_bwd carves in ddpm_chain.cu
    (its launch refuses bytes that disagree): two mbarriers (16 bytes);
    per layer the own weight slice transposed, its dW and its db; two
    steps' activation rows [x, state, te, hidden...]; two buffers of the
    rows' own delta (as wide as the widest slice); the own slice of g; two
    buffers of every CTA's partials for the rows' own columns (as wide as
    the widest slice of x or a hidden layer)."""
    total = 4
    for i, o in zip(dims[:-1], dims[1:]):
        total += 2 * _cdiv(o, cluster) * i + _cdiv(o, cluster)
    csl = _cdiv(dims[-1], cluster)
    dlw = max(_cdiv(o, cluster) for o in dims[1:])
    rs = max([csl] + [_cdiv(d, cluster) for d in dims[1:-1]])
    total += (2 * rows * (dims[0] + sum(dims[1:-1])) + 2 * rows * dlw
              + rows * csl + 2 * cluster * rows * rs)
    return 4 * total


def _pick_chain_plan(name: str, smem_bytes, dims, R: int,
                     dtype) -> ChainPlan:
    """Up to 8 rows per cluster, and the largest cluster (2, 4 or 8 CTAs)
    that still gives each CTA at least 8 columns of the widest hidden layer,
    among those whose layout ``smem_bytes(dims, cluster, rows)`` fits
    (else the smallest that fits).  More CTAs split every layer's dot
    products further, which is what a layer's latency follows."""
    if dtype != torch.float32:
        raise TypeError(f"{name} takes float32, not {dtype}")
    dims = tuple(int(d) for d in dims)
    if not 2 <= len(dims) <= CHAIN_MAX_LAYERS + 1 or min(dims) < 1 or R < 1:
        raise ValueError(f"{name}: widths {dims} (1 to "
                         f"{CHAIN_MAX_LAYERS} layers) over {R} rows")
    rows = min(R, _CHAIN_MAX_ROWS)
    fits = [c for c in _CHAIN_CLUSTERS
            if smem_bytes(dims, c, rows) <= SMEM_LIMIT]
    if not fits:
        raise ValueError(
            f"{name}: widths {dims} need {smem_bytes(dims, 8, rows)} bytes "
            f"of shared memory in each of 8 CTAs, above the card's "
            f"{SMEM_LIMIT}")
    widest = max(dims[1:-1] or dims[1:])
    enough = [c for c in fits if widest // c >= 8]
    cluster = enough[-1] if enough else fits[0]
    return ChainPlan(cluster, rows, smem_bytes(dims, cluster, rows))


def _row_tiled_plan(dims) -> Optional[ChainPlan]:
    """The row-tiled plan for these widths, or None where its layout does
    not cover them."""
    if (len(dims) < 3 or max(dims[1:-1]) > _ROWS_MAX_HIDDEN
            or dims[-1] > _ROWS_MAX_A):
        return None
    smem = _chain_rows_smem_bytes(dims, _ROWS_TILE)
    return ChainPlan(1, _ROWS_TILE, smem) if smem <= SMEM_LIMIT else None


def _cluster_chain_plan(dims, R: int, dtype=torch.float32) -> ChainPlan:
    """``ddpm_chain``'s cluster plan at any R (``_pick_chain_plan``)."""
    return _pick_chain_plan("ddpm_chain", _chain_smem_bytes, dims, R, dtype)


@functools.lru_cache(maxsize=256)
def chain_plan(dims: tuple, R: int, dtype=torch.float32) -> ChainPlan:
    """Launch choices of ``ddpm_chain`` for an MLP of widths ``dims`` (in,
    hidden..., A) over R rows: from ``CHAIN_ROW_TILED_FROM`` rows on, the
    row-tiled plan where its layout covers the widths
    (``_row_tiled_plan``), else the cluster plan.  Raises when even 8 CTAs
    cannot hold the weights, or for a dtype other than float32."""
    plan = _cluster_chain_plan(dims, R, dtype)
    if R >= CHAIN_ROW_TILED_FROM:
        return _row_tiled_plan(dims) or plan
    return plan


@functools.lru_cache(maxsize=256)
def chain_bwd_plan(dims: tuple, R: int, dtype=torch.float32) -> ChainPlan:
    """Launch choices of ``ddpm_chain_bwd``, picked as ``chain_plan``'s
    from the backward's layout.  Raises when even 8 CTAs cannot hold a
    layer's slices and their gradients, or for a dtype other than
    float32."""
    return _pick_chain_plan("ddpm_chain_bwd", _chain_bwd_smem_bytes, dims,
                            R, dtype)


def chain_record_width(dims) -> int:
    """Floats of one row of one step in the forward's record: x (A), then
    every hidden layer's output after its ReLU."""
    return dims[-1] + sum(dims[1:-1])


class _Weights(NamedTuple):
    """An MLP's layers as ``ref`` reads them (``w`` (in, out), ``b``
    (out,)), from the tensors an autograd Function was given."""
    w: list
    b: list


def _check_chain(ws, bs, x_L, state, noises, coef, te) -> tuple:
    """The MLP's widths, once every tensor is f32 and contiguous, every
    shape fits the chain (on either device: the kernel reads the tensors
    in place) and no draw or state asks for a gradient.

    One learner: ``w`` (in, out), ``b`` (out,), x_L (R, A), state (R, S),
    noises (L, R, A).  B stacked learners: every ``w`` (B, in, out), every
    ``b`` (B, out), x_L (B, R, A), state (B, R, S), noises (B, L, R, A).
    Layers of both forms, or of different B, are refused; so are
    non-contiguous weights (an expanded or strided stack), whose learner
    stride is not the layer's size."""
    for t in (x_L, state, noises, coef, te, *ws, *bs):
        if t.dtype != torch.float32:
            raise TypeError(f"ddpm_chain takes float32 tensors, not "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError("ddpm_chain: the kernel takes contiguous "
                             "tensors")
    stacked = bool(ws) and ws[0].dim() == 3
    lead = (x_L.shape[0],) if stacked and x_L.dim() == 3 else ()
    if (any(w.dim() != (3 if stacked else 2) for w in ws)
            or any(b.dim() != (2 if stacked else 1) for b in bs)
            or x_L.dim() != 2 + len(lead) or state.dim() != 2 + len(lead)
            or noises.dim() != 3 + len(lead)):
        raise ValueError(
            "ddpm_chain: x_L (R, A), state (R, S), noises (L, R, A) with "
            "w (in, out) and b (out,); or, for B stacked learners, x_L "
            "(B, R, A), state (B, R, S), noises (B, L, R, A) with every w "
            "(B, in, out) and b (B, out)")
    (R, A), L = x_L.shape[len(lead):], noises.shape[len(lead)]
    if (R < 1 or L < 1 or tuple(state.shape[:-1]) != lead + (R,)
            or tuple(noises.shape) != lead + (L, R, A)
            or tuple(coef.shape) != (L, 3) or te.dim() != 2
            or te.shape[0] != L or (lead and lead[0] < 1)):
        raise ValueError(
            f"ddpm_chain: x_L {tuple(x_L.shape)}, state "
            f"{tuple(state.shape)}, noises {tuple(noises.shape)}, coef "
            f"{tuple(coef.shape)}, te {tuple(te.shape)} do not fit")
    wsh = [tuple(w.shape[len(lead):]) for w in ws]
    dims = tuple([wsh[0][0]] + [w[1] for w in wsh]) if ws else ()
    if (not 1 <= len(ws) <= CHAIN_MAX_LAYERS or len(bs) != len(ws)
            or any(tuple(w.shape[:len(lead)]) != lead
                   or tuple(b.shape) != lead + (o,) or sh != (i, o)
                   for w, b, sh, i, o in zip(ws, bs, wsh, dims[:-1],
                                             dims[1:]))
            or dims[0] != A + state.shape[-1] + te.shape[1]
            or dims[-1] != A):
        raise ValueError(f"ddpm_chain: the MLP's layers "
                         f"{[tuple(w.shape) for w in ws]} do not map "
                         f"[x, state, te] of widths {A}, {state.shape[-1]}, "
                         f"{te.shape[1]} to {A}"
                         + (f" for {lead[0]} learners" if lead else ""))
    if torch.is_grad_enabled():
        for name, t in (("x_L", x_L), ("state", state), ("noises", noises),
                        ("coef", coef), ("te", te)):
            if t.requires_grad:
                raise ValueError(f"ddpm_chain gives no gradient to {name} "
                                 "(only to the MLP's weights and biases); "
                                 "pass it detached")
    return dims


@functools.lru_cache(maxsize=64)
def _chain_net(w_ptrs: tuple, b_ptrs: tuple, dims: tuple,
               learners: int) -> _ChainNet:
    """The ``ChainNet`` of an MLP's widths and weight addresses, built once
    for each (an update writes its weights in place, so their addresses
    stay).  Stacked weights are contiguous (``_check_chain``), so a
    learner's stride is its layer's size."""
    pad = (None,) * (CHAIN_MAX_LAYERS - len(w_ptrs))
    zeros = (0,) * (CHAIN_MAX_LAYERS - len(w_ptrs))
    return _ChainNet(
        len(w_ptrs), (ctypes.c_int * (CHAIN_MAX_LAYERS + 1))(*dims),
        (ctypes.c_void_p * CHAIN_MAX_LAYERS)(*w_ptrs, *pad),
        (ctypes.c_void_p * CHAIN_MAX_LAYERS)(*b_ptrs, *pad), learners,
        (ctypes.c_int64 * CHAIN_MAX_LAYERS)(
            *(i * o for i, o in zip(dims[:-1], dims[1:])), *zeros),
        (ctypes.c_int64 * CHAIN_MAX_LAYERS)(*dims[1:], *zeros))


def _chain_net_of(ws, bs, dims) -> _ChainNet:
    return _chain_net(tuple(w.data_ptr() for w in ws),
                      tuple(b.data_ptr() for b in bs), dims,
                      ws[0].shape[0] if ws[0].dim() == 3 else 1)


def _chain_fwd(ws, bs, x_L, state, noises, coef, te, record: bool,
               dims=None, plan=None):
    """x_0, and with ``record`` also the ((B,) L, R, ``chain_record_width``)
    record of every step's x and hidden outputs; one ``ddpm_chain`` launch
    for CUDA tensors (all B learners of stacked weights in it), the plain
    version for CPU tensors (any float dtype there: the f64 gradcheck).
    ``dims``: the widths ``_check_chain`` returned, or None to check
    here.  ``plan``: ``chain_plan``'s unless given (a card test or timing
    that holds the two plans side by side)."""
    if x_L.device.type == "cpu":
        plain = (ref.ddpm_chain_stacked_ref if ws[0].dim() == 3
                 else ref.ddpm_chain_ref)
        with torch.no_grad():
            return plain(_Weights(ws, bs), x_L, state, noises, coef, te,
                         record=record)
    if dims is None:
        dims = _check_chain(ws, bs, x_L, state, noises, coef, te)
    _check_cuda("ddpm_chain", x_L, state, noises, coef, te, *ws, *bs)
    lead = tuple(x_L.shape[:-2])
    R, L = x_L.shape[-2], coef.shape[0]
    if plan is None:
        plan = chain_plan(dims, R)
    out = torch.empty_like(x_L)
    rec = (torch.empty(lead + (L, R, chain_record_width(dims)),
                       dtype=x_L.dtype, device=x_L.device)
           if record else None)
    started = (ctypes.c_int * 2)()
    err = _fn("ddpm_chain", "ddpm_chain_launch")(
        _chain_net_of(ws, bs, dims), x_L.data_ptr(), state.data_ptr(),
        noises.data_ptr(), coef.data_ptr(), te.data_ptr(), out.data_ptr(),
        rec.data_ptr() if record else None, R, L, state.shape[-1],
        te.shape[1], plan.cluster, plan.rows, plan.smem_bytes, started,
        _stream(x_L))
    if err != 0:
        raise RuntimeError(f"ddpm_chain kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["ddpm_chain"] += 1
    GRIDS["ddpm_chain"] += started[0]
    CLUSTERS["ddpm_chain"] += started[1]
    ROW_TILED["ddpm_chain"] += plan.row_tiled
    return (out, rec) if record else out


def _chain_bwd(ws, bs, record, state, coef, te, g):
    """(dws, dbs) of the chain for the upstream gradient g ((B,) R, A): one
    ``ddpm_chain_bwd`` launch for CUDA tensors (all B learners of stacked
    weights in it, each learner's gradients apart), the plain version for
    CPU tensors."""
    stacked = ws[0].dim() == 3
    if g.device.type == "cpu":
        plain = (ref.ddpm_chain_bwd_stacked_ref if stacked
                 else ref.ddpm_chain_bwd_ref)
        return plain(_Weights(ws, bs), record, state, coef, te, g)
    lead = tuple(ws[0].shape[:1]) if stacked else ()
    dims = tuple([ws[0].shape[-2]] + [w.shape[-1] for w in ws])
    for t in (record, state, coef, te, g, *ws, *bs):
        if t.dtype != torch.float32:
            raise TypeError(f"ddpm_chain_bwd takes float32 tensors, not "
                            f"{t.dtype}")
    _check_cuda("ddpm_chain_bwd", record, state, coef, te, g, *ws, *bs)
    L = coef.shape[0]
    R, A = g.shape[-2:]
    if (tuple(g.shape[:-2]) != lead
            or tuple(record.shape) != lead + (L, R, chain_record_width(dims))
            or tuple(state.shape[:-1]) != lead + (R,) or A != dims[-1]
            or dims[0] != A + state.shape[-1] + te.shape[1]):
        raise ValueError(f"ddpm_chain_bwd: record {tuple(record.shape)}, "
                         f"state {tuple(state.shape)}, g {tuple(g.shape)} "
                         f"do not fit the widths {dims} over {L} steps"
                         + (f" for {lead[0]} learners" if lead else ""))
    plan = chain_bwd_plan(dims, R)
    n_params = sum((i + 1) * o for i, o in zip(dims[:-1], dims[1:]))
    B = lead[0] if lead else 1
    flat = torch.empty(lead + (n_params,), dtype=g.dtype, device=g.device)
    clusters = _cdiv(R, plan.rows)
    scratch = (torch.empty(B * clusters * n_params, dtype=g.dtype,
                           device=g.device) if clusters > 1 else None)
    started = (ctypes.c_int * 2)()
    err = _fn("ddpm_chain", "ddpm_chain_bwd_launch")(
        _chain_net_of(ws, bs, dims), record.data_ptr(), state.data_ptr(),
        coef.data_ptr(), te.data_ptr(), g.data_ptr(), flat.data_ptr(),
        scratch.data_ptr() if clusters > 1 else None, R, L,
        state.shape[-1], te.shape[1], plan.cluster, plan.rows,
        plan.smem_bytes, started, _stream(g))
    if err != 0:
        raise RuntimeError(f"ddpm_chain_bwd kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["ddpm_chain_bwd"] += 1
    GRIDS["ddpm_chain_bwd"] += started[0]
    CLUSTERS["ddpm_chain_bwd"] += started[1]
    dws, dbs, off = [], [], 0
    for i, o in zip(dims[:-1], dims[1:]):
        dws.append(flat[..., off:off + i * o].view(lead + (i, o)))
        dbs.append(flat[..., off + i * o:off + (i + 1) * o])
        off += (i + 1) * o
    return dws, dbs


class DdpmChain(torch.autograd.Function):
    """``ddpm_chain`` with a gradient to the MLP's weights and biases: the
    forward launches ``ddpm_chain`` with its record, the backward one
    ``ddpm_chain_bwd``.  On CPU tensors both run their plain versions,
    which take any float dtype (the f64 gradcheck).

    ``apply(x_L, state, noises, coef, te, dims, *ws, *bs)``, with ``dims``
    the widths from ``_check_chain`` or None; x_L, state and noises get no
    gradient."""

    @staticmethod
    def forward(ctx, x_L, state, noises, coef, te, dims, *params):
        n = len(params) // 2
        ws, bs = list(params[:n]), list(params[n:])
        x0, record = _chain_fwd(ws, bs, x_L, state, noises, coef, te, True,
                                dims)
        ctx.save_for_backward(record, state, coef, te, *params)
        return x0

    @staticmethod
    def backward(ctx, g):
        record, state, coef, te, *params = ctx.saved_tensors
        n = len(params) // 2
        dws, dbs = _chain_bwd(params[:n], params[n:], record, state, coef,
                              te, g.contiguous())
        return (None,) * 6 + tuple(dws) + tuple(dbs)


def ddpm_chain(net, x_L, state, noises, coef, te, *, record: bool = False):
    """A whole reverse chain: for l_rev = L-1 .. 0, eps_hat =
    ``net([x, state, te[l_rev]])`` and the ``ddpm_step`` update with
    ``coef[l_rev]`` = [c1, c2, sigma] and ``noises[L-1-l_rev]``.

    net: the denoiser's ``MLP`` (``w`` (in, out), ``b`` (out,)); x_L (R, A),
    state (R, S), noises (L, R, A), coef (L, 3), te (L, T): float32, one
    device.  Returns x_0 (R, A), before the sampler's tanh.  One launch on
    the card, however long the chain.  For B stacked learners (a
    ``StackedMLP``: every ``w`` (B, in, out), ``b`` (B, out)) x_L is
    (B, R, A), state (B, R, S), noises (B, L, R, A) (each learner's own
    draws, as ``reverse_sample_stacked`` makes them) and x_0 (B, R, A):
    still one launch, and on the card each learner's slice is the same bits
    as a launch on that learner's weights alone.  When grad mode is on and
    a weight or bias requires a gradient, x_0 carries the graph
    (``DdpmChain``:
    ``ddpm_chain_bwd`` in the backward); x_L, state and noises must not
    require one.  ``record=True`` returns ``(x_0, record)`` without a
    graph, the record as ``ddpm_chain_bwd`` reads it."""
    if profiling.ON:
        with profiling.span("ops.ddpm_chain"):
            return _ddpm_chain(net, x_L, state, noises, coef, te, record)
    return _ddpm_chain(net, x_L, state, noises, coef, te, record)


def _ddpm_chain(net, x_L, state, noises, coef, te, record):
    ws, bs = list(net.w), list(net.b)
    _check_device("ddpm_chain", x_L, state, noises, coef, te, *ws, *bs)
    dims = _check_chain(ws, bs, x_L, state, noises, coef, te)
    if not record and torch.is_grad_enabled() and any(
            t.requires_grad for t in ws + bs):
        return DdpmChain.apply(x_L, state, noises, coef, te, dims, *ws, *bs)
    return _chain_fwd(ws, bs, x_L, state, noises, coef, te, record, dims)


def ddpm_chain_bwd(net, record, state, coef, te, g):
    """The chain's backward for the upstream gradient g = dloss/dx_0 (R, A):
    ``(dws, dbs)``, the gradients of the MLP's ``w`` (in, out) and ``b``
    (out,), from the ``record`` of ``ddpm_chain(..., record=True)`` on the
    same inputs.  float32, one device: one launch on the card.  Stacked
    weights take g (B, R, A), the record (B, L, R, W) and state (B, R, S)
    and give every learner's own (B, ...) gradients, in one launch."""
    ws, bs = list(net.w), list(net.b)
    _check_device("ddpm_chain_bwd", record, state, coef, te, g, *ws, *bs)
    if g.dtype != torch.float32:
        raise TypeError(f"ddpm_chain_bwd takes float32 tensors, not "
                        f"{g.dtype}")
    with torch.no_grad():
        return _chain_bwd(ws, bs, record, state, coef, te, g)


# -- flash_attention --------------------------------------------------------------

def _check_flash(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q (B, L, H, D) and k/v "
                         "(B, S, Hkv, D) are 4-D")
    B, L, H, D = q.shape
    if k.shape[:3] != v.shape[:3] or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    if k.shape[2] < 1 or H % k.shape[2]:
        raise ValueError(f"flash_attention: {H} heads do not group over "
                         f"{k.shape[2]} kv heads")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q/k/v of "
                        f"one dtype, not {q.dtype}/{k.dtype}/{v.dtype}")
    flash_plan(q.dtype, D, v.shape[3])
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    if B < 1 or L < 1 or k.shape[1] < 1:
        raise ValueError(f"flash_attention: empty batch, queries or keys "
                         f"(B = {B}, L = {L}, S = {k.shape[1]})")
    _check_no_grad("flash_attention", q, k, v)


class FlashPlan(NamedTuple):
    kernel: str        # "mma_bf16" (tensor cores) or "simt_f32" (CUDA cores)
    dtype_code: int    # what flash_attention_launch dispatches on


def flash_plan(dtype, d_head: Optional[int] = None,
               d_v: Optional[int] = None) -> FlashPlan:
    """The kernel ``flash_attention`` takes for q/k/v of ``dtype``: bf16
    goes to the tensor-core kernel, f32 to the CUDA-core one (TF32 would
    miss the f32 tolerance).  Both are built for the head dims of
    ``FLASH_HEAD_DIMS`` (the C switch's) with v as wide as q and k, and
    for the pairs of ``FLASH_HEAD_PAIRS``; another ``d_head`` (q and k)
    and ``d_v`` (v; default ``d_head``) are refused."""
    d_v = d_head if d_v is None else d_v
    if d_head is not None and not (
            (d_v == d_head and d_head in FLASH_HEAD_DIMS)
            or (d_head, d_v) in FLASH_HEAD_PAIRS):
        raise ValueError(f"flash_attention takes d_head in "
                         f"{FLASH_HEAD_DIMS} (v as wide) or (q/k, v) in "
                         f"{tuple(FLASH_HEAD_PAIRS)}, not ({d_head}, "
                         f"{d_v})")
    if dtype == torch.bfloat16:
        return FlashPlan("mma_bf16", 1)
    if dtype == torch.float32:
        return FlashPlan("simt_f32", 0)
    raise TypeError(f"flash_attention takes float32 or bfloat16, not {dtype}")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    scale: Optional[float] = None):
    """Causal (or full) GQA attention with an optional sliding window.

    q: (B, L, H, D); k: (B, S, Hkv, D); v: (B, S, Hkv, DV), DV = D or a
    pair of ``FLASH_HEAD_PAIRS`` — the model layout, as
    ``repro.kernels.ops.flash_attention``; query i attends keys j <= i
    (causal) and j > i - window.  ``scale`` defaults to 1/sqrt(D).
    Returns (B, L, H, DV) in q.dtype."""
    dev = _check_device("flash_attention", q, k, v)
    _check_flash(q, k, v, window)
    scale = 1.0 / math.sqrt(q.shape[3]) if scale is None else float(scale)
    if dev.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       scale=scale)
    _check_cuda("flash_attention", q, k, v)
    B, L, H, D = q.shape
    S, Hkv, DV = k.shape[1], k.shape[2], v.shape[3]
    plan = flash_plan(q.dtype)
    if plan.kernel == "mma_bf16" and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
        raise ValueError("flash_attention: the bf16 kernel takes q/k/v "
                         "aligned to 16 bytes")
    out = q.new_empty((B, L, H, DV))
    grids = ctypes.c_int(0)
    err = _fn("flash_attention", "flash_attention_launch")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, L, S, H,
        Hkv, D, DV, int(causal), -1 if window is None else int(window),
        scale, plan.dtype_code, ctypes.byref(grids), _stream(q))
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    key = FLASH_HEAD_PAIRS.get((D, DV), "flash_attention")
    LAUNCHES[key] += 1
    GRIDS[key] += grids.value
    return out


# -- ssd_scan ---------------------------------------------------------------------

def _check_ssd(x, dt, A, Bm, Cm, D, chunk):
    if x.dim() != 4:
        raise ValueError("ssd_scan: x is (B, L, H, P)")
    B, L, H, P = x.shape
    if Bm.dim() != 4 or Bm.shape != Cm.shape or Bm.shape[:2] != (B, L):
        raise ValueError(f"ssd_scan: B/C {tuple(Bm.shape)}/{tuple(Cm.shape)} "
                         f"do not fit x {tuple(x.shape)}")
    G = Bm.shape[2]
    if tuple(dt.shape) != (B, L, H) or tuple(A.shape) != (H,) \
            or tuple(D.shape) != (H,):
        raise ValueError(f"ssd_scan: dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, D {tuple(D.shape)} do not fit x "
                         f"{tuple(x.shape)}")
    if G < 1 or H % G:
        raise ValueError(f"ssd_scan: {H} heads do not group over {G}")
    if L < 1 or chunk < 1:
        raise ValueError(f"ssd_scan: L = {L}, chunk = {chunk}")
    for t in (x, dt, A, Bm, Cm, D):
        if not t.is_floating_point():
            raise TypeError(f"ssd_scan takes floating tensors, not {t.dtype}")
    _check_no_grad("ssd_scan", x, dt, A, Bm, Cm, D)


class SSDPlan(NamedTuple):
    chunk: int            # Q = min(chunk, L)
    n_chunks: int
    one_chunk: bool       # L <= chunk: one grid, no scratch
    scratch: tuple        # shapes of the f32 scratch: chunk states, decays
    smem_bytes: int       # dynamic shared memory of the largest CTA


_SSD_ROWS, _SSD_PCOLS, _SSD_SP, _SSD_SN, _SSD_WARPS = 32, 64, 32, 64, 8


@functools.lru_cache(maxsize=256)
def ssd_plan(B: int, L: int, H: int, P: int, N: int,
             chunk: int) -> SSDPlan:
    """What ``ssd_scan`` needs before it launches: the chunk, the f32
    scratch of the three-grid split (none for one chunk), and the shared
    memory of the largest CTA, a copy of the C ``ssd_scan_smem_bytes``
    (the card tests hold the two equal) so the wrapper can refuse a shape
    with a message."""
    Q = min(chunk, L)
    nc = _cdiv(L, Q)
    n_stride = _cdiv(N, 4) * 4 + 4
    # a_cs in f64 (Q doubles), the scan's warp totals (in f64), dt (Q)
    scan = 3 * Q + 2 * _SSD_WARPS
    states = _SSD_ROWS * (_SSD_SP + 1) + _SSD_ROWS * (_SSD_SN + 1) + scan
    out = (2 * _SSD_ROWS * n_stride + _SSD_PCOLS * 36
           + _SSD_ROWS * (_SSD_PCOLS + 1) + _SSD_ROWS * (_SSD_ROWS + 1)
           + scan)
    scratch = () if nc == 1 else ((B, nc, H, P, N), (B, nc, H))
    return SSDPlan(Q, nc, nc == 1, scratch, 4 * max(states, out))


def ssd_scan(x, dt, A, Bm, Cm, D, *, chunk: int = 128):
    """Mamba2 chunked SSD.  x: (B, L, H, P); dt: (B, L, H); A/D: (H,);
    Bm/Cm: (B, L, G, N).  Inputs are cast to f32 (as the JAX wrapper does);
    returns (y (B, L, H, P) f32, final state (B, H, P, N) f32).  A ragged
    last chunk gives what the JAX wrapper's dt = 0 padding gives."""
    dev = _check_device("ssd_scan", x, dt, A, Bm, Cm, D)
    _check_ssd(x, dt, A, Bm, Cm, D, chunk)
    f32 = [t.float().contiguous() for t in (x, dt, A, Bm, Cm, D)]
    if dev.type == "cpu":
        return ref.ssd_scan_ref(*f32, chunk=chunk)
    _check_cuda("ssd_scan", *f32)
    B, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    plan = ssd_plan(B, L, H, P, N, chunk)
    if plan.smem_bytes > SMEM_LIMIT:
        raise ValueError(f"ssd_scan: chunk {plan.chunk}, head dim {P} and "
                         f"state {N} need {plan.smem_bytes} bytes of shared "
                         f"memory, above the card's {SMEM_LIMIT}")
    y = torch.empty((B, L, H, P), dtype=torch.float32, device=dev)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    scratch = [torch.empty(s, dtype=torch.float32, device=dev)
               for s in plan.scratch]
    ptrs = [t.data_ptr() for t in scratch] or [None, None]
    grids = ctypes.c_int(0)
    err = _fn("ssd_scan", "ssd_scan_launch")(
        *(t.data_ptr() for t in f32), y.data_ptr(), state.data_ptr(), *ptrs,
        B, L, H, G, P, N, plan.chunk, ctypes.byref(grids), _stream(y))
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    LAUNCHES["ssd_scan"] += 1
    GRIDS["ssd_scan"] += grids.value
    return y, state
