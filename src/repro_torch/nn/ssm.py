"""Mamba2 / SSD (state-space duality) block (port of ``repro.nn.ssm``).

The input projection gives ``[z (d_inner), x (d_inner), B (G·N), C (G·N),
dt (H)]``; x/B/C pass through a short causal depthwise conv; the SSD mixes
the sequence; a gated RMSNorm and the output projection close the block.
``ssm_forward`` runs the SSD through the hand-written ``ssd_scan`` kernel
(``impl="kernel"``, the default) or through ``ssd_reference``
(``impl="plain"``, the JAX ``impl="xla"``; ``"chunked"``, the attention
layers' training path, also runs ``ssd_reference`` here, as the
reference's does).  Decode keeps a constant-size
state: the conv tail (width-1 tokens) and the SSM state (H, P, N).

Under a mesh (DTensor parameters and inputs; the reference's
``ssm_spec`` and ``ssm_state_spec``): ``in_proj``'s output ``[z | xBC |
dt]`` is split over ``"model"`` in contiguous column blocks, not by
head, so ``_split_proj`` slices the global DTensor layout (DTensor
gathers it) and the conv runs on DTensors.  The SSD then runs on this
rank's heads in a local region (``sharding.Region``) opened at the
reference's ``constrain`` of x, where the rank takes its heads' dt, A
and D and the B/C groups its heads read; the scan's output crosses the
reference's ``constrain`` back, and the gated norm and ``out_proj`` are
DTensor ops.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops

from .core import linear, linear_init, rmsnorm, silu
from .sharding import P, Region, batch_spec, constrain, like


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_model: int
    d_inner: int                 # = expand * d_model (H * head_dim)
    head_dim: int = 64           # P
    n_groups: int = 1            # G (B/C groups)
    d_state: int = 128           # N
    conv_width: int = 4
    chunk: int = 128             # Q — SSD chunk length
    dt_min: float = 0.001
    dt_max: float = 0.1

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def ssm_init(generator: torch.Generator, cfg: SSMCfg, *,
             dtype=torch.float32) -> dict:
    """A_log = log(1..H); dt_bias = inverse softplus of dt0, with dt0
    log-uniform in [dt_min, dt_max] (the mamba2 init)."""
    dev = generator.device
    H, G, N = cfg.n_heads, cfg.n_groups, cfg.d_state
    d_in_proj = 2 * cfg.d_inner + 2 * G * N + H
    d_conv = cfg.d_inner + 2 * G * N     # x, B, C share the conv
    u = torch.rand(H, generator=generator, device=dev)
    dt0 = torch.exp(u * (math.log(cfg.dt_max) - math.log(cfg.dt_min))
                    + math.log(cfg.dt_min))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
    conv_w = torch.randn((cfg.conv_width, d_conv), generator=generator,
                         device=dev) * (1.0 / math.sqrt(cfg.conv_width))
    return {
        "in_proj": linear_init(generator, cfg.d_model, d_in_proj,
                               dtype=dtype),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros(d_conv, dtype=dtype, device=dev),
        "A_log": torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                        device=dev)),
        "D": torch.ones(H, dtype=torch.float32, device=dev),
        "dt_bias": dt_bias.float(),
        "norm": {"scale": torch.ones(cfg.d_inner, dtype=dtype, device=dev)},
        "out_proj": linear_init(generator, cfg.d_inner, cfg.d_model,
                                dtype=dtype),
    }


def ssm_spec(cfg: SSMCfg) -> dict:
    return {"in_proj": {"w": P(None, "model")},
            "conv_w": P(None, "model"),
            "conv_b": P("model"),
            "A_log": P(None),
            "D": P(None),
            "dt_bias": P(None),
            "norm": {"scale": P(None)},
            "out_proj": {"w": P("model", None)}}


def _split_proj(cfg: SSMCfg, zxbcdt):
    GN2 = 2 * cfg.n_groups * cfg.d_state
    di = cfg.d_inner
    return (zxbcdt[..., :di], zxbcdt[..., di: 2 * di + GN2],
            zxbcdt[..., 2 * di + GN2:])


def _causal_conv(xBC, w, b, *, tail: Optional[torch.Tensor] = None):
    """Depthwise causal conv over time.  xBC: (B, L, Dc); w: (W, Dc);
    ``tail``: (B, W-1, Dc) previous tokens.  Returns (silu(conv + b), the
    new tail)."""
    W = w.shape[0]
    L = xBC.shape[1]
    if tail is None:
        tail = xBC.new_zeros(xBC.shape[:1] + (W - 1,) + xBC.shape[2:])
    xpad = torch.cat([tail, xBC], dim=1)
    out = xpad[:, 0:L, :] * w[0]
    for i in range(1, W):
        out = out + xpad[:, i: i + L, :] * w[i]
    return silu(out + b), xpad[:, -(W - 1):, :]


def ssd_reference(x, dt, A, Bm, Cm, D, *, chunk: int,
                  init_state: Optional[torch.Tensor] = None,
                  return_state: bool = False):
    """Chunked SSD.  x:(B,L,H,P) dt:(B,L,H) A:(H) Bm/Cm:(B,L,G,N) D:(H).
    Returns y:(B,L,H,P) [and the final state (B,H,P,N)]; all math in f32.
    A ragged L is padded with dt = 0 steps, which are inert."""
    Bsz, L, H, Pd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Q = min(chunk, L)
    Lorig = L
    if L % Q:
        pad = Q - L % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        L = L + pad
    nc = L // Q

    xf, dtf, Af, Df = x.float(), dt.float(), A.float(), D.float()
    Bf = torch.repeat_interleave(Bm.float(), rep, dim=2)     # (B,L,H,N)
    Cf = torch.repeat_interleave(Cm.float(), rep, dim=2)
    xc = xf.reshape(Bsz, nc, Q, H, Pd)
    dtc = dtf.reshape(Bsz, nc, Q, H)
    Bc = Bf.reshape(Bsz, nc, Q, H, N)
    Cc = Cf.reshape(Bsz, nc, Q, H, N)

    a_cs = torch.cumsum(dtc * Af, dim=2)          # (B,nc,Q,H) log-decay
    # intra-chunk: mask before the exp (exp of a positive seg may overflow)
    seg = a_cs[:, :, :, None, :] - a_cs[:, :, None, :, :]    # (B,nc,Q,Q,H)
    ii = torch.arange(Q, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    Lmat = torch.exp(torch.where(causal, seg, torch.full_like(seg, -math.inf)))
    CB = torch.einsum("bcihn,bcjhn->bcijh", Cc, Bc)
    M = CB * Lmat * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", M, xc)

    decay_to_end = torch.exp(a_cs[:, :, -1:, :] - a_cs)      # (B,nc,Q,H)
    Sc = torch.einsum("bcqh,bcqhn,bcqhp->bchpn", decay_to_end * dtc, Bc, xc)
    chunk_decay = torch.exp(a_cs[:, :, -1, :])                # (B,nc,H)

    S = (torch.zeros((Bsz, H, Pd, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    S_prev = []
    for c in range(nc):
        S_prev.append(S)
        S = S * chunk_decay[:, c, :, None, None] + Sc[:, c]
    S_prev = torch.stack(S_prev, dim=1)                       # (B,nc,H,P,N)

    y_inter = torch.einsum("bcqhn,bchpn->bcqhp",
                           Cc * torch.exp(a_cs)[..., None], S_prev)
    y = (y_intra + y_inter).reshape(Bsz, L, H, Pd)[:, :Lorig]
    y = y + xf[:, :Lorig] * Df[None, None, :, None]
    if return_state:
        return y, S
    return y


def ssm_forward(p: dict, cfg: SSMCfg, xin: torch.Tensor, *,
                impl: str = "kernel", compute_dtype=torch.bfloat16,
                return_state: bool = False):
    """Full-sequence Mamba2 block.  xin: (B, L, d_model)."""
    if impl not in ("kernel", "plain", "chunked"):
        raise ValueError(f"impl must be 'kernel', 'plain' or 'chunked', not "
                         f"{impl!r}")
    Bsz, L, _ = xin.shape
    H, G, N = cfg.n_heads, cfg.n_groups, cfg.d_state
    zxbcdt = linear(p["in_proj"], xin, compute_dtype=compute_dtype)
    z, xBC, dt = _split_proj(cfg, zxbcdt)
    xBC, conv_tail = _causal_conv(xBC, p["conv_w"].to(compute_dtype),
                                  p["conv_b"].to(compute_dtype))
    di = cfg.d_inner
    x = xBC[..., :di].reshape(Bsz, L, H, cfg.head_dim)
    Bm = xBC[..., di: di + G * N].reshape(Bsz, L, G, N)
    Cm = xBC[..., di + G * N:].reshape(Bsz, L, G, N)
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    # the local region: the SSD on this rank's heads
    reg = Region(x)
    x = reg.open(x, batch_spec(None, "model", None))
    D = p["D"]
    if reg.active:
        heads = P("model" if reg.sharded("model") else None)
        dt = reg.take(dt, batch_spec(None, "model"))
        A, D = reg.take(A, heads), reg.take(D, heads)
        Bm, Cm = reg.groups_of_heads((reg.take(Bm), reg.take(Cm)), 2, H, G,
                                     x.shape[2])
    if impl == "kernel":
        y, S = kops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=cfg.chunk)
    else:
        y, S = ssd_reference(x, dt, A, Bm, Cm, D, chunk=cfg.chunk,
                             return_state=True)
    y = y.to(compute_dtype).reshape(y.shape[:2] + (-1,))
    if reg.active:
        y = reg.give_spec(y, reg.spec(None, "model"))
        S = reg.give_spec(S, reg.spec("model", None, None))
    y = constrain(y, batch_spec(None, "model"))
    y = rmsnorm(p["norm"], y * silu(z))            # gated RMSNorm
    out = linear(p["out_proj"], y, compute_dtype=compute_dtype)
    if return_state:
        return out, {"conv": conv_tail, "ssm": S}
    return out


def init_ssm_state(B: int, cfg: SSMCfg, dtype=torch.bfloat16,
                   device=None) -> dict:
    d_conv = cfg.d_inner + 2 * cfg.n_groups * cfg.d_state
    return {"conv": torch.zeros((B, cfg.conv_width - 1, d_conv), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((B, cfg.n_heads, cfg.head_dim, cfg.d_state),
                               dtype=torch.float32, device=device)}


def ssm_state_spec(cfg: SSMCfg) -> dict:
    return {"conv": batch_spec(None, "model"),
            "ssm": batch_spec("model", None, None)}


def ssm_decode(p: dict, cfg: SSMCfg, xin: torch.Tensor, state: dict, *,
               compute_dtype=torch.bfloat16):
    """One-token decode.  xin: (B, 1, d_model); state {"conv", "ssm"}.
    Returns (y, new_state)."""
    Bsz = xin.shape[0]
    H, G, N = cfg.n_heads, cfg.n_groups, cfg.d_state
    di = cfg.d_inner
    zxbcdt = linear(p["in_proj"], xin, compute_dtype=compute_dtype)
    z, xBC, dt = _split_proj(cfg, zxbcdt)
    xBC, conv_tail = _causal_conv(
        xBC, p["conv_w"].to(compute_dtype), p["conv_b"].to(compute_dtype),
        tail=state["conv"].to(compute_dtype))
    x = xBC[:, 0, :di].reshape(Bsz, H, cfg.head_dim)
    Bm = xBC[:, 0, di: di + G * N].reshape(Bsz, G, N)
    Cm = xBC[:, 0, di + G * N:].reshape(Bsz, G, N)
    dt1 = F.softplus(dt[:, 0].float() + p["dt_bias"])         # (B,H)
    A = -torch.exp(p["A_log"])
    # the local region: the recurrence on this rank's heads
    reg = Region(x)
    x = reg.open(x, batch_spec("model", None))
    D, S0 = p["D"], state["ssm"]
    if reg.active:
        heads = P("model" if reg.sharded("model") else None)
        dt1 = reg.take(dt1, batch_spec("model"))
        A, D = reg.take(A, heads), reg.take(D, heads)
        S0 = reg.take(S0, reg.spec("model", None, None))
        Bm, Cm = reg.groups_of_heads((reg.take(Bm), reg.take(Cm)), 1, H, G,
                                     x.shape[1])
    rep = x.shape[1] // Bm.shape[1]
    Bf = torch.repeat_interleave(Bm.float(), rep, dim=1)      # (B,H,N)
    Cf = torch.repeat_interleave(Cm.float(), rep, dim=1)
    xf = x.float()
    dA = torch.exp(dt1 * A[None, :])
    S = S0 * dA[:, :, None, None] + torch.einsum(
        "bh,bhn,bhp->bhpn", dt1, Bf, xf)
    y = torch.einsum("bhn,bhpn->bhp", Cf, S)
    y = y + xf * D[None, :, None]
    y = y.to(compute_dtype).reshape(y.shape[0], 1, -1)
    if reg.active:
        y = reg.give_spec(y, reg.spec(None, "model"))
        S = like(reg.give_spec(S, reg.spec("model", None, None)),
                 state["ssm"])
    y = rmsnorm(p["norm"], y * silu(z))
    out = linear(p["out_proj"], y, compute_dtype=compute_dtype)
    conv_tail = like(conv_tail.to(state["conv"].dtype), state["conv"])
    return out, {"conv": conv_tail, "ssm": S}
