"""Wrappers around the hand-written CUDA kernels.

A wrapper checks its inputs, then launches its kernel for CUDA tensors or
runs the plain version in ``ref.py`` for CPU tensors — only because the
tensors lie on the CPU.  For a CUDA tensor it launches or raises; there is
no fallback.  ``LAUNCHES[name]`` counts the kernel's launches (and nothing
else), so a run can show that its path went through the kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build, ref

LAUNCHES = {"ddpm_step": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FN = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _ddpm_fn():
    fn = _FN.get("ddpm_step")
    if fn is None:
        fn = build.load("ddpm_step").ddpm_step_launch
        # c_void_p for every pointer and the stream: a bare Python int
        # would be passed as a 32-bit C int and cut the address
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_float,
                       ctypes.c_float, ctypes.c_float, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN["ddpm_step"] = fn
    return fn


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
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, eps_hat, noise)):
        raise NotImplementedError(
            "ddpm_step has no backward yet (the training slice adds it, "
            "ROADMAP queue A); call it under torch.no_grad()")


def ddpm_step(x, eps_hat, noise, alpha: float, alpha_bar: float,
              beta_tilde: float, l_rev: int):
    """Fused reverse-diffusion update; x/eps_hat/noise: (..., A), float32
    or bfloat16, same shape/dtype/device.  The schedule values are host
    floats (``DiffusionSchedule.host``), so no device read is needed.
    Returns a new tensor of ``x.dtype``."""
    _check_ddpm(x, eps_hat, noise)
    c1, c2, sigma = ddpm_coefficients(alpha, alpha_bar, beta_tilde, l_rev)
    if x.device.type == "cpu":
        return ref.ddpm_step_ref(x, eps_hat, noise, c1, c2, sigma)
    if x.device.type != "cuda":
        raise ValueError(f"ddpm_step runs on cuda or cpu, not {x.device}")
    if not (x.is_contiguous() and eps_hat.is_contiguous()
            and noise.is_contiguous()):
        raise ValueError("ddpm_step: the kernel takes contiguous tensors")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"ddpm_step: x is on {x.device} but the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    err = _ddpm_fn()(x.data_ptr(), eps_hat.data_ptr(), noise.data_ptr(),
                     out.data_ptr(), x.numel(), c1, c2, sigma,
                     _DTYPE_CODE[x.dtype],
                     torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ddpm_step kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["ddpm_step"] += 1
    return out
