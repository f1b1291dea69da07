"""Device choice: the card unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card (``cuda:0``); a CPU run must be asked for.

    Raises ``RuntimeError`` when CUDA is wanted (explicitly or by default)
    and no card is present — the port never falls back to the CPU on its
    own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda", 0)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} was asked for but no CUDA "
                               "device is available")
        return torch.device("cuda", 0 if dev.index is None else dev.index)
    return dev


def make_generator(seed: int, device=None) -> torch.Generator:
    """A seeded ``torch.Generator`` on ``resolve_device(device)`` — the
    port's stand-in for a JAX PRNG key (it advances in place)."""
    g = torch.Generator(device=resolve_device(device))
    g.manual_seed(int(seed))
    return g
