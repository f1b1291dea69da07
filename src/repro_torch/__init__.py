"""PyTorch/CUDA port of the T2DRL edge-AIGC system (``repro``'s twin).

Module names mirror ``src/repro/`` so every ported function has a named
JAX counterpart to be held against.  The package imports ``torch`` and
never ``jax`` or ``repro``; weights and states cross over as numpy trees
through :mod:`repro_torch.bridge`.

Entry points run on the card (``cuda:0``) unless the caller passes
``device="cpu"`` (:func:`repro_torch.device.resolve_device`).  Each
kernel wrapper in :mod:`repro_torch.kernels.ops` launches its hand-written
Hopper kernel for a CUDA tensor and runs its plain PyTorch version only
for a CPU tensor.
"""
from .device import make_generator, resolve_device  # noqa: F401
