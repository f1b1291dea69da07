"""The paper's contribution, ported: environment, D3PG actor, DDQN cacher,
baselines and the greedy two-timescale loop (``t2drl``).

Import from the submodules (``repro_torch.core.env``, ...).  This package
re-exports nothing, so ``repro_torch.diffusion`` can use
``core.networks`` without an import cycle through ``core.d3pg``.
"""
