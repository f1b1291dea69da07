"""The configuration file as the program's own configuration objects.

The program is ``repro_torch``.  Its D3PG and DDQN widths are derived
inside it; ``t2drl_cfg`` refuses a configuration whose derived widths
differ from the file's, since the run would not be the configuration
it names.
"""
from __future__ import annotations

import numpy as np
import torch


def _tuples(x):
    return tuple(_tuples(v) for v in x) if isinstance(x, list) else x


def t2drl_cfg(cfg: dict, seed: int, mix: dict):
    """``T2DRLCfg`` of a configuration file, with the mix's vector-env
    mode (``policy``, ``independent_impl``)."""
    from repro_torch.core import EnvCfg, T2DRLCfg
    env = EnvCfg(**{k: _tuples(v) for k, v in cfg["env"].items()})
    t = dict(cfg["t2drl"])
    out = T2DRLCfg(env=env, seed=int(seed),
                   policy=mix.get("policy", "independent"),
                   independent_impl=mix.get("independent_impl", "fused"),
                   **t)
    d3, dq = out.d3pg_cfg(), out.ddqn_cfg()
    stated = {**{k: cfg["d3pg"][k] for k in cfg["d3pg"]},
              **{"ddqn_" + k: cfg["ddqn"][k] for k in cfg["ddqn"]}}
    derived = {**{k: getattr(d3, k) for k in cfg["d3pg"]},
               **{"ddqn_" + k: getattr(dq, k) for k in cfg["ddqn"]}}
    off = {k: (stated[k], derived[k]) for k in stated
           if stated[k] != derived[k]}
    if off:
        raise ValueError(f"the program derives other learner settings than "
                         f"the configuration states (file, program): {off}")
    return out


def f32_only() -> None:
    """Float32 as the configurations state it: no TF32 in matrix products
    or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def cell_seeds(seed: int, n: int) -> list:
    """The seed of each of n cells' generators: cell 0's is ``seed``,
    cell c's the 64-bit integer that ``numpy.random.SeedSequence([seed,
    c]).generate_state(2, uint32)`` gives, low word first."""
    out = [int(seed)]
    for c in range(1, n):
        lo, hi = np.random.SeedSequence([int(seed), c]).generate_state(
            2, np.uint32)
        out.append(int(lo) | int(hi) << 32)
    return out


def generators(seeds, device) -> list:
    gens = []
    for s in seeds:
        g = torch.Generator(device=device)
        g.manual_seed(s)
        gens.append(g)
    return gens
