"""Learner telemetry taps (DESIGN.md §15), port of ``repro.obs.taps``.

A tap is an extra output carried beside the training stats: per-update
learner diagnostics (TD errors, Q values, gradient norms, the target
chain's denoising magnitudes) gathered inside the episode with no host
read.  They are gated by :class:`ObsCfg` on ``T2DRLCfg``: with
``enabled=False`` (the default) no tap site runs and the episode launches
exactly what it launches without telemetry.

An update gate skips the update before warmup, so a tapped slot gives the
update's metrics or the agent's zero metrics (``diag_zero``) and a 0/1
``did`` flag; :func:`reduce_update_diag` turns the per-slot streams into
episode statistics (did-weighted means, did-masked maxima for ``*_max``
keys, the update count) under flat ``"diag/..."`` history keys.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ObsCfg:
    """Telemetry switches, the fields of the JAX ``ObsCfg``.

    ``enabled`` is the master switch; ``learner`` adds the per-update
    learner diagnostics (``diag/...`` keys reduced per episode),
    ``replay`` the replay buffers' size and fill fraction at episode end.
    Writers and paths are host concerns and live elsewhere."""
    enabled: bool = False
    learner: bool = True
    replay: bool = True

    @property
    def learner_on(self) -> bool:
        return self.enabled and self.learner

    @property
    def replay_on(self) -> bool:
        return self.enabled and self.replay


def combine_updates(ms: list) -> dict:
    """The N updates of one slot (``updates_per_slot``) as one metrics
    dict: the mean over them, the max for ``*_max`` keys (every inner
    update ran, so no ``did`` weighting)."""
    out = {}
    for k in ms[0]:
        v = torch.stack([m[k] for m in ms])
        out[k] = (torch.amax(v, dim=0) if k.endswith("_max")
                  else torch.mean(v, dim=0))
    return out


def reduce_update_diag(ms: dict, did, prefix: str = "diag/") -> dict:
    """Episode reduction of a tapped update stream.

    ``ms``: flat dict of stacked per-slot metrics, scan axes first (e.g.
    (T, K), or (T, K, B) and (T, K, B, L) for B learners); ``did``: the
    0/1 did-an-update flags, of exactly the scan axes' shape.  Returns
    ``{prefix + k}``: the did-weighted mean over the scan axes (0 when no
    update ran), the did-masked max for ``*_max`` keys, and ``prefix +
    "updates"``, the update count."""
    did = torch.as_tensor(did, dtype=torch.float32)
    axes = tuple(range(did.dim()))
    n = torch.sum(did)
    out = {}
    for k, v in ms.items():
        w = did.reshape(did.shape + (1,) * (v.dim() - did.dim()))
        if k.endswith("_max"):
            masked = torch.where(w > 0, v, -torch.inf)
            val = torch.where(n > 0, torch.amax(masked, dim=axes),
                              torch.zeros((), device=v.device))
        else:
            val = torch.sum(v * w, dim=axes) / torch.clamp_min(n, 1.0)
        out[prefix + k] = val
    out[prefix + "updates"] = n
    return out


def broadcast_diag(diag_zero: dict, B: int) -> dict:
    """A single learner's ``diag_zero`` stacked to B learners (the zeros
    of a skipped stacked update)."""
    return {k: torch.zeros((B,) + tuple(v.shape), dtype=v.dtype,
                           device=v.device) for k, v in diag_zero.items()}
