"""Edge AIGC gateway — the paper's control plane wired to real execution
(port of ``repro.serving.gateway``).

The gateway keeps a catalogue of GenAI models, applies the cacher's rho by
loading and evicting real models against a byte budget, and runs each
cached request under its compute share xi, ``steps = round(xi *
total_steps)``: a diffusion model runs a DDPM reverse chain of ``steps``
steps in one ``ddpm_chain`` launch; an LM (``kind="lm"``,
its builder returns an :class:`~repro_torch.serving.engine.Engine`)
generates ``max(1, steps // 16)`` tokens through its engine, every prefill
through the ``flash_attention`` or ``ssd_scan`` kernel.  It reports the
modeled quality/delay (Eqs. 7-8) beside the measured wall-clock (taken
after ``torch.cuda.synchronize``).  Uncached requests take the modeled
cloud path.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.quality import (cloud_delay, cloud_quality,
                                      gen_delay, tv_quality)
from repro_torch.device import resolve_device
from repro_torch.diffusion import denoiser_init, make_schedule, \
    reverse_sample
from repro_torch.serving.engine import Engine


@dataclasses.dataclass
class CatalogEntry:
    model_id: int
    name: str
    kind: str                     # "diffusion" | "lm"
    size_gb: float
    builder: Callable[[], object]  # -> Denoiser (diffusion) or Engine (lm)
    # fitted-curve parameters (paper Sec. 7.1 ranges)
    a1: float = 60.0
    a2: float = 110.0
    a3: float = 170.0
    a4: float = 28.0
    b1: float = 0.18
    b2: float = 5.74


@dataclasses.dataclass
class ServedResult:
    model_id: int
    cached: bool
    steps: int
    modeled_quality: float
    modeled_delay: float
    measured_wall_s: float
    output_shape: tuple


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class EdgeGateway:
    def __init__(self, catalogue: List[CatalogEntry], capacity_gb: float,
                 *, image_dim: int = 256, total_steps: int = 1000,
                 device=None):
        self.device = resolve_device(device)
        self.catalogue: Dict[int, CatalogEntry] = {
            e.model_id: e for e in catalogue}
        self.capacity_gb = capacity_gb
        self.loaded: Dict[int, object] = {}
        self.image_dim = image_dim
        self.total_steps = total_steps
        self._schedules: Dict[int, object] = {}
        self._state = torch.zeros((1,), device=self.device)  # unconditional

    # -- caching (long timescale) ---------------------------------------------

    def used_gb(self) -> float:
        return sum(self.catalogue[m].size_gb for m in self.loaded)

    def apply_caching(self, rho) -> Dict[str, float]:
        """Load/evict model instances to match the caching vector.
        Infeasible rho (storage overflow) is truncated in id order — the
        physical analogue of the paper's soft penalty Xi."""
        want = [m for m, r in enumerate(np.asarray(rho)) if r > 0.5
                and m in self.catalogue]
        for m in list(self.loaded):
            if m not in want:
                del self.loaded[m]
        t0 = time.perf_counter()
        for m in want:
            if m in self.loaded:
                continue
            e = self.catalogue[m]
            if self.used_gb() + e.size_gb > self.capacity_gb:
                continue
            self.loaded[m] = self._build(e)
        _sync(self.device)
        return {"load_s": time.perf_counter() - t0,
                "used_gb": self.used_gb(),
                "n_loaded": float(len(self.loaded))}

    def _build(self, e: CatalogEntry):
        if e.kind == "diffusion":
            return e.builder().to(self.device)
        if e.kind != "lm":
            raise ValueError(f"{e.name}: unknown kind {e.kind!r}")
        engine = e.builder()
        if not isinstance(engine, Engine):
            raise TypeError(f"{e.name}: an LM builder returns an Engine, not "
                            f"{type(engine).__name__}")
        if engine.device != self.device:
            raise ValueError(f"{e.name}: its engine is on {engine.device}, "
                             f"the gateway on {self.device}")
        return engine

    # -- execution (short timescale) ------------------------------------------

    def _schedule(self, steps: int):
        if steps not in self._schedules:
            self._schedules[steps] = make_schedule(steps, kind="linear")
        return self._schedules[steps]

    @torch.no_grad()
    def diffusion_sample(self, model_id: int, steps: int, generator=None, *,
                         x_L=None, noises=None):
        """The ``steps``-step image chain of a loaded diffusion model:
        (image_dim,) in [-1, 1], without a graph (serving differentiates
        nothing).  ``x_L``/``noises`` inject the draws."""
        return reverse_sample(self.loaded[model_id], self._schedule(steps),
                              self._state, self.image_dim,
                              generator=generator, x_L=x_L, noises=noises)

    def serve_request(self, model_id: int, xi: float, generator=None,
                      prompt: Optional[np.ndarray] = None) -> ServedResult:
        """Execute one request under compute share xi (Eq. 7-8 knob).  An
        LM request decodes ``max(1, steps // 16)`` tokens after ``prompt``
        (default ``arange(8) % vocab``); its output shape is the number of
        tokens generated."""
        e = self.catalogue[model_id]
        cached = model_id in self.loaded
        steps = int(max(1, round(float(xi) * self.total_steps)))
        if not cached:
            # cloud path: modeled only (paper Sec. 3.4)
            return ServedResult(
                model_id, False, int(e.a3),
                modeled_quality=float(cloud_quality(e.a4)),
                modeled_delay=float(cloud_delay(e.a3, e.b1, e.b2)),
                measured_wall_s=0.0, output_shape=())
        _sync(self.device)
        t0 = time.perf_counter()
        if e.kind == "diffusion":
            shape = tuple(self.diffusion_sample(model_id, steps,
                                                generator).shape)
        else:
            engine = self.loaded[model_id]
            if prompt is None:
                prompt = np.arange(8, dtype=np.int64) % engine.cfg.vocab
            done, _ = engine.run([(0, prompt, max(1, steps // 16))])
            shape = (len(done[0]),)
        _sync(self.device)
        wall = time.perf_counter() - t0
        s = torch.tensor(float(steps))
        q = float(tv_quality(s, e.a1, e.a2, e.a3, e.a4))
        d = float(gen_delay(s, e.b1, e.b2))
        return ServedResult(model_id, True, steps, q, d, wall, shape)

    def serve_slot(self, requests, xi, generator=None) -> List[ServedResult]:
        """requests: per-user model ids; xi: per-user compute shares."""
        return [self.serve_request(int(m), float(x), generator)
                for m, x in zip(requests, np.asarray(xi))]


def toy_diffusion_builder(seed: int, image_dim: int = 256):
    """A small unconditional DDPM denoiser standing in for RePaint
    (1 + image_dim + 16 -> 128x3 -> image_dim).  Built on the CPU from
    ``seed``, so a seed gives the same weights on every device; the
    gateway moves it to its own device."""
    def build():
        g = torch.Generator(device="cpu")
        g.manual_seed(seed)
        return denoiser_init(1, image_dim, g, hidden=128, n_layers=3)
    return build
