"""The ``decide`` generator: a regional controller's greedy decisions.

Set-up makes the policy's weights (the denoiser and the Q-net, N(0,
1/in) on one seeded generator) and one frame of K slot states for C cells
(``pool.frame``), and warms the decision path on the frame.  The window
is a closed loop of decisions that cycles over the frame's slots: at a
frame's first slot the caching decision for all C cells
(``greedy_frame_cache``, then ``env_set_cache``), at every slot one
``greedy_slot_action`` for all C cells with one generator, seeded from
the run's seed and the decision's index.  The device is synchronised
before each decision's clock starts; the clock stops once (b, xi) are in
host memory.  No env step runs in the window: the world's simulation is
not the controller's work.  Once the window has closed, on the card, a
stretch of ``trace_decisions`` decisions under the profiler gives the
card's time a decision: the union of its events (kernels and copies)
over the stretch, divided by its decisions.

The check takes decisions drawn from the seed (a reservoir over the
window) and computes them again with the plain reference from the same
weights, states and seeds, the frame's caching decision included.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from perfbench import counts
from perfbench.lib import check, pool, program, trace
from perfbench.reference import env as renv
from perfbench.reference import nets as rnets
from perfbench.reference import t2drl as rt2


def _policy_weights(cfg: dict, seed: int, device) -> dict:
    """The denoiser's and the Q-net's layers, N(0, 1/in) weights and zero
    biases, one draw a layer from one generator."""
    n = counts.nets_of(cfg)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) ^ 0x5EED)
    out = {}
    for name, dims in (("actor", n.actor), ("q", n.qnet)):
        ws = [torch.randn(i, o, generator=g, device=device) / math.sqrt(i)
              for i, o in zip(dims[:-1], dims[1:])]
        out[name] = (ws, [torch.zeros(o, device=device) for o in dims[1:]])
    return out


def decision_seed(seed: int, i: int) -> int:
    return (int(seed) * 1_000_003 + i) % (1 << 62)


class Traffic:
    def __init__(self, cell: dict, seed: int, device: torch.device):
        self.file, self.mix = cell["config"], cell["mix"]
        self.device, self.seed = device, int(seed)
        self.C = int(self.mix["cells"])
        self.n_check = int(self.mix["checked_decisions"])
        program.f32_only()
        self.cfg = program.t2drl_cfg(self.file, seed, self.mix)
        self.K = self.cfg.env.K
        self.i = 0

    def setup(self) -> None:
        from repro_torch.core import EnvState
        from repro_torch.core.networks import MLP
        from repro_torch.diffusion import Denoiser
        dev = self.device
        self.weights = _policy_weights(self.file, self.seed, dev)
        clone = lambda t: [x.clone() for x in t]  # noqa: E731
        self.policy = {
            "actor": Denoiser(MLP(*map(clone, self.weights["actor"])))
            .requires_grad_(False),
            "ddqn": {"q": MLP(*map(clone, self.weights["q"]))
                     .requires_grad_(False)}}
        self.frame = pool.frame(self.file["env"], self.C, self.seed, dev)
        from repro_torch.core import ModelParams
        self.models = ModelParams(**self.frame["models"])
        self.gen = torch.Generator(device=dev)
        zeros = torch.zeros((self.C, self.cfg.env.M), device=dev)
        self.states = [EnvState(self.gen, self.frame["gamma_idx"],
                                sl["lambda_idx"], sl["pos"], sl["h"],
                                sl["req"], sl["d_in"], zeros)
                       for sl in self.frame["slots"]]
        self.kept, self._rng = [], np.random.default_rng(self.seed)
        for _ in range(int(self.mix.get("warm_frames", 2)) * self.K):
            self.decide()
        self.i = 0

    def decide(self):
        """One decision; returns (ms, (b, xi) on the host).  Beside it
        ``self.enqueue_ms``: the host's part, from the clock's start until
        the copy to the host is asked for."""
        from repro_torch.core import greedy_frame_cache, greedy_slot_action
        from repro_torch.core.env import env_set_cache
        k = self.i % self.K
        self.gen.manual_seed(decision_seed(self.seed, self.i))
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        if k == 0:
            self.rho = greedy_frame_cache(self.policy, self.cfg, self.models,
                                          self.frame["gamma_idx"], self.gen)
        env = env_set_cache(self.states[k], self.rho)
        b, xi = greedy_slot_action(self.policy, self.cfg, env, self.models,
                                   self.gen)
        both = torch.cat([b, xi], dim=-1)
        t1 = time.perf_counter()
        out = both.cpu()
        ms = 1e3 * (time.perf_counter() - t0)
        self.enqueue_ms = 1e3 * (t1 - t0)
        self.i += 1
        return ms, out

    def _offer(self, i: int, out) -> None:
        """Reservoir sampling over the window's decisions, with the run's
        seed: each of the first n is kept, the i-th (0-based) replaces a
        kept one with probability n / (i + 1)."""
        if len(self.kept) < self.n_check:
            self.kept.append((i, out))
            return
        j = int(self._rng.integers(0, i + 1))
        if j < self.n_check:
            self.kept[j] = (i, out)

    def window(self, seconds: float) -> dict:
        lat, failed, t0 = [], 0, time.perf_counter()   # ms a decision
        host = []
        while True:
            i = self.i
            ms, out = self.decide()
            lat.append(ms)
            host.append(self.enqueue_ms)
            failed += int(not bool(torch.isfinite(out).all()))
            self._offer(i, out)
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds and self.i % self.K == 0:
                break
        frame = lat[::self.K]
        slot = [x for j, x in enumerate(lat) if j % self.K]
        return {"seconds": elapsed, "failed": failed, "unit_s": lat,
                "decisions": len(lat), "frame_decisions": len(frame),
                "ms_p95": float(np.percentile(lat, 95)),
                "frame_ms_median": float(np.median(frame)),
                "slot_ms_median": float(np.median(slot)) if slot else None,
                "frame_enqueue_ms_median": float(np.median(host[::self.K])),
                **self._card_ms()}

    def _card_ms(self) -> dict:
        """The card's busy ms a decision over a profiled stretch from a
        frame's first slot (``card_ms``; ``kernel_ms`` the kernels alone,
        copies left out); nothing off the card."""
        if self.device.type != "cuda":
            return {}
        run, work = self.stretch()
        tr = trace.profile(run, self.device)
        n = work["decisions"]
        return {"card_ms": 1e3 * tr.busy_s / n,
                "kernel_ms": 1e3 * sum(s for _, s in tr.kernels) / n}

    def stretch(self):
        n = int(self.mix["trace_decisions"])

        def run():
            for _ in range(n):
                self.decide()
        return run, {"decisions": n, "frame_decisions": n // self.K,
                     "cells": self.C}

    @staticmethod
    def end_to_end(w: dict) -> dict:
        return {"decision_card_ms": w.get("card_ms")}

    @staticmethod
    def attempted(w: dict) -> int:
        return w["decisions"]

    def work_flops(self, w: dict) -> float:
        n = counts.nets_of(self.file)
        return (w["decisions"] * counts.slot_decision(n, self.C).flops
                + w["frame_decisions"]
                * counts.frame_decision(n, self.C).flops)

    def free(self) -> None:
        self.policy = self.states = self.models = None
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    # -- the check -----------------------------------------------------------

    def readings(self, control: bool = False) -> dict:
        """The widest gap between each kept decision's (b, xi) and the
        reference's, which makes the frame's caching decision itself (its
        Q-values' argmax, amended) and the slot's decision on it; with
        ``control``, the reference computed with TF32 products takes the
        program's place.  A cell's xi gap is weighted by its reference
        compute normaliser, capped at 1: xi divides each gated user's
        share by their sum, which rounding of the chain's output moves
        without bound where that sum is small."""
        dev = self.device
        h = rt2.Hyper(self.file, dev)

        def decide(i, mm):
            q = rt2.q_values(self.weights["q"], self.frame["gamma_idx"], h,
                             mm)
            st = {**self.frame["slots"][i % self.K],
                  "gamma_idx": self.frame["gamma_idx"],
                  "rho": renv.amend_caching(torch.argmax(q, dim=-1), h.M)}
            return rt2.slot_decision(self.weights["actor"], st,
                                     self.frame["models"],
                                     decision_seed(self.seed, i), h, mm)

        gap = 0.0
        for i, out in self.kept:
            b, xi, norm = decide(i, torch.matmul)
            if control:
                cb, cxi, _ = decide(i, rnets.tf32_matmul)
            else:
                cb, cxi = out.to(dev).split([h.U, h.U], dim=-1)
            w = torch.clamp(norm, max=1.0)[..., None]
            gap = max(gap, check.max_abs(cb, b),
                      check.max_abs(cxi * w, xi * w))
        return {"action_gap": gap}
