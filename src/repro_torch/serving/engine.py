"""Continuous-batching serving engine for CompositeLM models (port of
``repro.serving.engine``).

Slot-based: ``max_batch`` independent sequences share one decode step.
The JAX engine ``vmap``s a single-sequence decode with a scalar position
per slot; here the batch is written out and ``lm_decode`` takes a (B,)
position tensor, so RoPE, the cache write and the validity mask work per
row.  Every slot decodes every step, idle ones included, as in the JAX
engine.  Prefill runs per request at a bucketed length (powers of two from
8, capped at ``max_seq``): the prompt is padded with ``pad_id`` at the end,
the slot's position is set to the bucket and its first token is the argmax
at the last padded position — the reference's behaviour, kept as it is.
Every prefill runs with ``impl="kernel"``: GQA attention through
``flash_attention`` (head dims 32, 64, 112, 128), MLA's expanded
attention through ``flash_attention`` at its head pair (192, 128), the
DeepSeek-V2/V3 widths (other MLA widths, such as the smoke configs',
keep the plain products, counted in ``ops.PLAIN_PREFILLS["mla"]``),
Mamba2 through ``ssd_scan``; the projections,
MLPs and experts are PyTorch products.  Decode has no hand-written
kernel: GQA scores the cache, MLA its latent cache (absorbed), in f32.
Any ``LMCfg`` is served (dense, MLA/MoE, SSM, hybrid; a VLM's text only,
as in the reference); MoE layers route each slot's token on its own in
decode (``route_rows``), as the reference's mapped one-slot decode does;
an expert share (``MoECfg.n_held``) is dropless, so its rows share
nothing.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.lm import (LMCfg, tree_map, lm_decode,
                                   lm_init_cache, lm_prefill)


@dataclasses.dataclass
class ServeCfg:
    max_batch: int = 4
    max_seq: int = 512
    eos_id: int = -1            # -1: never stop early
    pad_id: int = 0


def _bucket(n: int) -> int:
    b = 8
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class _Slot:
    uid: Optional[int] = None
    budget: int = 0
    generated: Optional[list] = None


class Engine:
    """``params`` must lie on ``device`` (default: the card)."""

    def __init__(self, cfg: LMCfg, params, serve_cfg: ServeCfg, *,
                 device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.sc = serve_cfg
        B, S = serve_cfg.max_batch, serve_cfg.max_seq
        self.cache = lm_init_cache(cfg, B, S, device=self.device)
        self.pos = np.zeros(B, np.int64)          # next position per slot
        self.slots: List[_Slot] = [_Slot() for _ in range(B)]
        self.last_tok = np.zeros((B, 1), np.int64)

    # -- admission -------------------------------------------------------------

    def free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s.uid is None:
                return i
        return None

    def admit(self, uid: int, prompt, max_new_tokens: int, *,
              answered=()) -> int:
        """Prefill ``prompt`` into a free slot; returns the slot index.
        ``answered``: the tokens a request resumed part-way through its
        answer has already produced (as after a preemption that
        recomputes).  They follow the padded prompt in the same prefill,
        which then runs at the bucket plus their number, and the slot
        decodes on from there; the tokens it returns are the new ones."""
        slot = self.free_slot()
        if slot is None:
            raise RuntimeError("no free slot")
        prompt = np.asarray(prompt)
        L = int(prompt.shape[-1])
        Lb = min(_bucket(L), self.sc.max_seq)
        answered = np.asarray(answered, np.int64)
        if answered.size and Lb + answered.size >= self.sc.max_seq:
            raise ValueError(f"a prompt bucket of {Lb} and {answered.size} "
                             f"answered tokens leave no room in max_seq "
                             f"{self.sc.max_seq}")
        toks = np.full((1, Lb + answered.size), self.sc.pad_id, np.int64)
        toks[0, :L] = prompt
        toks[0, Lb:] = answered
        sub = tree_map(lambda c: c[:, slot: slot + 1], self.cache)
        with torch.no_grad():
            logits, sub = lm_prefill(
                self.params, self.cfg,
                torch.from_numpy(toks).to(self.device), sub)

        def put(c, s):
            c[:, slot: slot + 1] = s.to(c.dtype)
        tree_map(put, self.cache, sub)
        nxt = int(torch.argmax(logits[0, -1]))
        self.pos[slot] = toks.shape[1]
        self.last_tok[slot, 0] = nxt
        self.slots[slot] = _Slot(uid=uid, budget=max_new_tokens,
                                 generated=[nxt])
        return slot

    # -- decode ----------------------------------------------------------------

    def active(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s.uid is not None]

    def step(self):
        """One continuous-batching decode step over all slots."""
        with torch.no_grad():
            logits, self.cache = lm_decode(
                self.params, self.cfg,
                torch.from_numpy(self.last_tok).to(self.device), self.cache,
                torch.from_numpy(self.pos).to(self.device), route_rows=True)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).tolist()
        finished = []
        for i, s in enumerate(self.slots):
            if s.uid is None:
                continue
            self.pos[i] += 1
            tok = int(nxt[i])
            s.generated.append(tok)
            s.budget -= 1
            if (s.budget <= 0 or tok == self.sc.eos_id
                    or self.pos[i] >= self.sc.max_seq - 1):
                finished.append((s.uid, list(s.generated)))
                self.slots[i] = _Slot()
            else:
                self.last_tok[i, 0] = tok
        return finished

    # -- convenience -------------------------------------------------------------

    def run(self, requests, *, on_finish: Optional[Callable] = None):
        """Serve a list of (uid, prompt, max_new_tokens) with continuous
        batching.  Returns ({uid: generated tokens}, stats): ``wall_s`` and
        ``decode_steps`` as in the JAX engine, plus ``prefills``,
        ``prefill_s`` and ``decode_s`` (host clock; each prefill and step
        ends in a read of its argmax, which waits for the device)."""
        t0 = time.perf_counter()
        pending = list(requests)
        done = {}
        steps = prefills = 0
        prefill_s = decode_s = 0.0
        while pending or self.active():
            while pending and self.free_slot() is not None:
                uid, prompt, mnt = pending.pop(0)
                ta = time.perf_counter()
                self.admit(uid, prompt, mnt)
                prefill_s += time.perf_counter() - ta
                prefills += 1
            ts = time.perf_counter()
            finished = self.step()
            decode_s += time.perf_counter() - ts
            for uid, toks in finished:
                done[uid] = toks
                if on_finish:
                    on_finish(uid, toks)
            steps += 1
        return done, {"wall_s": time.perf_counter() - t0,
                      "decode_steps": steps, "prefills": prefills,
                      "prefill_s": prefill_s, "decode_s": decode_s}
