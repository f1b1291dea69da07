"""The ``serve`` generator: a closed loop of chat requests through the
program's continuous-batching ``serving.Engine``, every slot kept busy.

Requests come from one fixed pool of ``pool`` (prompt length, output
budget) pairs: the quantiles at (k + 0.5) / pool of two log-normal
laws, clipped (the mix's ``prompt`` and ``output``).  Every seed serves
the same pool, prompts and budgets shuffled apart and in another order,
each pass through it shuffled anew; token ids are uniform in [1,
vocab).  The engine never stops early (``eos_id`` -1), so a request
takes exactly its budget of decode steps.

Set-up makes the weights (``lib/lm.py``), the engine and its cache, one
one-token request at every prompt bucket (each admitted, then finished
by one step, so every prefill shape has run), the first ``max_batch``
requests and ``warm_steps`` decode steps.  The window then repeats: one
``Engine.step``, and a new request admitted into each slot it freed,
one prefill after the other, as ``Engine.run`` does.  A step's time runs
from the call into ``Engine.step`` until its tokens are in host memory;
a request's time to first token from the end of the step that freed its
slot (its arrival, in a closed loop) until its first token is in host
memory, the prefills queued ahead of it included.  ``cache_fill``: the
share of the cache's positions (``max_batch`` x ``max_seq``) that the
window's steps hold on average, each busy slot its bucket and the
tokens it has decoded since.  The generator drives
``Engine.admit``, ``Engine.step`` and ``Engine.free_slot`` and
reimplements none of them.

The check: while set-up's requests and the window's run, wrappers around
``lm_prefill`` and ``lm_decode`` as ``repro_torch.serving.engine``
imports them keep, on the device, each request's prefill logits and its
logits at ``checked_rows`` decode steps spread over its output, and flag
rows that are not finite; they change nothing the engine computes and
come out when the window closes.  Of the requests finished in the window
a reservoir drawn from the seed keeps ``checked_requests`` - 1, and the
longest is kept besides.  After ``free()`` the plain reference
that the configuration names (``reference/<name>.py``) runs each kept
request's exact sequence, the
prompt padded with ``pad_id`` to the bucket the engine put it in, then
every token the engine served, fed back, and gives:

- ``token_gap``: the widest gap by which a served token's reference
  logit lies below the reference's best at its position, over every
  served token of the kept requests;
- ``logit_gap``: over the kept rows, the largest |program - reference|
  over the row's largest |reference|.

With ``control`` the reference computed with every product's inputs
rounded to float8_e4m3fn takes the program's place: its rows, and the
tokens it puts first.
"""
from __future__ import annotations

import gc
import importlib
import math
import statistics
import time

import numpy as np
import torch

from perfbench.counts import lm as counts
from perfbench.lib import lm

ENGINE = "repro_torch.serving.engine"


def quantiles(n: int, law: dict) -> list:
    """``n`` lengths at the quantiles (k + 0.5) / n of a log-normal law
    (``median``, ``sigma``), clipped to [``min``, ``max``]."""
    z = statistics.NormalDist()
    return [int(min(law["max"], max(law["min"], round(
        law["median"] * math.exp(law["sigma"] * z.inv_cdf((k + 0.5) / n))))))
        for k in range(n)]


def bucket(n: int, max_seq: int) -> int:
    """The engine's prompt bucket: a power of two from 8, capped."""
    b = 8
    while b < n:
        b *= 2
    return min(b, max_seq)


class Request:
    __slots__ = ("uid", "prompt", "budget", "bucket", "slot", "steps",
                 "want", "rows", "generated", "bad")

    def __init__(self, uid, prompt, budget, rows_wanted):
        self.uid, self.prompt, self.budget = uid, prompt, budget
        self.steps, self.rows, self.generated, self.bad = 0, {}, None, None
        self.want = {round(k * (budget - 1) / max(rows_wanted - 1, 1))
                     for k in range(rows_wanted)}


class Traffic:
    def __init__(self, cell: dict, seed: int, device: torch.device):
        self.file, self.mix = cell["config"], cell["mix"]
        self.port = self.file["port"]
        self.ref = importlib.import_module(
            f"perfbench.reference.{self.file['reference']}")
        self.device, self.seed = device, int(seed)
        self.B, self.S = int(self.mix["max_batch"]), int(self.mix["max_seq"])
        n = int(self.mix["pool"])
        self.prompts = quantiles(n, self.mix["prompt"])
        self.outputs = quantiles(n, self.mix["output"])
        self.rng = np.random.default_rng(self.seed)
        self.n_check = int(self.mix["checked_requests"])
        self.body, self.per_key = counts.token_body(self.port)
        self.head = counts.head_flops(self.port)
        self.uid, self.order = 0, None
        self.live, self.kept, self.longest = {}, [], None
        self.capturing, self._saved, self._admitting = False, [], None
        self._keep_rng = np.random.default_rng([self.seed, 1])

    # -- requests ------------------------------------------------------------

    def _next(self) -> Request:
        n = len(self.prompts)
        if self.uid % n == 0:
            self.order = (self.rng.permutation(n), self.rng.permutation(n))
        i = self.uid % n
        L = self.prompts[self.order[0][i]]
        prompt = self.rng.integers(1, self.port["vocab"], L, dtype=np.int64)
        r = Request(self.uid, prompt, self.outputs[self.order[1][i]],
                    int(self.mix["checked_rows"]))
        self.uid += 1
        return r

    def _refill(self, t_free: float) -> list:
        """A new request admitted into every free slot, one after the
        other; each one's ms from ``t_free`` to its first token."""
        ttft = []
        while (slot := self.engine.free_slot()) is not None:
            r = self._next()
            r.slot = slot
            self._admitting = r
            self.engine.admit(r.uid, r.prompt, r.budget)
            ttft.append(1e3 * (time.perf_counter() - t_free))
            r.bucket = int(self.engine.pos[slot])
            self.live[slot] = r
            self.flops += counts.prompt_flops(self.port, len(r.prompt))
        self._admitting = None
        return ttft

    def _step(self) -> tuple:
        """One engine step: (ms, finished requests, tokens, end time)."""
        ctx = sum(len(r.prompt) + r.steps + 1 for r in self.live.values())
        self.held += sum(r.bucket + r.steps + 1 for r in self.live.values())
        n = len(self.live)
        t0 = time.perf_counter()
        finished = self.engine.step()
        t1 = time.perf_counter()
        self.flops += n * (self.body + self.head) + self.per_key * ctx
        for r in self.live.values():
            r.steps += 1
        done = []
        uids = {uid: toks for uid, toks in finished}
        for slot in [s for s, r in self.live.items() if r.uid in uids]:
            r = self.live.pop(slot)
            r.generated = uids[r.uid]
            if self.capturing:
                r.bad = self.bad[slot].clone()
                self.bad[slot] = False
            done.append(r)
        return 1e3 * (t1 - t0), done, n, t1

    # -- the program's call sites -------------------------------------------

    def _wrap_prefill(self, fn):
        def prefill(p, cfg, tokens, cache, **kw):
            logits, new = fn(p, cfg, tokens, cache, **kw)
            r = self._admitting
            if self.capturing and r is not None:
                row = logits[0, -1]
                r.rows[-1] = row.detach().clone()
                self.bad[r.slot] = ~torch.isfinite(row).all()
            return logits, new
        return prefill

    def _wrap_decode(self, fn):
        def decode(p, cfg, token, cache, pos, **kw):
            logits, new = fn(p, cfg, token, cache, pos, **kw)
            if self.capturing:
                last = logits[:, -1]
                self.bad |= ~torch.isfinite(last).all(dim=-1)
                for slot, r in self.live.items():
                    if r.steps in r.want:
                        r.rows[r.steps] = last[slot].detach().clone()
            return logits, new
        return decode

    def _capture(self, on: bool) -> None:
        mod = importlib.import_module(ENGINE)
        if on:
            self.bad = torch.zeros(self.B, dtype=torch.bool,
                                   device=self.device)
            for name, wrap in (("lm_prefill", self._wrap_prefill),
                               ("lm_decode", self._wrap_decode)):
                self._saved.append((name, getattr(mod, name)))
                setattr(mod, name, wrap(getattr(mod, name)))
        else:
            for name, fn in reversed(self._saved):
                setattr(mod, name, fn)
            self._saved.clear()
        self.capturing = on

    def _offer(self, r: Request) -> None:
        """The longest finished request, and a reservoir of the others
        drawn from the seed: each of the first n - 1 is kept, the i-th
        (0-based) replaces a kept one with probability (n - 1) / (i + 1)."""
        if self.longest is None or (len(r.prompt) + r.budget
                                    > len(self.longest.prompt)
                                    + self.longest.budget):
            self.longest, r = r, self.longest
            if r is None:
                return
        k, i = self.n_check - 1, self.seen
        self.seen += 1
        if len(self.kept) < k:
            self.kept.append(r)
            return
        j = int(self._keep_rng.integers(0, i + 1))
        if j < k:
            self.kept[j] = r

    # -- set-up, window, stretch ---------------------------------------------

    def setup(self) -> None:
        from repro_torch.serving import Engine, ServeCfg
        cfg = lm.program_cfg(self.file)
        self.w = lm.weights(self.port, self.seed, self.device)
        self.engine = Engine(cfg, self.w, ServeCfg(
            max_batch=self.B, max_seq=self.S, eos_id=int(self.mix["eos_id"]),
            pad_id=int(self.mix["pad_id"])), device=self.device)
        warm = np.random.default_rng([self.seed, 2])
        lo = bucket(self.mix["prompt"]["min"], self.S)
        hi = bucket(self.mix["prompt"]["max"], self.S)
        b = lo
        while b <= hi:
            self.engine.admit(-b, warm.integers(1, self.port["vocab"], b), 1)
            self.engine.step()
            b *= 2
        self.flops = self.held = 0
        self._capture(True)
        self._refill(time.perf_counter())
        for _ in range(int(self.mix["warm_steps"])):
            _, _, _, t = self._step()
            self._refill(t)
        self.seen = 0

    def window(self, seconds: float) -> dict:
        self.flops = self.held = 0
        steps, ttft, tokens, bad = [], [], 0, []
        t0 = time.perf_counter()
        while True:
            ms, done, n, t = self._step()
            steps.append(ms)
            tokens += n
            for r in done:
                self._offer(r)
                bad.append(r.bad)
            got = self._refill(t)
            ttft.extend(got)
            tokens += len(got)
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        bad += [self.bad[s] for s in self.live]
        failed = int(torch.stack(bad).sum()) if bad else 0
        self._capture(False)
        for r in self.live.values():
            r.rows = {}
        return {"seconds": elapsed, "failed": failed, "unit_s": steps,
                "steps": len(steps), "tokens": tokens, "requests": len(ttft),
                "finished": len(bad) - len(self.live),
                "requests_per_s": (len(bad) - len(self.live)) / elapsed,
                "tokens_per_s": tokens / elapsed,
                "ttft_ms_p50": float(np.median(ttft)) if ttft else None,
                "cache_fill": self.held / (len(steps) * self.B * self.S),
                "tpot_ms_p50": float(np.median(steps)),
                "flops": self.flops, "ttft_ms": ttft, "step_ms": steps}

    def stretch(self):
        """``trace_steps`` steps with their refills, and on until one
        request has been admitted among them; ``work`` holds the first
        call's steps, tokens, active slots a step and prefill buckets."""
        n = int(self.mix["trace_steps"])
        work: dict = {}

        def run():
            slots, buckets = [], []
            while len(slots) < n or not buckets:
                _, _, active, t = self._step()
                slots.append(active)
                before = set(self.live)
                self._refill(t)
                buckets += [self.live[s].bucket for s in set(self.live)
                            - before]
            if not work:
                work.update(steps=len(slots), slots=slots, prefills=buckets,
                            tokens=sum(slots) + len(buckets))
        return run, work

    @staticmethod
    def end_to_end(w: dict) -> dict:
        return {"served_tokens_per_s": w["tokens"] / w["seconds"]}

    @staticmethod
    def attempted(w: dict) -> int:
        return w["requests"]

    @staticmethod
    def work_flops(w: dict) -> float:
        return float(w["flops"])

    def free(self) -> None:
        if self.capturing:
            self._capture(False)
        self.engine = self.live = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    # -- the check -----------------------------------------------------------

    def readings(self, control: bool = False) -> dict:
        reqs = self.kept + ([self.longest] if self.longest else [])
        if not reqs:
            return {"token_gap": math.inf, "logit_gap": math.inf}
        pad = int(self.mix["pad_id"])
        seqs, wants, served = [], [], []
        for r in reqs:
            toks = np.full(r.bucket + r.budget, pad, np.int64)
            toks[: len(r.prompt)] = r.prompt
            toks[r.bucket:] = r.generated[:-1]
            seqs.append(torch.from_numpy(toks).to(self.device))
            wants.append(torch.arange(r.bucket - 1, r.bucket + r.budget,
                                      device=self.device))
            served.append(torch.tensor(r.generated, device=self.device))
        refs = self.ref.forward(self.w, self.port, seqs, wants)
        if control:
            cands = self.ref.forward(self.w, self.port, seqs, wants,
                                     mm=self.ref.fp8_matmul)
            picked = [c.argmax(dim=-1) for c in cands]
            rows = [{k: c[k + 1] for k in r.rows} for r, c in zip(reqs, cands)]
        else:
            picked = served
            rows = [{k: v.float() for k, v in r.rows.items()} for r in reqs]
        token_gap = logit_gap = 0.0
        for x, tok, got in zip(refs, picked, rows):
            if tok.shape[0] != x.shape[0] or not got:
                return {"token_gap": math.inf, "logit_gap": math.inf}
            below = x.max(dim=-1).values - x.gather(1, tok[:, None])[:, 0]
            token_gap = max(token_gap, float(below.max()))
            for k, row in got.items():
                want = x[k + 1]
                logit_gap = max(logit_gap, float(
                    (row - want).abs().max() / want.abs().max()))
        fin = lambda v: v if math.isfinite(v) else math.inf  # noqa: E731
        return {"token_gap": fin(token_gap), "logit_gap": fin(logit_gap)}
