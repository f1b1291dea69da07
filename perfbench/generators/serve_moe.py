"""The ``serve_moe`` generator: the ``serve`` generator's closed loop of
requests through the program's ``serving.Engine``, for an MLA/MoE model
at an expert share (DeepSeek-V3's layout).

Everything ``generators/serve.py`` says holds: the fixed pool of
(prompt, budget) pairs each seed shuffles, set-up's warm prefills at
every bucket and its admissions, the window of ``Engine.step`` and
refills, the traced stretch, and the output check against the plain
reference that the configuration names (``reference/deepseek_v3.py``)
over the exact sequences the engine processed, with numbers of its own
(below).  Here the weights and the
program's configuration come from ``lib/moe_lm.py`` and the model's
operations from ``counts/moe_lm.py``; set-up checks the program's model
against the file before it makes a weight, so a program that cannot
build the configuration fails at once.

The window joins the loop near its steady state: the ``max_batch``
requests that set-up admits first are the ones a running loop holds at
an instant, each part of the way through its answer.  The k-th (0
based) keeps (p_k + 0.5) / max_batch of its budget (at least one
token), p a permutation of the slots drawn from the seed so that how far
a slot has got has nothing to do with its index (else the requests that
finish in the window, the ones the check reads, would all sit in the
first slots).  It has answered the rest: seeded tokens that set-up
admits after its padded prompt in the same prefill
(``Engine.admit(answered=)``, a request resumed mid-answer), so its
cache holds them.  Every later request keeps its whole budget.  Without
this every slot would start its answer at once, and a window shorter
than the shortest answer (51 s against 150 or more steps of ~0.15 s)
would finish no request to check and admit none.  The first requests
are drawn as every other is, not weighted by length as the requests a
running loop holds are, so the window's cached positions per decoded
token (``cache_fill`` x ``max_seq``) stay a few percent under the
loop's steady state.

The check's numbers, over the same kept requests and rows as there,
read the mass of the tokens and rows rather than their widest gap:

- ``token_gap_p90``: the 90th percentile, over every served token, of
  the gap by which its reference logit lies below the reference's best;
- ``logit_gap_p50``: the median over the kept rows (prefill and
  ``checked_rows`` decode rows a request) of the row's gap,
  |program - reference| over the row's largest |reference|;
- ``prefill_gap_p50``: the median of that gap over the requests'
  prefill rows alone, so that a fault of the prefill shows although its
  rows are one in ``checked_rows + 1``.

A routing choice near a tie can fall the other way in the program's
bf16 than in the reference's f32 (the top-8 of 256 sigmoid scores, and
groups of 32 scored by their best two), and moves the rows and tokens
after it by as much as a fault that touches every row does: the widest
gaps would read those flips, the percentiles read the rest.  ``where``
(after ``readings``) holds the witness: the widest rows and tokens
beside the reference router's closest call there, and, with ``witness``
set (``calibrate_moe.py --witness``), the gaps again with the
reference's router held to the program's own expert ids, recorded at
every prefill and decode step of the window (``nn.moe._route``
wrapped), so that the gaps that routing flips make drop out.  With
``control`` the plain reference computed with every product's inputs
rounded to float8_e4m3fn takes the program's place, as there.

Before the traced stretch, ``layer_steps`` more decode steps run with
the program's span recorder and counters on (``obs.profiling``; its
refills' prefills with them off) under a profile of host and device.
Each device kernel is put down to the host op that launched it (the
profiler's linked correlation) and that op to the innermost span
around its start, so that ``work`` holds the device ms a decode step
under each span name (``span_device_ms``: ``mla.decode``,
``moe.route``, ``moe.experts``, ``moe.shared``) and the counters a
decode step (``moe.routed``, ``moe.held``), for the readers of
``metrics/*.serve_moe.py``.  Where the program has no recorder or no
such span, they stay empty.
"""
from __future__ import annotations

import importlib
import math
import time

import numpy as np
import torch

from perfbench.counts import moe_lm as counts
from perfbench.generators import serve
from perfbench.lib import moe_lm, spans


def _device_ms_by_span(events, spans_log, steps: int) -> dict:
    """Device ms a step of the kernels launched under each span name,
    from the profiler's events and the recorder's spans (one clock)."""
    from torch.autograd import DeviceType
    host_at, kernels = {}, []
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            kernels.append((e.linked_correlation_id(), e.duration_ns()))
        elif e.linked_correlation_id() == 0:
            host_at[e.correlation_id()] = e.start_ns()
    ivs = sorted((s.start_ns, s.end_ns, s.name) for s in spans_log)
    starts = [iv[0] for iv in ivs]
    out: dict = {}
    for corr, ns in kernels:
        t = host_at.get(corr)
        if t is None:
            continue
        i = int(np.searchsorted(starts, t, side="right")) - 1
        while i >= 0 and ivs[i][1] < t:   # the innermost span around t
            i -= 1
        if i >= 0 and ivs[i][0] <= t <= ivs[i][1]:
            out[ivs[i][2]] = out.get(ivs[i][2], 0.0) + ns / 1e6 / steps
    return out


def _witness(rows: list, below, token_margins) -> dict:
    """The router's closest call (the reference's ``held_margin``, least
    over the MoE layers) beside the widest gaps: the ten widest rows'
    (gap, margin) and the ten widest served tokens', with the median
    margin over all rows and all tokens, so that a wide gap can be seen
    to sit at a choice near a tie."""
    rows = sorted(rows, reverse=True)
    tm = token_margins.double().numpy()
    widest = np.argsort(-below)[:10]
    return {"widest_rows": rows[:10],
            "row_margin_p50": float(np.median([m for _, m in rows])),
            "widest_tokens": [(float(below[i]), float(tm[i]))
                              for i in widest],
            "token_margin_p50": float(np.median(tm))}


class Traffic(serve.Traffic):
    def __init__(self, cell: dict, seed: int, device: torch.device):
        self.file, self.mix = cell["config"], cell["mix"]
        self.port = self.file["port"]
        self.ref = importlib.import_module(
            f"perfbench.reference.{self.file['reference']}")
        self.device, self.seed = device, int(seed)
        self.B, self.S = int(self.mix["max_batch"]), int(self.mix["max_seq"])
        n = int(self.mix["pool"])
        self.prompts = serve.quantiles(n, self.mix["prompt"])
        self.outputs = serve.quantiles(n, self.mix["output"])
        self.rng = np.random.default_rng(self.seed)
        self.n_check = int(self.mix["checked_requests"])
        self.body, self.per_key = counts.decode_token(self.port)
        self.head = counts.head_flops(self.port)
        self.uid, self.order = 0, None
        self.live, self.kept, self.longest = {}, [], None
        self.capturing, self._saved, self._admitting = False, [], None
        self._keep_rng = np.random.default_rng([self.seed, 1])
        self._answers = np.random.default_rng([self.seed, 3])
        self._phase = np.random.default_rng([self.seed, 4]).permutation(
            self.B)
        self.witness, self._routes, self._step_routes = False, [], []
        self._forced, self._unroute = {}, None

    def _refill(self, t_free: float) -> list:
        """A new request admitted into every free slot, one after the
        other; each one's ms from ``t_free`` to its first token."""
        ttft = []
        while (slot := self.engine.free_slot()) is not None:
            r = self._next()
            answered = np.zeros(0, np.int64)
            if r.uid < self.B:            # joining the loop mid-answer
                keep = max(1, round(r.budget * (self._phase[r.uid] + 0.5)
                                    / self.B))
                answered = self._answers.integers(
                    1, self.port["vocab"], r.budget - keep, dtype=np.int64)
                r = serve.Request(r.uid, r.prompt, keep,
                                  int(self.mix["checked_rows"]))
            r.slot = slot
            self._admitting = r
            self.engine.admit(r.uid, r.prompt, r.budget, answered=answered)
            ttft.append(1e3 * (time.perf_counter() - t_free))
            r.bucket = int(self.engine.pos[slot])
            self.live[slot] = r
            self.flops += counts.prompt_flops(
                self.port, len(r.prompt) + answered.size)
            if answered.size:             # the sequence its cache holds
                seq = np.full(r.bucket, int(self.mix["pad_id"]), np.int64)
                seq[: len(r.prompt)] = r.prompt
                seq[r.bucket - answered.size:] = answered
                r.prompt = seq
        self._admitting = None
        return ttft

    # -- the witness: the program's expert ids ------------------------------

    def _record_routes(self) -> None:
        mod = importlib.import_module("repro_torch.nn.moe")
        route = mod._route

        def recorded(xt, router, cfg):
            out = route(xt, router, cfg)
            if self.capturing:
                self._routes.append(out[1].to(torch.int16))
            return out
        mod._route = recorded
        self._unroute = lambda: setattr(mod, "_route", route)

    def _wrap_prefill(self, fn):
        inner = super()._wrap_prefill(fn)
        if not self.witness:
            return inner

        def prefill(*args, **kw):
            self._routes = []
            out = inner(*args, **kw)
            r = self._admitting
            if self.capturing and r is not None:
                self._forced[r.uid] = (torch.stack(self._routes),
                                       len(self._step_routes))
            return out
        return prefill

    def _wrap_decode(self, fn):
        inner = super()._wrap_decode(fn)
        if not self.witness:
            return inner

        def decode(*args, **kw):
            self._routes = []
            out = inner(*args, **kw)
            if self.capturing:
                self._step_routes.append(torch.stack(self._routes))
            return out
        return decode

    def _program_ids(self, r) -> torch.Tensor:
        """(MoE layers, bucket + budget, top_k): the expert ids the
        program chose at every position of ``r``'s sequence."""
        pre, first = self._forced[r.uid]
        dec = torch.stack(self._step_routes[first: first + r.budget])
        return torch.cat([pre, dec[:, :, r.slot].transpose(0, 1)], dim=1)

    def _forced_gaps(self, reqs, seqs, wants, picked, rows) -> dict:
        """The widest and middle gaps with the reference's router held to
        the program's expert ids."""
        force = [self._program_ids(r) for r in reqs]
        belows, gaps = [], []
        for x, tok, got in zip(self.ref.forward(
                self.w, self.port, seqs, wants, force=force), picked, rows):
            belows.append(x.max(dim=-1).values
                          - x.gather(1, tok[:, None])[:, 0])
            gaps += [float((row - x[k + 1]).abs().max()
                           / x[k + 1].abs().max()) for k, row in got.items()]
        below = torch.cat(belows).double().cpu().numpy()
        return {"token_gap_max": float(below.max()),
                "token_gap_p90": float(np.percentile(below, 90)),
                "logit_gap_max": max(gaps),
                "logit_gap_p50": float(np.median(gaps))}

    def setup(self) -> None:
        cfg = moe_lm.program_cfg(self.file)
        if self.witness:
            self._record_routes()
        from repro_torch.serving import Engine, ServeCfg
        self.w = moe_lm.weights(self.port, self.seed, self.device)
        self.engine = Engine(cfg, self.w, ServeCfg(
            max_batch=self.B, max_seq=self.S, eos_id=int(self.mix["eos_id"]),
            pad_id=int(self.mix["pad_id"])), device=self.device)
        warm = np.random.default_rng([self.seed, 2])
        b = serve.bucket(self.mix["prompt"]["min"], self.S)
        while b <= serve.bucket(self.mix["prompt"]["max"], self.S):
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

    def _layers(self) -> dict:
        """``layer_steps`` decode steps with the recorder on, under a
        profile (module docstring): span device ms and counters a step."""
        rec = spans.recorder()
        n = int(self.mix["layer_steps"])
        if rec is None or not hasattr(rec, "take_counts"):
            for _ in range(n):
                _, _, _, t = self._step()
                self._refill(t)
            return {}
        from torch.profiler import ProfilerActivity
        rec.take()
        rec.take_counts()
        acts = [ProfilerActivity.CPU]
        cuda = self.device.type == "cuda"
        if cuda:
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n):
                with rec.recording(annotate=False):
                    _, _, _, t = self._step()
                self._refill(t)
            if cuda:
                torch.cuda.synchronize()
        log = rec.take()
        per = {k: (v / n if isinstance(v, (int, float)) else None)
               for k, v in rec.take_counts().items()}
        dev = _device_ms_by_span(prof.profiler.kineto_results.events(),
                                 log.spans, n) if cuda else {}
        return {"span_device_ms": dev, "counts_per_step": per}

    def readings(self, control: bool = False) -> dict:
        reqs = self.kept + ([self.longest] if self.longest else [])
        worst = {k: math.inf for k in (
            "token_gap_p90", "logit_gap_p50", "prefill_gap_p50")}
        if not reqs:
            return worst
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
        margins = []
        refs = self.ref.forward(self.w, self.port, seqs, wants,
                                margins=margins)
        if control:
            cands = self.ref.forward(self.w, self.port, seqs, wants,
                                     mm=self.ref.fp8_matmul)
            picked = [c.argmax(dim=-1) for c in cands]
            rows = [{k: c[k + 1] for k in r.rows} for r, c in zip(reqs, cands)]
        else:
            picked = served
            rows = [{k: v.float() for k, v in r.rows.items()} for r in reqs]
        belows, gaps, first, calls = [], [], [], []
        for r, x, tok, got, want, m in zip(reqs, refs, picked, rows, wants,
                                           margins):
            if tok.shape[0] != x.shape[0] or -1 not in got:
                return worst
            belows.append(x.max(dim=-1).values
                          - x.gather(1, tok[:, None])[:, 0])
            gap = {k: float((row - x[k + 1]).abs().max()
                            / x[k + 1].abs().max()) for k, row in got.items()}
            gaps += gap.values()
            first.append(gap[-1])
            calls += [(g, float(m[r.bucket + k])) for k, g in gap.items()]
        below = torch.cat(belows).double().cpu().numpy()
        self.where = {"row_gaps": sorted(gaps), "prefill_gaps": first,
                      "token_gap_max": float(below.max()),
                      "logit_gap_max": max(gaps),
                      **_witness(calls, below, torch.cat(
                          [m[w] for m, w in zip(margins, wants)]).cpu())}
        if self.witness and not control:
            self.where["forced"] = self._forced_gaps(reqs, seqs, wants,
                                                     picked, rows)
        out = {"token_gap_p90": float(np.percentile(below, 90)),
               "logit_gap_p50": float(np.median(gaps)),
               "prefill_gap_p50": float(np.median(first))}
        return {k: v if math.isfinite(v) else math.inf
                for k, v in out.items()}

    def free(self) -> None:
        if self._unroute is not None:
            self._unroute()
            self._unroute = None
        super().free()

    def stretch(self):
        layers = self._layers()
        inner, work = super().stretch()

        def run():
            inner()
            work.update(layers)
        return run, work
