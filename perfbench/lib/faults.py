"""Faults planted in the program, to show that the output check fails
them.

``planted(name)`` replaces some of the program's functions, looked up by
module and name, while it is entered; a run made inside it must come out
``correct: false``.  Each fault covers every mix:

- ``unchanged``: a step that returns its state unchanged: both learners'
  Adam steps leave parameters and moments as they are, the frame's
  caching decision is not applied to the env state, and a served model's
  decode step returns the cache it was given;
- ``half_batch``: half of the batch left out: the D3PG and DDQN updates
  see the first half of each minibatch (their means taken over it), a
  decision's chain serves the first half of the cells, the second half
  getting the first half's rows, and a decode step serves the first half
  of the slots (the rest keep their cache), the second half getting the
  first half's logits;
- ``altered``: an answer altered where it is produced: the allocator's
  amended bandwidth share of each cell's first user is raised by 0.05,
  the env's slot reward is scaled by 1.05, and a prefill's first token
  is moved to the one after its argmax.

The benchmark's own runs plant nothing; ``calibrate.py --fault`` and the
tests do.
"""
from __future__ import annotations

import contextlib
import importlib

import torch

FAULTS = ("unchanged", "half_batch", "altered")
ENGINE = "repro_torch.serving.engine"


def _adam_unchanged(fn):
    def adam(grads, state, params, **kw):
        return params, {**state, "step": state["step"] + 1}, {}
    return adam


def _set_cache_unchanged(fn):
    def set_cache(state, rho):
        return state
    return set_cache


def _half(batch: dict) -> dict:
    n = next(iter(batch.values())).shape[1]
    return {k: v[:, : n // 2] for k, v in batch.items()}


def _d3pg_half(fn):
    def update(params, cfg, sched, batch, generators=None, **kw):
        return fn(params, cfg, sched, _half(batch), generators, **kw)
    return update


def _ddqn_half(fn):
    def update(params, cfg, batch, **kw):
        return fn(params, cfg, _half(batch), **kw)
    return update


def _act_half(fn):
    def act(actor, cfg, sched, state, generator=None, **kw):
        n = state.shape[0] // 2
        raw = fn(actor, cfg, sched, state[:n], generator, **kw)
        return raw.repeat((2,) + (1,) * (raw.dim() - 1))[:state.shape[0]]
    return act


def _amend_altered(fn):
    def amend(raw, req, rho, U, **kw):
        b, xi = fn(raw, req, rho, U, **kw)
        b = b.clone()
        b[..., 0] += 0.05
        return b, xi
    return amend


def _reward_altered(fn):
    def env_step(*args, **kw):
        nxt, r, m = fn(*args, **kw)
        return nxt, r * 1.05, m
    return env_step


def _tmap(fn, *trees):
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tmap(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, list):
        return [_tmap(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def _decode_unchanged(fn):
    def decode(p, cfg, token, cache, pos, **kw):
        logits, _ = fn(p, cfg, token, cache, pos, **kw)
        return logits, cache
    return decode


def _decode_half(fn):
    def decode(p, cfg, token, cache, pos, **kw):
        B = token.shape[0]
        h = B // 2
        sub = _tmap(lambda c: c[:, :h], cache)
        logits, new = fn(p, cfg, token[:h], sub, pos[:h], **kw)
        cache = _tmap(lambda c, n: torch.cat([n.to(c.dtype), c[:, h:]],
                                             dim=1), cache, new)
        return torch.cat([logits, logits[: B - h]]), cache
    return decode


def _prefill_altered(fn):
    def prefill(p, cfg, tokens, cache, **kw):
        logits, new = fn(p, cfg, tokens, cache, **kw)
        row = logits[0, -1]
        nxt = (int(torch.argmax(row)) + 1) % row.shape[0]
        logits = logits.clone()
        logits[0, -1, nxt] = row.max() + 1.0
        return logits, new
    return prefill


SITES = {
    "unchanged": (("repro_torch.core.d3pg", "adam_update_stacked",
                   _adam_unchanged),
                  ("repro_torch.core.ddqn", "adam_update_stacked",
                   _adam_unchanged),
                  ("repro_torch.core.t2drl", "env_set_cache",
                   _set_cache_unchanged),
                  ("repro_torch.core.env", "env_set_cache",
                   _set_cache_unchanged),
                  (ENGINE, "lm_decode", _decode_unchanged)),
    "half_batch": (("repro_torch.agents.allocators", "d3pg_update_stacked",
                    _d3pg_half),
                   ("repro_torch.agents.cachers", "ddqn_update_stacked",
                    _ddqn_half),
                   ("repro_torch.agents.allocators", "actor_act",
                    _act_half),
                   (ENGINE, "lm_decode", _decode_half)),
    "altered": (("repro_torch.agents.allocators", "amend_actions",
                 _amend_altered),
                ("repro_torch.core.t2drl", "env_step_slot",
                 _reward_altered),
                (ENGINE, "lm_prefill", _prefill_altered)),
}


@contextlib.contextmanager
def planted(name: str):
    """The program with fault ``name`` (one of ``FAULTS``) planted."""
    saved = []
    try:
        for mod_name, attr, make in SITES[name]:
            mod = importlib.import_module(mod_name)
            saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, make(getattr(mod, attr)))
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)
