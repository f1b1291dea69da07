"""Synthetic data pipelines (port of ``repro.data.synthetic``).

``make_lm_batch`` produces learnable token streams (a noisy affine
successor chain over the vocabulary), so a training run shows a loss that
really falls.  ``request_stream`` generates the AIGC request workload
(Poisson arrivals, Zipf popularity over models) with numpy, as the
reference does.

Draws come from a ``torch.Generator``: threefry cannot be reproduced in
torch, so a batch has the reference's distribution, not its values.  The
batch is built on the host and moved to the device once; the successor
rule is a loop over the sequence, which on the card would be L small
launches a batch.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device

RULE_A, RULE_C = 31, 17   # the affine successor: (a·token + c) mod vocab


def make_lm_batch(generator: torch.Generator, *, vocab: int, batch: int,
                  seq_len: int, structure: float = 0.8,
                  device=None) -> dict:
    """token_{t+1} = (a·token_t + c) mod vocab with probability
    ``structure``, uniform otherwise.  ``generator`` is a CPU generator;
    the batch lands on ``resolve_device(device)``.  Returns {"tokens",
    "labels"} (B, L) int64, the labels the next-token targets (tokens are
    the labels shifted right behind a uniform first token)."""
    if generator.device.type != "cpu":
        raise ValueError("make_lm_batch builds the batch on the host: pass "
                         "a CPU generator")
    dev = resolve_device(device)
    first = torch.randint(0, vocab, (batch,), generator=generator)
    noise = torch.randint(0, vocab, (batch, seq_len), generator=generator)
    use_rule = torch.rand((batch, seq_len), generator=generator) < structure
    labels = torch.empty((batch, seq_len), dtype=torch.int64)
    tok = first
    for t in range(seq_len):
        tok = torch.where(use_rule[:, t], (RULE_A * tok + RULE_C) % vocab,
                          noise[:, t])
        labels[:, t] = tok
    tokens = torch.cat([first[:, None], labels[:, :-1]], dim=1)
    return {"tokens": tokens.to(dev), "labels": labels.to(dev)}


def lm_batch_stream(seed: int, *, vocab: int, batch: int, seq_len: int,
                    structure: float = 0.8,
                    device=None) -> Iterator[dict]:
    """Endless ``make_lm_batch`` batches from one CPU generator seeded by
    ``seed`` (it advances batch by batch)."""
    g = torch.Generator().manual_seed(int(seed))
    while True:
        yield make_lm_batch(g, vocab=vocab, batch=batch, seq_len=seq_len,
                            structure=structure, device=device)


@dataclasses.dataclass(frozen=True)
class Request:
    uid: int
    model_id: int
    prompt_len: int
    max_new_tokens: int
    arrival: float


def request_stream(seed: int, *, n_models: int, gamma: float = 0.5,
                   rate: float = 2.0, prompt_len=(16, 128),
                   new_tokens=(8, 64), n: Optional[int] = None):
    """Poisson arrivals of AIGC requests with Zipf(model) popularity; the
    reference's numpy draws, so the same seed gives the same requests."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n_models + 1, dtype=np.float64)
    probs = ranks ** -gamma
    probs /= probs.sum()
    t, i = 0.0, 0
    while n is None or i < n:
        t += rng.exponential(1.0 / rate)
        yield Request(
            uid=i,
            model_id=int(rng.choice(n_models, p=probs)),
            prompt_len=int(rng.integers(*prompt_len)),
            max_new_tokens=int(rng.integers(*new_tokens)),
            arrival=t)
        i += 1
