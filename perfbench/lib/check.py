"""The gaps that decide ``correct``, and their limits.

Every number compared is a gap between a candidate (the program's
output, or the control's) and the plain reference's, worst over the
cells, learners, leaves or steps it covers.  A gap that is not finite
reads as infinity, so it fails any limit.
"""
from __future__ import annotations

import math

import torch


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def max_abs(cand, ref) -> float:
    """Widest absolute gap."""
    if cand.shape != ref.shape:
        return math.inf
    return _finite(float(torch.max(torch.abs(cand.double() - ref.double()))))


def max_rel(cand, ref) -> float:
    """Widest gap relative to the reference's largest magnitude: exact
    copies read 0."""
    if cand.shape != ref.shape:
        return math.inf
    c, r = cand.double(), ref.double()
    scale = max(float(torch.max(torch.abs(r))), 1e-30)
    return _finite(float(torch.max(torch.abs(c - r))) / scale)


def loss_gap(cand, ref) -> float:
    """Worst gap of per-learner losses (B,), each against the larger of
    its reference loss and the learners' median."""
    c, r = cand.double(), ref.double()
    scale = torch.clamp_min(torch.abs(r), float(torch.median(torch.abs(r))))
    return _finite(float(torch.max(torch.abs(c - r) / scale.clamp_min(
        1e-30))))


def leaf_norms(leaves) -> torch.Tensor:
    """(B, n_leaves) norms of each learner's slice of each leaf."""
    return torch.stack([x.double().reshape(x.shape[0], -1).norm(dim=1)
                        for x in leaves], dim=1)


def norm_gap(cand_leaves, ref_leaves, keep=None, where=None) -> float:
    """Worst leaf's gap between the candidate's norm and the
    reference's, each against the larger of the reference's norm of that
    leaf and the median leaf's (over learners and leaves): the gap of
    norms, not the norm of the difference.  ``keep``: (B, n_leaves)
    bool, the leaves that count.  ``where``: a dict that receives the
    worst leaf's learner, index and norms."""
    nc, nr = leaf_norms(cand_leaves), leaf_norms(ref_leaves)
    if nc.shape != nr.shape:
        return math.inf
    med = float(torch.median(nr))
    scale = torch.clamp_min(nr, med).clamp_min(1e-30)
    gap = torch.abs(nc - nr) / scale
    if keep is not None:
        gap = torch.where(keep, gap, torch.zeros_like(gap))
    if where is not None:
        b, leaf = divmod(int(torch.argmax(gap)), gap.shape[1])
        where.update(learner=b, leaf=leaf, cand=float(nc[b, leaf]),
                     ref=float(nr[b, leaf]), median=med,
                     gap=float(gap[b, leaf]))
    return _finite(float(torch.max(gap)))


def moving(grad_leaves, floor: float = 1e-3) -> torch.Tensor:
    """The leaves whose reference gradient is not nought to rounding: a
    norm of at least ``floor`` times the median leaf's."""
    n = leaf_norms(grad_leaves)
    return n >= floor * float(torch.median(n))


def verdict(values: dict, limits: dict) -> tuple:
    """``(correct, checks)``: every number beside its limit; correct when
    each is finite and at most its limit, and every limit has a number."""
    checks = {k: {"value": values.get(k, math.inf), "limit": limits[k]}
              for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
