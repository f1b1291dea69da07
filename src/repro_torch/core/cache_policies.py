"""Classical cache-hierarchy state machines (DESIGN.md §14), port of
``repro.core.cache_policies``: LRU, LFU, ghost-augmented LRU and ARC over
a fixed-size state of ``(M,)`` membership and timestamp tensors.

The layout and the decisions are the reference's, bit for bit:

- the item universe is the ``M`` GenAI model types; the recency,
  frequency and ghost *lists* are ``(M,)`` bool membership masks and
  ``(M,)`` int32 access / ghost-entry clocks (list order = clock order,
  ties broken toward the lowest model id);
- capacity is counted in INTEGER size units (``SIZE_UNITS_PER_GB``-ths
  of a GB: item sizes rounded up, capacity down), so every admission and
  eviction is exact integer arithmetic;
- the four ARC cases, the ghost bookkeeping and the directory trims are
  the reference's, gated branch-free by the case booleans.

Every op is elementwise over the trailing ``(M,)`` axis, so one call
serves one cell (``(M,)`` leaves, 0-dim ``m``/``valid``) or B cells
(``(B, M)`` leaves, ``(B,)`` ``m``/``valid``) with the same launches.
Nothing reads a device value back to the host: a frame's replay queues on
the device without a stall.

Evictions.  The reference evicts in a ``fori_loop`` of M passes, each
removing the oldest member (lowest ``(order, id)``) while the members
exceed a budget.  The victims are a prefix of the members in that order,
and item i is among them exactly when the members' units minus those of
the members before it still exceed the budget; so the port computes the
same victims at once, from a pairwise ``(M, M)`` precedence matrix
(``_evict_prefix``), with no loop and no data-dependent launch count.
LFU orders by ``(freq, last, id)``, which its loop keeps fixed while it
evicts (only victims' counts change).  ARC's REPLACE alternates between
T1 and T2 by a condition on T1's units that only falls as T1 shrinks, so
its victims are three such prefixes: T1 while that condition holds, then
T2, then T1 again if T2 ran dry (``_arc_replace``).
``tests/test_torch_cache.py`` holds every decision against the pure
Python loops of ``tests/_cache_refs.py`` and the JAX machines.

Every ``*_access`` has the reference's signature::

    state, info = <kind>_access(state, m, c_units, cap_units, valid)

``m`` the accessed model id(s) (int64), ``c_units`` the ``(..., M)``
int32 item sizes, ``cap_units`` the capacity (a number, or one per cell),
``valid`` a bool gate (``None``: every access is valid; False: a full no-op).  ``info`` is
the decision trace: ``hit``, ``admitted`` and the ``(..., M)`` ``evicted``
mask.
"""
from __future__ import annotations

import math

import torch

# Integer capacity resolution: 64 units per GB (a power of two, so the
# f32 GB -> unit scaling in quantize_sizes is exact).
SIZE_UNITS_PER_GB = 64

CACHE_POLICIES = ("lru", "lfu", "lru-ghost", "arc")

_I32 = torch.int32


def quantize_sizes(c) -> torch.Tensor:
    """Model sizes (GB, float) -> conservative integer units (ceil), int32."""
    return torch.ceil(torch.as_tensor(c, dtype=torch.float32)
                      * SIZE_UNITS_PER_GB).to(_I32)


def quantize_capacity(C: float) -> int:
    """Cache capacity (GB) -> conservative integer units (floor): with
    sizes rounded up, a unit-feasible cache content is GB-feasible, so the
    classical cachers never pay the storage penalty (11d)."""
    return int(math.floor(C * SIZE_UNITS_PER_GB))


def cache_state_init(M: int, device=None, lead: tuple = ()) -> dict:
    """Fresh (empty) cache state, the reference's layout: resident lists
    ``in_t1``/``in_t2`` (plain LRU/LFU use only ``in_t1``), ghost lists
    ``in_b1``/``in_b2``, access and ghost-entry clocks ``last``/``glast``
    (-1: never), in-cache counts ``freq``, the logical clock ``time`` and
    ARC's target ``p``.  ``lead`` prepends cell axes (``(B,)``).  No draw:
    adding the slot leaves every generator stream as it was."""
    shape = tuple(lead) + (M,)
    z = torch.zeros(shape, dtype=torch.bool, device=device)
    return {"in_t1": z, "in_t2": z.clone(), "in_b1": z.clone(),
            "in_b2": z.clone(),
            "last": torch.full(shape, -1, dtype=_I32, device=device),
            "glast": torch.full(shape, -1, dtype=_I32, device=device),
            "freq": torch.zeros(shape, dtype=_I32, device=device),
            "time": torch.zeros(tuple(lead), dtype=_I32, device=device),
            "p": torch.zeros(tuple(lead), dtype=_I32, device=device)}


def cache_rho(state) -> torch.Tensor:
    """Resident set as the env's float 0/1 caching vector."""
    return (state["in_t1"] | state["in_t2"]).to(torch.float32)


def _units(members, c_units):
    """Total size units of a membership mask (exact integer sum)."""
    return torch.sum(torch.where(members, c_units, 0), dim=-1)


def _ids(M: int, device):
    return torch.arange(M, device=device)


def _onehot(m, M: int):
    return _ids(M, m.device) == m[..., None]


def _at(x, oh):
    """``x[m]`` of a bool mask, through the one-hot of m."""
    return torch.any(x & oh, dim=-1)


def _precedes(keys, M: int):
    """(..., M, M) bool: ``[..., i, j]`` is True when j comes before i in
    the order of the lexicographic ``keys`` (a tuple of (..., M) integer
    tensors, most significant first), ties broken toward the lower id."""
    ids = _ids(M, keys[0].device)
    before = ids[None, :] < ids[:, None]
    for k in reversed(keys):
        ki, kj = k[..., :, None], k[..., None, :]
        before = (kj < ki) | ((kj == ki) & before)
    return before


def _evict_prefix(members, before, c_units, budget):
    """The members that the reference's eviction loop removes: in the
    order ``before`` (``_precedes``), oldest first, while the members'
    units exceed ``budget`` — member i goes when the units of itself and
    every member after it exceed the budget."""
    sizes = torch.where(members, c_units, 0)
    ahead = torch.sum(torch.where(before, sizes[..., None, :], 0), dim=-1)
    total = torch.sum(sizes, dim=-1, keepdim=True)
    return members & (total - ahead > _col(budget))


def _col(x):
    """A per-cell value against a (..., M) axis."""
    return x[..., None] if torch.is_tensor(x) and x.dim() else x


def _gate(valid, new: dict, old: dict, info: dict):
    """valid False: a full no-op (state unchanged, all-false trace)."""
    if valid is None:
        return new, info
    state = {k: (v if v is old[k] else torch.where(
        _col(valid) if v.dim() > valid.dim() else valid, v, old[k]))
        for k, v in new.items()}
    info = {k: v & (_col(valid) if v.dim() > valid.dim() else valid)
            for k, v in info.items()}
    return state, info


# -- LRU ----------------------------------------------------------------------

def lru_access(state, m, c_units, cap_units, valid=None):
    """Least-recently-used: a hit refreshes recency; a miss that can ever
    fit (size <= capacity) evicts LRU residents until it fits, then is
    admitted."""
    M = c_units.shape[-1]
    t = state["time"] + 1
    oh = _onehot(m, M)
    in_c, last = state["in_t1"], state["last"]
    hit = _at(in_c, oh)
    size_m = torch.sum(torch.where(oh, c_units, 0), dim=-1)
    admit = ~hit & (size_m <= cap_units)
    ev = _evict_prefix(in_c, _precedes((last,), M), c_units,
                       cap_units - size_m) & _col(admit)
    in_c_new = torch.where(_col(admit), (in_c & ~ev) | oh, in_c)
    last_new = torch.where(oh & _col(hit | admit), _col(t), last)
    new = dict(state, in_t1=in_c_new, last=last_new, time=t)
    return _gate(valid, new, state,
                 {"hit": hit, "admitted": admit, "evicted": ev})


# -- LFU ----------------------------------------------------------------------

def lfu_access(state, m, c_units, cap_units, valid=None):
    """Least-frequently-used with in-cache counts (reset on eviction);
    recency, then the lower id, breaks frequency ties."""
    M = c_units.shape[-1]
    t = state["time"] + 1
    oh = _onehot(m, M)
    in_c, last, freq = state["in_t1"], state["last"], state["freq"]
    hit = _at(in_c, oh)
    size_m = torch.sum(torch.where(oh, c_units, 0), dim=-1)
    admit = ~hit & (size_m <= cap_units)
    ev = _evict_prefix(in_c, _precedes((freq, last), M), c_units,
                       cap_units - size_m) & _col(admit)
    in_c_new = torch.where(_col(admit), (in_c & ~ev) | oh, in_c)
    freq_new = torch.where(ev, 0, freq)
    freq_new = torch.where(oh & _col(hit), freq + 1, freq_new)
    freq_new = torch.where(oh & _col(admit), 1, freq_new).to(_I32)
    last_new = torch.where(oh & _col(hit | admit), _col(t), last)
    new = dict(state, in_t1=in_c_new, last=last_new, freq=freq_new, time=t)
    return _gate(valid, new, state,
                 {"hit": hit, "admitted": admit, "evicted": ev})


# -- ghost-augmented LRU (admission-filtered) ---------------------------------

def lru_ghost_access(state, m, c_units, cap_units, valid=None):
    """LRU with a ghost-list admission filter: a first-touch miss only
    records the id in the ghost list; a miss whose id is ghost-listed is
    admitted.  Victims re-enter the ghost list, which is itself
    LRU-bounded to ``cap_units`` worth of ids."""
    M = c_units.shape[-1]
    t = state["time"] + 1
    oh = _onehot(m, M)
    in_c, in_g = state["in_t1"], state["in_b1"]
    last, glast = state["last"], state["glast"]
    hit = _at(in_c, oh)
    size_m = torch.sum(torch.where(oh, c_units, 0), dim=-1)
    ghost_hit = ~hit & _at(in_g, oh)
    admit = ghost_hit & (size_m <= cap_units)
    record = ~hit & ~ghost_hit            # first touch: doorkeeper entry
    ev = _evict_prefix(in_c, _precedes((last,), M), c_units,
                       cap_units - size_m) & _col(admit)
    in_c_new = torch.where(_col(admit), (in_c & ~ev) | oh, in_c)
    last_new = torch.where(oh & _col(hit | admit), _col(t), last)
    # ghost bookkeeping: admitted ids leave, victims and first touches enter
    enter = ev | (oh & _col(record))
    in_g_new = (in_g & ~(oh & _col(admit))) | enter
    glast_new = torch.where(enter, _col(t), glast)
    in_g_new = in_g_new & ~_evict_prefix(
        in_g_new, _precedes((glast_new,), M), c_units, cap_units)
    new = dict(state, in_t1=in_c_new, in_b1=in_g_new, last=last_new,
               glast=glast_new, time=t)
    return _gate(valid, new, state,
                 {"hit": hit, "admitted": admit, "evicted": ev})


# -- ARC ----------------------------------------------------------------------

def _arc_replace(t1, t2, last, p, b2_hit, do, size_m, c_units, cap_units):
    """ARC REPLACE, size-aware: the victims of the reference's loop, which
    evicts the LRU of T1 while T1 exceeds the target ``p`` (or equals it
    on a B2 hit) or T2 is empty, else the LRU of T2, until ``size_m``
    more units fit.  That condition only falls as T1 shrinks, so T1 loses
    the prefix that keeps it true and the space short (``a``), then T2
    the prefix that keeps the space short (``b``), then, only if T2 ran
    dry, T1 its prefix that keeps the space short without T2 (``c``).
    Returns the T1 and T2 victims; ``do`` gates all of it."""
    M = c_units.shape[-1]
    order = _precedes((last,), M)
    t1u, t2u = _units(t1, c_units), _units(t2, c_units)
    room = cap_units - size_m
    a = _evict_prefix(t1, order, c_units,
                      torch.maximum(room - t2u, p - b2_hit.to(p.dtype)))
    a = a & _col(t2.any(-1))          # T2 empty: only ``c`` evicts from T1
    ev2 = _evict_prefix(t2, order, c_units, room - (t1u - _units(a, c_units)))
    dry = ~torch.any(t2 & ~ev2, dim=-1)
    c = _evict_prefix(t1, order, c_units, room) & _col(dry)
    do = _col(do)
    return (a | c) & do, ev2 & do


def arc_access(state, m, c_units, cap_units, valid=None):
    """Adaptive Replacement Cache, size-aware, the reference's four cases:
    a resident hit promotes to T2; B1/B2 ghost hits steer ``p`` toward
    recency/frequency and re-admit into T2; cold misses admit into T1.
    Every cache eviction ghosts (T1 -> B1, T2 -> B2); the directory
    invariants (T1 + B1 <= cap, total <= 2 cap, in size units) are
    restored by trimming the oldest ghosts after the access."""
    M = c_units.shape[-1]
    t = state["time"] + 1
    oh = _onehot(m, M)
    t1, t2 = state["in_t1"], state["in_t2"]
    b1, b2 = state["in_b1"], state["in_b2"]
    last, glast, p = state["last"], state["glast"], state["p"]
    size_m = torch.sum(torch.where(oh, c_units, 0), dim=-1)
    hit = _at(t1 | t2, oh)
    b1_hit = ~hit & _at(b1, oh)
    b2_hit = ~hit & _at(b2, oh)
    admit = ~hit & (size_m <= cap_units)     # ghost hits and cold misses
    b1u, b2u = _units(b1, c_units), _units(b2, c_units)
    # adaptation: a B1 hit grows the recency target, a B2 hit shrinks it
    d1 = torch.maximum(size_m, torch.div(b2u, torch.clamp_min(b1u, 1),
                                         rounding_mode="floor") * size_m)
    d2 = torch.maximum(size_m, torch.div(b1u, torch.clamp_min(b2u, 1),
                                         rounding_mode="floor") * size_m)
    p_new = torch.where(b1_hit, torch.clamp_max(p + d1, cap_units),
                        torch.where(b2_hit, torch.clamp_min(p - d2, 0),
                                    p)).to(_I32)
    ev1, ev2 = _arc_replace(t1, t2, last, p_new, b2_hit, admit, size_m,
                            c_units, cap_units)
    ev = ev1 | ev2
    b1 = b1 | ev1
    b2 = b2 | ev2
    glast = torch.where(ev, _col(t), glast)
    t1 = t1 & ~ev1
    t2 = t2 & ~ev2
    # resident hit: T1 -> T2 promotion (a T2 hit refreshes recency only)
    promote = oh & _col(hit)
    t1 = t1 & ~promote
    # admission: ghost hits re-enter as frequent (T2), cold misses as
    # recent (T1); the id leaves the ghost directory
    ghost_admit = oh & _col(admit & (b1_hit | b2_hit))
    cold_admit = oh & _col(admit & ~(b1_hit | b2_hit))
    b1 = b1 & ~ghost_admit
    b2 = b2 & ~ghost_admit
    t2 = t2 | promote | ghost_admit
    t1 = t1 | cold_admit
    last = torch.where(oh & _col(hit | admit), _col(t), last)
    # directory trims (oldest ghosts first): T1+B1 <= cap, total <= 2*cap
    gorder = _precedes((glast,), M)
    t1u = _units(t1, c_units)
    b1 = b1 & ~_evict_prefix(b1, gorder, c_units,
                             torch.clamp_min(cap_units - t1u, 0))
    tot = t1u + _units(t2, c_units) + _units(b1, c_units)
    b2 = b2 & ~_evict_prefix(b2, gorder, c_units,
                             torch.clamp_min(2 * cap_units - tot, 0))
    new = dict(state, in_t1=t1, in_t2=t2, in_b1=b1, in_b2=b2, last=last,
               glast=glast, p=p_new, time=t)
    return _gate(valid, new, state,
                 {"hit": hit, "admitted": admit, "evicted": ev})


_ACCESS = {"lru": lru_access, "lfu": lfu_access,
           "lru-ghost": lru_ghost_access, "arc": arc_access}


def cache_access(kind: str, state, m, c_units, cap_units, valid=None):
    """One access through policy ``kind`` — the one place classical
    policy kinds are branched on."""
    if kind not in _ACCESS:
        raise ValueError(f"unknown cache policy {kind!r}; expected one of "
                         f"{CACHE_POLICIES}")
    return _ACCESS[kind](state, m, c_units, cap_units, valid)
