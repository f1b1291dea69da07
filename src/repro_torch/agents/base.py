"""The agent protocol (DESIGN.md §12), port of ``repro.agents.base``: one
learner API for every method.

An :class:`Agent` is a NamedTuple of closures over a frozen config —
``init(generator) -> state``, ``act(state, obs, generator, step) ->
action``, ``update(state, batch, generator) -> (state, metrics)`` — plus
the inference-side closures the serving paths need (``export``,
``greedy``).  The two-timescale loop in ``repro_torch.core.t2drl`` is
written against this protocol only; which method runs is decided once,
in ``make_allocator`` / ``make_cacher``.

Conventions, as the reference's with a ``torch.Generator`` where it
passes keys (the generator advances in place, so an agent draws from it
in a fixed order and never needs a key split):

- ``obs`` is a :class:`SlotObs` for allocators and a :class:`FrameObs`
  for cachers.
- ``step`` is a dict of the episode's schedule values (``eps``,
  ``sigma``) as host floats.
- ``batch`` for ``update`` is the sampled replay minibatch; the reserved
  keys ``mask`` / ``lr_actor`` / ``lr_critic`` (allocators) and ``lr``
  (cachers) carry per-call auxiliaries and are stripped before the
  minibatch reaches the numeric update.
- Learned state is updated in place (the numeric updates do), and
  ``update`` returns it.

``vmap_agent`` and the batched/stacked closures wait for ROADMAP A.6.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional


class SlotObs(NamedTuple):
    """What a per-slot allocator may condition on: ``s`` the Eq. (21)
    observation vector, ``env`` the raw ``EnvState`` (the amenders need
    ``req``/``rho``), ``models`` the cell's model zoo, ``mask`` an
    optional ``(U,)`` active-user mask."""
    s: Any
    env: Any
    models: Any
    mask: Any = None


class FrameObs(NamedTuple):
    """What a per-frame cacher may condition on: the popularity state index
    ``gamma_idx`` and the model zoo (per-model storage sizes)."""
    gamma_idx: Any
    models: Any


class Agent(NamedTuple):
    """A learner as a bundle of closures (DESIGN.md §12).

    ``name`` is the method name; ``learns`` whether the episode stores
    transitions and calls ``update``; ``init(generator)`` builds a fresh
    state on the generator's device; ``act`` returns the amended
    ``(b, xi)`` (allocators) or ``(a_int, rho)`` (cachers);
    ``update(state, batch, generator) -> (state, metrics)``;
    ``export(state)`` the inference-only slice (empty for non-learned
    agents); ``greedy(policy, obs, generator)`` inference from an exported
    policy at zero exploration; ``step_frame`` the per-frame state advance
    of a stateful cacher (``None`` for every ported agent; the classical
    cachers that need it wait for ROADMAP A.7)."""
    name: str
    learns: bool
    init: Callable
    act: Callable
    update: Callable
    export: Callable
    greedy: Callable
    step_frame: Optional[Callable] = None


def no_update(state, batch, generator):
    """Shared ``update`` for non-learned agents: identity, no metrics."""
    return state, {}


def vmap_agent(agent: Agent, impl: str = "fused") -> Agent:
    """Not ported yet: B independent learners as one stacked state come
    with the vector-env modes (ROADMAP queue A, item 6)."""
    raise NotImplementedError("vmap_agent: B-learner agents are not ported "
                              "yet (ROADMAP queue A, item 6)")
