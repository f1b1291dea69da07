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

B cells: ``batch_act`` is the lockstep action of one agent over B cells'
observations with one generator (``None``: ``act`` is batch-transparent);
``act_stacked`` / ``update_stacked`` are the fused B-learner closures
(stacked state, per-cell generators, per-learner ``step`` values), and
``vmap_agent`` lifts an agent to B learners with them or, as their
reference, with a loop of the single-learner closures.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch


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
    policy at zero exploration; ``step_frame(state, reqs, models, mask)``
    the per-frame state advance of a stateful cacher, the classical
    cachers (``None`` for every other agent); ``diag_zero()`` the zero
    diagnostics of an update built with ``diag=True`` (the telemetry
    variant, ``None`` otherwise).

    B cells: ``batch_act(state, obs, generator, step)`` acts for B cells'
    batched obs in lockstep from one generator (``None``: ``act`` does);
    ``act_stacked(state, obs, generators, step)`` and
    ``update_stacked(state, batch, generators)`` run B learners' stacked
    state at once, learner b drawing from ``generators[b]`` what ``act`` /
    ``update`` draw from one, with ``step`` values that may be
    per-learner; ``stack(states)`` stacks B learners' states and
    ``learner(state, b)`` is learner b's state as views of the stack, so
    the single-learner closures update the stack in place (``None`` for
    agents without learned state)."""
    name: str
    learns: bool
    init: Callable
    act: Callable
    update: Callable
    export: Callable
    greedy: Callable
    step_frame: Optional[Callable] = None
    batch_act: Optional[Callable] = None
    act_stacked: Optional[Callable] = None
    update_stacked: Optional[Callable] = None
    stack: Optional[Callable] = None
    learner: Optional[Callable] = None
    diag_zero: Optional[Callable] = None


def no_update(state, batch, generator):
    """Shared ``update`` for non-learned agents: identity, no metrics."""
    return state, {}


def cell_of(x, b: int):
    """Cell (or learner) b of a batched value: a tensor's row b, a
    generator tuple's b-th, every field of a NamedTuple (an ``EnvState``,
    ``ModelParams``, an obs) or value of a dict cut alike; a per-learner
    list's entry b; numbers and ``None`` as they are."""
    if x is None or isinstance(x, (int, float, str)):
        return x
    if torch.is_tensor(x):
        return x[b] if x.dim() else x
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(cell_of(v, b) for v in x))
    if isinstance(x, dict):
        return {k: cell_of(v, b) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return x[b]
    raise TypeError(f"cannot cut a cell out of {type(x).__name__}")


def _stack_out(outs):
    """Per-learner outputs -> stacked: tensors stacked, tuples and dicts
    field by field."""
    first = outs[0]
    if torch.is_tensor(first):
        return torch.stack(outs)
    if isinstance(first, dict):
        return {k: _stack_out([o[k] for o in outs]) for k in first}
    return tuple(_stack_out(list(x)) for x in zip(*outs))


def _loop_act(agent: Agent):
    """B learners' ``act`` as a loop of the single-learner ``act``, each on
    its learner's view, its cell's obs, generator and step values."""
    def act(state, obs, generators, step):
        views = _views(agent, state, len(generators))
        return _stack_out([agent.act(views[b], cell_of(obs, b), g,
                                     cell_of(step, b))
                           for b, g in enumerate(generators)])
    return act


def _views(agent: Agent, state, B: int):
    if agent.learner is None:
        return [state] * B
    return [agent.learner(state, b) for b in range(B)]


def _loop_update(agent: Agent):
    """B learners' ``update`` as a loop of the single-learner ``update``:
    each writes its learner's slice of the stack in place; the Adam steps
    (host ints) are taken back from learner 0's, all being equal."""
    def update(state, batch, generators):
        outs = [agent.update(view, cell_of(batch, b), g)
                for b, (view, g) in enumerate(
                    zip(_views(agent, state, len(generators)), generators))]
        for k, v in outs[0][0].items():
            if isinstance(v, dict) and "step" in v:
                state[k]["step"] = v["step"]
        metrics = [m for _, m in outs]
        return state, (_stack_out(metrics) if metrics[0] else {})
    return update


def vmap_agent(agent: Agent, impl: str = "fused") -> Agent:
    """Lift an agent to B independent learners as one stacked state.

    The returned agent's ``init`` takes B generators and stacks B fresh
    learners (learner b drawn from generator b as ``init`` draws from
    one); ``act``/``update`` take the stacked state, per-cell obs or
    minibatches (B-leading) and the B generators.  ``impl``:

    - ``"fused"``: the agent's ``act_stacked``/``update_stacked`` (all B
      learners in single batched products, one stacked chain launch and
      one fused Adam pass); an agent that lacks them is refused, and a
      non-learned agent keeps its ``update`` (``no_update``);
    - ``"vmap"``: a loop over learners of the single-learner ``act`` /
      ``update``, each on its learner's views, its cell's slice and its
      own generator — the reference the fused closures are held against.
      ``torch.func.vmap`` is not used: it cannot carry the per-cell
      explicit generators, nor a kernel launched through ctypes.
    """
    if impl not in ("fused", "vmap"):
        raise ValueError(f"vmap_agent: unknown impl {impl!r}; "
                         f"expected 'fused' or 'vmap'")
    fused = impl == "fused"

    def init(generators):
        states = [agent.init(g) for g in generators]
        return agent.stack(states) if agent.stack is not None else {}

    if not fused:
        act, update = _loop_act(agent), _loop_update(agent)
    elif agent.act_stacked is None or (agent.learns
                                       and agent.update_stacked is None):
        raise ValueError(f"vmap_agent: {agent.name!r} has no fused "
                         f"closures; use impl='vmap'")
    else:
        act = agent.act_stacked
        update = agent.update_stacked if agent.learns else agent.update
    return agent._replace(init=init, act=act, update=update, batch_act=None,
                          act_stacked=None, update_stacked=None)
