"""Operations and bytes of the T2DRL control plane's work, from shapes.

A frozen copy of the bound arithmetic that ``chip_smoke.py`` applies to
the chain kernels (``chain_bound_ms``, ``chain_bwd_bound_ms``), extended to
the networks, optimiser passes and steps around them.  Every count follows
the algorithm's shapes (denoiser, critic and Q-net widths, chain length L,
rows R, learners B, minibatch), never a kernel's own loads: each input is
read once, each output written once, so a later kernel that computes the
same work reads the same count.  Elementwise arithmetic of the env and of
the amenders is left out (under 0.1% of a slot's operations).

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit: 67
TFLOP/s f32 outside the tensor cores, 3.35 TB/s of HBM3.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
TIME_DIM = 16           # the denoiser's sinusoidal step embedding
ADAM_FLOPS = 16         # per parameter: the two moments, the step, the norm
LERP_FLOPS = 3          # per parameter: a soft update of a target


class Work(NamedTuple):
    """Floating-point operations and bytes that must cross HBM."""
    flops: float
    nbytes: float

    def __add__(self, other):
        return Work(self.flops + other.flops, self.nbytes + other.nbytes)

    def __mul__(self, k):
        return Work(self.flops * k, self.nbytes * k)

    __rmul__ = __mul__


def bound_s(work: Work) -> tuple:
    """Least seconds for ``work`` on the card, and what bounds it:
    ``(seconds, "operations" | "bytes")``."""
    t_ops = work.flops / F32_FLOPS
    t_bytes = work.nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def _pairs(dims: Sequence[int]):
    return list(zip(dims[:-1], dims[1:]))


def n_params(dims: Sequence[int]) -> int:
    """Weights and biases of an MLP of widths ``dims``."""
    return sum(i * o + o for i, o in _pairs(dims))


def denoiser_dims(S: int, A: int, hidden: int, layers: int) -> tuple:
    """The D3PG denoiser: [x, state, time embedding] -> hidden^layers -> A."""
    return (A + S + TIME_DIM,) + (hidden,) * layers + (A,)


def record_width(dims: Sequence[int]) -> int:
    """Floats a chain keeps per row and step for its backward: x and every
    hidden layer's output."""
    return dims[-1] + sum(dims[1:-1])


def chain_fwd(dims: Sequence[int], S: int, R: int, L: int,
              record: bool = False) -> Work:
    """One reverse chain of L steps over R rows for one learner: per row
    the state's share of layer 0 once; per step layer 0 over the x and
    time-embedding inputs, the other layers, the biases and the 5-flop
    update.  Bytes: the weights, x_L, state, noises and the two tables
    read once; x_0 (and with ``record`` the record) written once."""
    A, T = dims[-1], dims[0] - dims[-1] - S
    ins = [A + T] + list(dims[1:-1])
    step = sum(2 * i * o + o for i, o in zip(ins, dims[1:])) + 5 * A
    flops = R * (2 * S * dims[1] + L * step)
    weights = n_params(dims)
    nbytes = 4 * (weights + 2 * R * A + R * S + L * R * A + L * (3 + T)
                  + (L * R * record_width(dims) if record else 0))
    return Work(flops, nbytes)


def chain_bwd(dims: Sequence[int], S: int, R: int, L: int) -> Work:
    """The chain's gradient in the weights from its record, one learner:
    per row and step -c2 g, every layer's dW (2 in out) and db (out), the
    transposed products of the layers above the first (2 in out); at every
    step but the last the first layer's product into x (2 A dims[1]) and
    g's update (2 A).  Bytes: the weights, the record, state, g and the
    tables read once, every dW and db written once."""
    A, T = dims[-1], dims[0] - dims[-1] - S
    pairs = _pairs(dims)
    step = A + sum(2 * i * o + o for i, o in pairs) \
        + sum(2 * i * o for i, o in pairs[1:])
    flops = R * (L * step + (L - 1) * (2 * A * dims[1] + 2 * A))
    nbytes = 4 * (sum(i * o for i, o in pairs)
                  + L * R * record_width(dims) + R * S + R * A
                  + L * (3 + T) + n_params(dims))
    return Work(flops, nbytes)


def mlp_fwd(dims: Sequence[int], R: int) -> Work:
    """An MLP over R rows: weights and input read, output written."""
    flops = R * sum(2 * i * o + o for i, o in _pairs(dims))
    return Work(flops, 4 * (n_params(dims) + R * dims[0] + R * dims[-1]))


def mlp_bwd(dims: Sequence[int], R: int, weights: bool = True,
            inputs: bool = False) -> Work:
    """An MLP's backward over R rows from its saved activations: the
    weight and bias gradients (``weights``) and the products back through
    each layer to its input (every layer above the first, and the first
    too with ``inputs``)."""
    pairs = _pairs(dims)
    flops = 0
    if weights:
        flops += R * sum(2 * i * o + o for i, o in pairs)
    back = pairs if inputs else pairs[1:]
    flops += R * sum(2 * i * o for i, o in back)
    acts = sum(dims)
    nbytes = 4 * (sum(i * o for i, o in pairs) + R * acts
                  + (n_params(dims) if weights else 0)
                  + (R * dims[0] if inputs else 0))
    return Work(flops, nbytes)


def adam(P: int) -> Work:
    """One Adam step of P parameters: parameter, gradient and the two
    moments read, parameter and moments written."""
    return Work(ADAM_FLOPS * P, 4 * 7 * P)


def soft_update(P: int) -> Work:
    """A target's Polyak step: target and online read, target written."""
    return Work(LERP_FLOPS * P, 4 * 3 * P)


class Nets(NamedTuple):
    """The widths a T2DRL configuration fixes."""
    S: int
    A: int
    L: int
    actor: tuple
    critic: tuple
    qnet: tuple
    batch: int          # the D3PG minibatch
    ddqn_batch: int


def nets_of(cfg: dict) -> Nets:
    """The widths of a configuration file's ``env``, ``t2drl``, ``d3pg``
    and ``ddqn`` groups."""
    env, d3, dq = cfg["env"], cfg["d3pg"], cfg["ddqn"]
    U, M = env["U"], env["M"]
    S, A, J = 4 * U + M, 2 * U, len(env["gammas"])
    return Nets(S=S, A=A, L=cfg["t2drl"]["L"],
                actor=denoiser_dims(S, A, d3["actor_hidden"],
                                    d3["actor_layers"]),
                critic=(S + A,) + (d3["critic_hidden"],) * d3["critic_layers"]
                + (1,),
                qnet=(J,) + (dq["hidden"],) * dq["n_hidden"] + (2 ** M,),
                batch=d3["batch"], ddqn_batch=dq["batch"])


def act(n: Nets) -> Work:
    """One learner's action for one slot: its chain over one row."""
    return chain_fwd(n.actor, n.S, 1, n.L)


def d3pg_update(n: Nets) -> Work:
    """One learner's D3PG update on a minibatch of ``n.batch`` rows: the
    target chain, the target critic, the critic's forward, backward and
    Adam step, the policy chain with its record, the critic back to the
    action, the chain's backward, the actor's Adam step and both soft
    updates."""
    R = n.batch
    Pa, Pc = n_params(n.actor), n_params(n.critic)
    return (chain_fwd(n.actor, n.S, R, n.L)
            + mlp_fwd(n.critic, R) * 2 + mlp_bwd(n.critic, R)
            + adam(Pc)
            + chain_fwd(n.actor, n.S, R, n.L, record=True)
            + mlp_fwd(n.critic, R)
            + mlp_bwd(n.critic, R, weights=False, inputs=True)
            + chain_bwd(n.actor, n.S, R, n.L)
            + adam(Pa) + soft_update(Pa) + soft_update(Pc))


def ddqn_update(n: Nets) -> Work:
    """One learner's DDQN update on ``n.ddqn_batch`` frame transitions: the
    online net on s and s1, the target net on s1, the backward, Adam and
    the soft update."""
    R, P = n.ddqn_batch, n_params(n.qnet)
    return (mlp_fwd(n.qnet, R) * 3 + mlp_bwd(n.qnet, R) + adam(P)
            + soft_update(P))


def slot_decision(n: Nets, C: int) -> Work:
    """One slot's decision for C cells: one chain over C rows."""
    return chain_fwd(n.actor, n.S, C, n.L)


def frame_decision(n: Nets, C: int) -> Work:
    """One frame's caching decision for C cells: the Q-net over C rows."""
    return mlp_fwd(n.qnet, C)
