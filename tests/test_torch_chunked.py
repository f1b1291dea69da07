"""The port's ``chunked_attention`` (an online-softmax forward and a
recomputing backward in a ``torch.autograd.Function``) against the JAX
package's ``chunked_attention`` and its ``custom_vjp``, and against the
port's own plain score-matrix path, on the CPU in f32.

Cases: causal, windowed, non-causal, GQA with 1 to 4 query heads a KV
head, L a multiple of the block (several q- and k-blocks), and a batch of
2.  Outputs and the q/k/v gradients (for one random output cotangent)
agree to 2e-5 of each leaf's largest magnitude.  The Function saves q, k,
v, the output and the log-sum-exp and nothing else.  Inputs come from a
seeded numpy generator; both sides see the same arrays.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import attention as jattn
from repro_torch.nn import attention

TOL = 2e-5          # of each leaf's largest magnitude, f32

# (B, L, H, Hkv, D, causal, window, block)
CASES = [
    (2, 32, 4, 4, 16, True, None, 32),     # causal, one block, G = 1
    (1, 64, 4, 2, 16, True, None, 16),     # GQA 2, four q- and k-blocks
    (1, 48, 6, 2, 8, True, 12, 16),        # GQA 3, window across blocks
    (2, 32, 4, 1, 16, True, 5, 8),         # GQA 4 (MQA), small window
    (1, 40, 4, 2, 16, False, None, 8),     # non-causal, five blocks
    (1, 24, 3, 3, 8, False, 6, 8),         # non-causal window
]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, L, H, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, L, H, D)).astype(np.float32)
    k = rng.standard_normal((B, L, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, L, Hkv, D)).astype(np.float32)
    do = rng.standard_normal((B, L, H, D)).astype(np.float32)
    return q, k, v, do


def _close_to_max(got, want, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    assert err <= TOL * max(np.abs(want).max(), 1e-30), (what, err)


def _port(fn, q, k, v, do):
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts, torch.tensor(do))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _plain(q, k, v, causal, window, scale):
    """The port's plain path: the masked score matrix's softmax."""
    L = q.shape[1]
    scores = attention._gqa_scores(q, k, scale)
    mask = attention.causal_window_mask(L, L, causal=causal, window=window)
    return attention._gqa_out(attention._masked_softmax(scores, mask), v)


@pytest.mark.parametrize("case", CASES)
def test_chunked_attention_matches_jax_custom_vjp_and_the_plain_path(case):
    B, L, H, Hkv, D, causal, window, blk = case
    q, k, v, do = _inputs(B, L, H, Hkv, D, seed=L + H)
    scale = 1.0 / math.sqrt(D)
    kw = dict(causal=causal, window=window, scale=scale, bq=blk, bk=blk)

    def jfn(q, k, v):
        return jattn.chunked_attention(q, k, v, **kw)
    jout, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(do))

    out, grads = _port(lambda *t: attention.chunked_attention(*t, **kw),
                       q, k, v, do)
    pout, pgrads = _port(lambda *t: _plain(*t, causal, window, scale),
                         q, k, v, do)
    _close_to_max(out, jout, "out vs JAX")
    _close_to_max(out, pout, "out vs plain")
    for name, g, jg, pg in zip("qkv", grads, jgrads, pgrads):
        _close_to_max(g, jg, f"d{name} vs JAX custom_vjp")
        _close_to_max(g, pg, f"d{name} vs plain autograd")


def test_the_function_saves_only_q_k_v_out_and_lse():
    """Autograd packs exactly five tensors for the backward: q, k, v (the
    very inputs), the output and the (B, Hkv, G, L) f32 log-sum-exp; the
    block loops leave nothing of their carries in the graph."""
    B, L, H, Hkv, D = 1, 64, 4, 2, 16
    q, k, v, _ = _inputs(B, L, H, Hkv, D, seed=3)
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    packed = []

    def pack(t):
        packed.append(t)
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = attention.chunked_attention(*ts, causal=True, window=None,
                                          scale=0.25, bq=16, bk=16)
    assert len(packed) == 5
    assert all(a is b for a, b in zip(packed[:3], ts))
    assert torch.equal(packed[3], out)
    assert packed[4].shape == (B, Hkv, H // Hkv, L)
    assert packed[4].dtype == torch.float32
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 5


def test_attn_forward_chunked_matches_plain_and_refuses_a_ragged_length():
    """``attn_forward(impl="chunked")`` on a GQA layer with bias and a
    window gives the plain path's output and gradients (f32, 2e-5 of the
    leaf's max); a length that is no multiple of the block raises."""
    cfg = attention.AttnCfg(32, 4, 2, 8, qkv_bias=True, window=6)
    p = attention.attn_init(torch.Generator().manual_seed(0), cfg)
    x = torch.tensor(np.random.default_rng(1).standard_normal(
        (2, 16, 32)).astype(np.float32))
    res = {}
    for impl in ("plain", "chunked"):
        leaves = [t.clone().requires_grad_(True) for t in
                  (p["q"]["w"], p["k"]["w"], p["v"]["b"])]
        pi = {**p, "q": {**p["q"], "w": leaves[0]},
              "k": {**p["k"], "w": leaves[1]},
              "v": {**p["v"], "b": leaves[2]}}
        y = attention.attn_forward(pi, cfg, x, impl=impl,
                                   compute_dtype=torch.float32)
        res[impl] = (y.detach(), torch.autograd.grad(y.square().sum(),
                                                     leaves))
    _close_to_max(res["chunked"][0], res["plain"][0], "y")
    for g, pg in zip(res["chunked"][1], res["plain"][1]):
        _close_to_max(g, pg, "grad")
    q = torch.zeros(1, 1030, 2, 8)
    with pytest.raises(ValueError, match="multiples"):
        attention.chunked_attention(q, q, q, causal=True, window=None,
                                    scale=1.0)
