"""The reverse chain's backward on the CPU: ``ref.ddpm_chain_bwd_ref``
against autograd through ``ref.ddpm_chain_ref``, ``ops.DdpmChain``'s
gradcheck, what the chain's gradient refuses, and ``chain_bwd_plan``.
(Its parity with ``jax.grad`` of the reference's sampler and through a
whole ``d3pg_update`` is in ``test_torch_train.py``; the kernel is held
against these plain versions on the card, ``test_torch_cuda.py`` and
``chip_smoke.py``.)

Tolerances: the plain backward agrees with autograd to 1e-10 of each
leaf's largest magnitude in f64 (the same products summed in other
orders); ``gradcheck`` runs at its own f64 defaults.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.networks import MLP
from repro_torch.kernels import ops, ref

PAPER = (86, 128, 128, 128, 20)        # the D3PG actor, S = 50


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tests run many small ops, which several
    threads only slow down when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chain(dims, S, R, L, dtype=torch.float64, seed=0):
    """Weights and biases (lists), then x_L, state, noises, coef, te and
    an upstream gradient w of x_0, from numpy."""
    rng = np.random.default_rng(seed)

    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).to(dtype)
    ws = [f(i, o) / np.sqrt(i) for i, o in zip(dims[:-1], dims[1:])]
    bs = [0.1 * f(o) for o in dims[1:]]
    A, T = dims[-1], dims[0] - dims[-1] - S
    coef = torch.tensor([ops.ddpm_coefficients(0.9, 0.5, 0.04, l)
                         for l in range(L)], dtype=dtype)
    return ws, bs, f(R, A), f(R, S), f(L, R, A), coef, f(L, T), f(R, A)


@pytest.mark.parametrize("R", [1, 7, 16])
@pytest.mark.parametrize("L", [1, 5, 12])
@pytest.mark.parametrize("dims,S", [(PAPER, 50), ((53, 90, 90, 90, 30), 7),
                                    ((25, 100, 100, 5), 4)])
def test_plain_chain_backward_is_autograd_of_the_plain_chain(dims, S, L, R):
    ws, bs, x_L, state, noises, coef, te, w = _chain(dims, S, R, L)
    leaves = [t.clone().requires_grad_(True) for t in ws + bs]
    n = len(ws)
    net = ops._Weights(leaves[:n], leaves[n:])
    x0 = ref.ddpm_chain_ref(net, x_L, state, noises, coef, te)
    want = torch.autograd.grad(torch.sum(w * x0), leaves)
    x0r, record = ref.ddpm_chain_ref(ops._Weights(ws, bs), x_L, state,
                                     noises, coef, te, record=True)
    assert torch.equal(x0r, x0.detach())
    assert record.shape == (L, R, ops.chain_record_width(dims))
    assert torch.equal(record[0, :, :dims[-1]], x_L)
    dws, dbs = ref.ddpm_chain_bwd_ref(ops._Weights(ws, bs), record, state,
                                      coef, te, w)
    for got, exp in zip(dws + dbs, want):
        assert got.dtype == torch.float64 and got.shape == exp.shape
        assert (got - exp).abs().max() <= 1e-10 * exp.abs().max()


def test_ddpm_chain_function_passes_gradcheck_in_f64():
    ws, bs, x_L, state, noises, coef, te, _ = _chain((12, 6, 5, 3), 4, 3, 4)
    leaves = [t.requires_grad_(True) for t in ws + bs]
    assert torch.autograd.gradcheck(
        lambda *p: ops.DdpmChain.apply(x_L, state, noises, coef, te,
                                       None, *p), leaves)


def _mlp_chain(R=3, L=4, seed=1):
    """A small f32 chain as the sampler calls it: an MLP whose parameters
    require a gradient."""
    ws, bs, x_L, state, noises, coef, te, w = _chain(
        (14, 8, 8, 4), 6, R, L, torch.float32, seed)
    return MLP(ws, bs), x_L, state, noises, coef, te, w


def test_ddpm_chain_gradient_on_the_cpu_is_the_plain_backward():
    """Through the wrapper on CPU tensors: x_0 is the plain chain's, the
    gradient the plain backward of its record, and nothing counts as a
    launch."""
    net, x_L, state, noises, coef, te, w = _mlp_chain()
    before = dict(ops.LAUNCHES), dict(ops.GRIDS), dict(ops.CLUSTERS)
    x0 = ops.ddpm_chain(net, x_L, state, noises, coef, te)
    assert x0.requires_grad
    got = torch.autograd.grad(torch.sum(w * x0),
                              list(net.w) + list(net.b))
    with torch.no_grad():
        x0r, record = ops.ddpm_chain(net, x_L, state, noises, coef, te,
                                     record=True)
        dws, dbs = ops.ddpm_chain_bwd(net, record, state, coef, te, w)
    assert torch.equal(x0.detach(), x0r)
    assert all(torch.equal(a, b) for a, b in zip(got, dws + dbs))
    assert (ops.LAUNCHES, ops.GRIDS, ops.CLUSTERS) == before
    # without a gradient to give, the chain builds no graph
    with torch.no_grad():
        assert not ops.ddpm_chain(net, x_L, state, noises, coef,
                                  te).requires_grad


@pytest.mark.parametrize("leaf", ["x_L", "state", "noises"])
def test_ddpm_chain_refuses_a_gradient_to_its_inputs(leaf):
    net, x_L, state, noises, coef, te, _ = _mlp_chain()
    args = {"x_L": x_L, "state": state, "noises": noises}
    args[leaf].requires_grad_(True)
    with pytest.raises(ValueError, match=f"no gradient to {leaf}"):
        ops.ddpm_chain(net, args["x_L"], args["state"], args["noises"],
                       coef, te)
    # under no_grad the forward runs as ever
    with torch.no_grad():
        ops.ddpm_chain(net, args["x_L"], args["state"], args["noises"],
                       coef, te)


def test_ddpm_chain_backward_refuses_bf16():
    net, x_L, state, noises, coef, te, w = _mlp_chain()
    with torch.no_grad():
        _, record = ops.ddpm_chain(net, x_L, state, noises, coef, te,
                                   record=True)
    with pytest.raises(TypeError, match="float32"):
        ops.ddpm_chain_bwd(net, record, state, coef, te, w.bfloat16())
    with pytest.raises(TypeError, match="float32"):
        ops.ddpm_chain(net.bfloat16(), x_L, state, noises, coef, te)
    with pytest.raises(TypeError, match="float32"):
        ops.chain_bwd_plan(PAPER, 64, torch.bfloat16)


def test_chain_bwd_plan_counts_the_kernels_shared_memory():
    """At the actor's widths over a minibatch: 8 CTAs of 16 columns (3 of
    the last layer's 20), 8 rows.  Floats per CTA: 4 (two mbarriers);
    per layer the transposed slice, its dW (cs x in each) and db (cs):
    2*16*86+16 + 2*(2*16*128+16) + 2*3*128+3 = 11763; two activation rows
    buffers 2*8*(86+384) = 7520; two delta buffers 2*8*16 = 256; g 8*3 =
    24; two buffers of 8 CTAs' partials 2*8*8*16 = 2048."""
    plan = ops.chain_bwd_plan(PAPER, 64)
    assert (plan.cluster, plan.rows) == (8, 8)
    assert plan.smem_bytes == 4 * (4 + 11763 + 7520 + 256 + 24 + 2048)
    # one row: the buffers shrink with the rows, the slices do not
    one = ops.chain_bwd_plan(PAPER, 1)
    assert (one.cluster, one.rows) == (8, 1)
    assert one.smem_bytes == 4 * (4 + 11763 + 2 * 470 + 2 * 16 + 3
                                  + 2 * 8 * 16)
    # the data plane's image widths fit too (8 CTAs)
    assert ops.chain_bwd_plan((273, 128, 128, 128, 256), 8).cluster == 8
    assert ops.chain_record_width(PAPER) == 20 + 3 * 128


def test_chain_bwd_plan_raises_where_the_slices_do_not_fit():
    with pytest.raises(ValueError, match="8 CTAs"):
        ops.chain_bwd_plan((1024, 1024, 1024), 8)
    with pytest.raises(ValueError):
        ops.chain_bwd_plan(PAPER, 0)
    # the forward holds these widths, the backward (twice the slices) not
    assert ops.chain_plan((900, 256, 16), 1).cluster == 8
    with pytest.raises(ValueError, match="ddpm_chain_bwd"):
        ops.chain_bwd_plan((900, 256, 16), 1)
