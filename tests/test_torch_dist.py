"""The port's multi-device path on torch.distributed, on the CPU: one
world of two gloo ranks (``spawn_ranks``), whose ranks import torch and
the port only (``tests/_dist_ranks.py``) and run every check in one
battery; the parent holds their results against single-process runs and
the JAX reference.

* ``run_training_sharded`` over a ``("cells",)`` mesh of 2 against
  ``run_training`` on the same ``cell_generators``, every state leaf and
  history entry exactly equal: B = 4 with ``train=True`` and ``False``,
  with masks, with a population schedule, and B = 2 with one population
  member a rank; and its refusals (the shared policy,
  ``independent_impl="vmap"``, ``mods``, no process group, B = 3 on 2
  ranks).
* The expert-parallel ``moe_apply`` on a ``("model",)`` mesh of 2 at
  ``n_shared`` 0 and 2, f32 and bf16, with capacity overflow, each rank
  holding its E/2 experts as plain tensors (a whole tree is refused),
  against the port's unsharded path and the reference's shard body
  ``_local_dispatch_combine`` under ``jax.vmap(axis_name="model")`` (2e-5
  in f32, 2e-2 in bf16); and on a (2 data x 1 model) mesh, each rank
  routing its half of the batch.
* deepseek-v3's smoke config with ``PerfOpts(moe_shardmap=True)`` (and
  with the global dispatch) on the ``("model",)`` mesh, its parameters
  DTensors by ``lm_spec`` (each rank's expert leaves hold E/2 experts):
  the forward, the loss, every gradient and two train steps against the
  default options without a mesh.
* The LM's mesh half on ``("data", "model")`` meshes (1, 2) and (2, 1),
  parameters and caches DTensors by their specs: qwen2's forward, loss,
  every gradient (against the port unsharded and the reference's
  ``jax.value_and_grad``) and two train steps with ``PerfOpts(fsdp=True)``
  (against the port unsharded); mamba2's prefill and decode, a GQA config
  of 4 query heads and 1 KV head (the query heads split, the KV head
  whole on each rank) and a decode from a cache moved to
  ``seq_shard="model"`` (these two on (1, 2)), and deepseek-v3's (MLA,
  and the MoE's global dispatch under a mesh), each against the port
  unsharded and the reference's ``lm_prefill``/``lm_decode``: 2e-5 in
  f32.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _dist_ranks as ranks
from repro.configs import get_arch as jget_arch
from repro.models import lm as jlm
from repro.nn import mlp as jmlp
from repro.nn import moe as jmoe
from repro_torch.bridge import train_state_to_numpy
from repro_torch.configs import get_arch
from repro_torch.device import make_generator
from repro_torch.models import lm as lm_mod
from repro_torch.core.env import EnvCfg, make_user_masks
from repro_torch.core.t2drl import (T2DRLCfg, cell_generators, run_training,
                                    run_training_sharded, t2drl_init_batch)
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.nn import moe

N = 2                                    # ranks of the world
F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
TRAIN_CFG = T2DRLCfg(env=EnvCfg(U=3, M=4, T=3, K=3), L=2, warmup=3,
                     lr_actor=1e-3, lr_critic=1e-3, lr_ddqn=1e-3)
EPISODES = 2


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _train_cases() -> dict:
    lr = np.linspace(5e-4, 2e-3, 4 * EPISODES, dtype=np.float32)
    base = dict(cfg=TRAIN_CFG, B=4, episodes=EPISODES)
    return {
        "base": base,
        "eval": {**base, "train": False},
        "masks": {**base, "masks": make_user_masks(
            TRAIN_CFG.env, [3, 2, 3, 1]).numpy()},
        "pop": {**base, "pop": {"eps": [0.1, 0.3, 0.5, 0.7],
                                "lr_actor": lr.reshape(EPISODES, 4)
                                .tolist()}},
        "member": {**base, "B": 2, "pop": {"sigma": [0.05, 0.2],
                                           "lr_critic": [1e-3, 3e-3]}},
    }


MOE_KW = dict(d_model=32, d_ff=24, n_experts=4, top_k=2,
              capacity_factor=0.5)
MOE_CASES = [(0, "f32"), (2, "f32"), (0, "bf16"), (2, "bf16")]


def _moe_case(n_shared: int, dtype: str, x_shape, seed: int) -> dict:
    """A MoE case from the reference's ``moe_init``, parameters and
    inputs as f32 numpy (bf16 values where the dtype is bf16)."""
    kw = dict(MOE_KW, n_shared=n_shared)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jmoe.MoECfg(**kw),
                       dtype=jdt)
    x = np.random.default_rng(seed).standard_normal(x_shape).astype(
        np.float32)
    x = np.asarray(jnp.asarray(x, jdt).astype(jnp.float32))
    return {"cfg": kw, "dtype": dtype, "x": x,
            "params": jax.tree.map(
                lambda a: np.asarray(a.astype(jnp.float32)), jp)}


def _jax_params(case):
    jdt = jnp.bfloat16 if case["dtype"] == "bf16" else jnp.float32
    p = jax.tree.map(lambda a: jnp.asarray(a, jdt), case["params"])
    p["router"]["w"] = jnp.asarray(case["params"]["router"]["w"])
    return p, jdt


def _jax_expert_parallel(case, n_data: int, n_model: int):
    """The reference's shard body, ``_local_dispatch_combine``, mapped over
    ``n_model`` expert slices (``axis_name="model"``) and ``n_data`` row
    shards (``"data"``), plus the shared experts on the whole batch."""
    jp, jdt = _jax_params(case)
    cfg = jmoe.MoECfg(**case["cfg"])
    E = cfg.n_experts
    split = [jp[k].reshape((n_model, E // n_model) + jp[k].shape[1:])
             for k in ("up", "gate", "down")]
    body = functools.partial(jmoe._local_dispatch_combine, cfg=cfg,
                             compute_dtype=jdt, model_axis="model",
                             all_axes=("data", "model"))
    inner = jax.vmap(body, in_axes=(None, 0, 0, 0, None), axis_name="model")
    outer = jax.vmap(inner, in_axes=(None, None, None, None, 0),
                     axis_name="data")
    x = jnp.asarray(case["x"], jdt)
    B = x.shape[0]
    y, aux = outer(jp["router"]["w"], *split,
                   x.reshape((n_data, B // n_data) + x.shape[1:]))
    y = y[:, 0].reshape(x.shape)
    if "shared" in jp:
        y = y + jmlp.mlp_apply(
            jp["shared"], jmlp.MLPCfg(cfg.d_model, cfg.d_ff * cfg.n_shared),
            x, compute_dtype=jdt)
    return np.asarray(y.astype(jnp.float32)), float(aux[0, 0])


def _unsharded(case, x=None):
    """The port's global path on the same inputs."""
    cfg = moe.MoECfg(**case["cfg"])
    dt = ranks.DTYPES[case["dtype"]]
    x = case["x"] if x is None else x
    y, aux = moe.moe_apply(ranks.moe_params(case["params"], dt), cfg,
                           torch.tensor(x).to(dt), compute_dtype=dt)
    return y.float().numpy(), float(aux)


def _lm_params(case) -> dict:
    """The case's parameters as a numpy tree of the JAX layout (the
    port's init, whose tree is the reference's leaf for leaf)."""
    cfg = ranks.case_cfg(case)
    return lm_mod.tree_map(lambda t: t.numpy(), lm_mod.lm_init(
        make_generator(case["seed"], "cpu"), cfg))


@functools.lru_cache(maxsize=None)
def _lm_mesh_cases() -> dict:
    """The LM mesh cases: smoke widths, B = 2, prompts of 16, a cache of
    32 and 2 decode steps (made once, read only)."""
    rng = np.random.default_rng(40)
    B, L = 2, 16

    def serve(arch, seed, heads=None):
        c = {"arch": arch, "heads": heads, "seed": seed, "S": 32,
             "tokens": rng.integers(0, 512, (B, L)),
             "decode": rng.integers(0, 512, (B, 2))}
        return {**c, "params": _lm_params(c)}
    train = {"arch": "qwen2-0.5b", "seed": 1, "batch": {
        "tokens": rng.integers(0, 512, (B, L)),
        "labels": rng.integers(0, 512, (B, L))}}
    return {"train": {**train, "params": _lm_params(train)},
            "ssm": serve("mamba2-130m", 2), "gqa": serve("qwen2-0.5b", 3,
                                                         (4, 1)),
            "seq": serve("qwen2-0.5b", 4), "mla": serve("deepseek-v3-671b",
                                                        5)}


@pytest.fixture(scope="module")
def world():
    """The spec every rank runs and the two ranks' results."""
    spec = {"lm_mesh": _lm_mesh_cases(), "train": _train_cases(),
            "moe": {f"s{s}_{d}": _moe_case(s, d, (2, 6, 32), 10 + i)
                    for i, (s, d) in enumerate(MOE_CASES)},
            "moe_data": _moe_case(2, "f32", (4, 6, 32), 20),
            "lm": {"arch": "deepseek-v3-671b", "batch": {
                "tokens": np.random.default_rng(30).integers(
                    0, 512, (2, 16)),
                "labels": np.random.default_rng(31).integers(
                    0, 512, (2, 16))}}}
    return spec, spawn_ranks(ranks.battery, N, args=(spec,), timeout_s=240)


# -- run_training_sharded ---------------------------------------------------------

def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                        f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        if hasattr(tree, "_fields"):
            return [x for k, v in zip(tree._fields, tree)
                    for x in _leaves(v, f"{path}/{k}")]
        return [x for i, v in enumerate(tree)
                for x in _leaves(v, f"{path}/{i}")]
    return [(path, np.asarray(tree))]


@pytest.mark.parametrize("name", sorted(_train_cases()))
def test_sharded_training_equals_run_training(world, name):
    spec, results = world
    case = spec["train"][name]
    want_ts, want_hist = ranks.train_case(case, run_training)
    want = _leaves(want_ts)
    for r in range(N):
        got_ts, got_hist = results[r]["train"][name]
        got = _leaves(got_ts)
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, g), (_, w) in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape, path
            np.testing.assert_array_equal(g, w, err_msg=f"rank {r} {path}")
        assert got_hist == want_hist, f"rank {r}: history"
        assert all(len(v) == EPISODES and len(v[0]) == case["B"]
                   for v in got_hist.values())
    if case.get("train", True):            # the learners did update
        gens = cell_generators(case["cfg"].seed, case["B"], "cpu")
        init = _leaves(train_state_to_numpy(t2drl_init_batch(gens,
                                                             case["cfg"])))
        moved = [p for (p, a), (_, b) in zip(init, want)
                 if "actor/" in p and not np.array_equal(a, b)]
        assert moved


def test_sharded_training_refuses_what_the_reference_refuses(world):
    _, results = world
    for r in range(N):
        assert "divisible" in results[r]["odd_B"]
    gens = cell_generators(TRAIN_CFG.seed, 2, "cpu")
    ts = t2drl_init_batch(gens, TRAIN_CFG)
    for cfg, kw, match in (
            (T2DRLCfg(env=TRAIN_CFG.env, policy="shared"), {}, "fused"),
            (T2DRLCfg(env=TRAIN_CFG.env, independent_impl="vmap"), {},
             "fused"),
            (TRAIN_CFG, {"mods": object()}, "mods")):
        with pytest.raises(ValueError, match=match):
            run_training_sharded(ts, cfg, gens, 1, **kw)
    with pytest.raises(RuntimeError, match="process group"):
        run_training_sharded(ts, TRAIN_CFG, gens, 1)


# -- the expert-parallel MoE --------------------------------------------------------

@pytest.mark.parametrize("name", [f"s{s}_{d}" for s, d in MOE_CASES])
def test_expert_parallel_moe_matches_unsharded_and_the_shard_body(world,
                                                                  name):
    spec, results = world
    case = spec["moe"][name]
    tol = BF16 if case["dtype"] == "bf16" else F32
    kw = case["cfg"]
    T = case["x"].shape[0] * case["x"].shape[1]
    cap = max(int(np.ceil(T * kw["top_k"] * kw["capacity_factor"]
                          / kw["n_experts"])), kw["top_k"])
    assert T * kw["top_k"] > kw["n_experts"] * cap    # overflow drops some
    want_y, want_aux = _unsharded(case)
    ref_y, ref_aux = _jax_expert_parallel(case, 1, N)
    for r in range(N):
        y, aux = results[r]["moe"][name]
        np.testing.assert_allclose(y, want_y, **tol)
        np.testing.assert_allclose(y, ref_y, **tol)
        np.testing.assert_allclose(aux, want_aux, **F32)
        np.testing.assert_allclose(aux, ref_aux, **F32)


def test_expert_parallel_moe_refuses_a_whole_plain_expert_tree(world):
    # plain tensors must be the rank's slice: a whole replicated tree would
    # train only this rank's experts and the copies drift apart
    spec, results = world
    kw = next(iter(spec["moe"].values()))["cfg"]
    for r in range(N):
        msg = results[r]["moe_whole"]
        assert msg is not None and f"hold {kw['n_experts']} experts" in msg
        assert f"slice is {kw['n_experts'] // N} of" in msg


def test_expert_parallel_moe_shards_tokens_over_data(world):
    spec, results = world
    case = spec["moe_data"]
    rows = case["x"].shape[0] // N
    halves = [_unsharded(case, case["x"][r * rows:(r + 1) * rows])
              for r in range(N)]
    ref_y, ref_aux = _jax_expert_parallel(case, N, 1)
    y = np.concatenate([results[r]["moe_data"][0] for r in range(N)])
    np.testing.assert_allclose(y, np.concatenate([h[0] for h in halves]),
                               **F32)
    np.testing.assert_allclose(y, ref_y, **F32)
    for r in range(N):                     # the aux loss: the mesh's mean
        aux = results[r]["moe_data"][1]
        np.testing.assert_allclose(aux, np.mean([h[1] for h in halves]),
                                   **F32)
        np.testing.assert_allclose(aux, ref_aux, **F32)


def test_moe_shardmap_trains_and_serves_deepseek_v3_as_unsharded(world):
    _deepseek_v3_as_unsharded(world, "lm")


def test_global_dispatch_on_a_mesh_trains_deepseek_v3_as_unsharded(world):
    _deepseek_v3_as_unsharded(world, "lm_gspmd")


def _deepseek_v3_as_unsharded(world, dispatch: str):
    spec, results = world
    want = ranks.lm_case(spec["lm"], shardmap=False)
    E = get_arch("deepseek-v3-671b").make_smoke().groups[-1].cycle[-1] \
        .moe.n_experts
    for r in range(N):
        got = results[r][dispatch]
        # each rank holds E/2 experts of every expert leaf
        assert got["expert_rows"] and set(got["expert_rows"]) == {E // N}
        assert set(want["expert_rows"]) == {E}
        np.testing.assert_allclose(got["logits"], want["logits"], **F32)
        np.testing.assert_allclose(got["aux"], want["aux"], **F32)
        np.testing.assert_allclose(got["loss"], want["loss"], **F32)
        assert len(got["grads"]) == len(want["grads"])
        for i, (g, w) in enumerate(zip(got["grads"], want["grads"])):
            scale = max(float(np.abs(w).max()), 1e-6)
            np.testing.assert_allclose(g / scale, w / scale, **F32,
                                       err_msg=f"gradient leaf {i}")
        for gm, wm in zip(got["metrics"], want["metrics"]):
            assert set(gm) == set(wm)
            for k in wm:
                np.testing.assert_allclose(gm[k], wm[k], **F32, err_msg=k)
        # after two Adam steps: an element whose gradient sits near Adam's
        # eps may step otherwise (the step is ~lr whatever the gradient's
        # size), so the parameters are held as a whole, in relative L2
        diff = np.sqrt(sum(np.sum((g - w) ** 2) for g, w in
                           zip(got["params"], want["params"])))
        norm = np.sqrt(sum(np.sum(w ** 2) for w in want["params"]))
        assert diff <= 2e-5 * norm, (diff, norm)


# -- the LM's mesh half ----------------------------------------------------------------

def _close(got, want, what, tol=F32):
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got / scale, want / scale, **tol,
                               err_msg=what)


@functools.lru_cache(maxsize=None)
def _jax_lm(name: str):
    """The reference's unsharded results of LM mesh case ``name``: the
    train case's logits, loss and gradient leaves; a serve case's
    prefill and decode logits."""
    case = _lm_mesh_cases()[name]
    cfg = ranks.case_cfg(case, jget_arch)
    p = jax.tree.map(jnp.asarray, case["params"])
    f32 = jnp.float32
    if name == "train":
        batch = {k: jnp.asarray(v, jnp.int32)
                 for k, v in case["batch"].items()}
        logits, _ = jlm.lm_forward(p, cfg, batch["tokens"],
                                   compute_dtype=f32)
        (loss, _), grads = jax.value_and_grad(
            lambda q: jlm.lm_loss(q, cfg, batch, compute_dtype=f32),
            has_aux=True)(p)
        return {"logits": np.asarray(logits), "loss": float(loss),
                "grads": [np.asarray(g) for g in jax.tree.leaves(grads)]}
    tok = jnp.asarray(case["tokens"], jnp.int32)
    B, L = tok.shape
    cache = jlm.lm_init_cache(cfg, B, case["S"], dtype=f32)
    logits, cache = jlm.lm_prefill(p, cfg, tok, cache, compute_dtype=f32)
    out = [np.asarray(logits)]
    for i in range(case["decode"].shape[1]):
        lg, cache = jlm.lm_decode(
            p, cfg, jnp.asarray(case["decode"][:, i:i + 1], jnp.int32),
            cache, jnp.int32(L + i), compute_dtype=f32)
        out.append(np.asarray(lg))
    return {"logits": out}


@functools.lru_cache(maxsize=None)
def _port_lm(name: str):
    """The port's unsharded run of LM mesh case ``name``."""
    case = _lm_mesh_cases()[name]
    if name == "train":
        return ranks.train_lm_case(case)
    return ranks.serve_lm_case(case)


@pytest.mark.parametrize("mesh", [m for m, _ in ranks.LM_MESHES])
def test_lm_mesh_train_matches_unsharded_and_the_reference(world, mesh):
    _, results = world
    want, ref = _port_lm("train"), _jax_lm("train")
    assert want["fsdp_leaves"] == 0          # no mesh, no DTensor
    for r in range(N):
        got = results[r]["lm_mesh"][mesh]["train"]
        _close(got["logits"], want["logits"], "logits")
        _close(got["logits"], ref["logits"], "logits vs the reference")
        np.testing.assert_allclose(got["loss"], want["loss"], **F32)
        np.testing.assert_allclose(got["loss"], ref["loss"], **F32)
        assert len(got["grads"]) == len(want["grads"]) == len(ref["grads"])
        for i, (g, w, j) in enumerate(zip(got["grads"], want["grads"],
                                          ref["grads"])):
            _close(g, w, f"gradient leaf {i}")
            _close(g, j, f"gradient leaf {i} vs the reference")
        # PerfOpts(fsdp=True): most leaves sharded over "data"
        assert got["fsdp_leaves"] >= len(got["params"]) // 2
        for gm, wm in zip(got["metrics"], want["metrics"]):
            assert set(gm) == set(wm)
            for k in wm:
                np.testing.assert_allclose(gm[k], wm[k], **F32, err_msg=k)
        diff = np.sqrt(sum(np.sum((g - w) ** 2) for g, w in
                           zip(got["params"], want["params"])))
        norm = np.sqrt(sum(np.sum(w ** 2) for w in want["params"]))
        assert diff <= 2e-5 * norm, (diff, norm)


@pytest.mark.parametrize("mesh,case", [(m, c) for m, cs in
                                       ranks.LM_SERVE.items() for c in cs])
def test_lm_mesh_serving_matches_unsharded_and_the_reference(world, mesh,
                                                             case):
    _, results = world
    want, ref = _port_lm(case), _jax_lm(case)
    for r in range(N):
        got = results[r]["lm_mesh"][mesh][case]
        assert len(got["logits"]) == len(want["logits"]) == 3
        for i, (g, w, j) in enumerate(zip(got["logits"], want["logits"],
                                          ref["logits"])):
            _close(g, w, f"step {i}")
            _close(g, j, f"step {i} vs the reference")
        for i, (g, w) in enumerate(zip(got["cache"], want["cache"])):
            _close(g, w, f"cache leaf {i}")
        pl = got["cache_placements"]
        if case == "seq" and mesh == "tp":   # the sequence over "model"
            assert all("Shard(dim=2)" in p for p in pl), pl
        if case == "gqa" and mesh == "tp":   # one KV head: whole a rank
            assert all("Replicate()" in p for p in pl), pl
