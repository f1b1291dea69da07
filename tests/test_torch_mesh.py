"""The LM's mesh half (PartitionSpecs as DTensor placements) against the
JAX reference, on the CPU.

* Every parameter and cache spec tree of the ten architectures (full
  configs; caches with ``seq_shard`` None and ``"model"``) equals the
  reference's, leaf for leaf, with no mesh and under duck meshes of
  16×16 and 2×16×16 (the batch axes come from the current mesh).
* ``fit_spec``, ``fsdp_spec`` and ``batch_spec_for`` equal the
  reference's on those duck meshes (the reference's ``_M16`` pattern),
  for every parameter leaf of every architecture, the leaves' shapes
  equal the reference's ``eval_shape``; and the placements of every
  fitted leaf, with and without FSDP, equal those of the reference's
  fitted specs.
* ``input_specs`` gives meta tensors (no storage) of the reference's
  shapes and dtypes for the four pairs of ``tests/test_launch.py``, and
  ``supports`` still counts 39 of 40.
* ``collective_bytes`` sums the reference parser's sizes, and the step
  counter records the functional collectives DTensor issues by their
  output bytes, on a fake process group.  Without a mesh, ``step_cost``
  counts a smoke train step of every architecture as ``FlopCounterMode``
  and the plain byte count do.
* The dry run in-process on fake process groups: olmo-1b decode_32k on
  256 ranks (the reference's single pair) through ``main``, and one MoE
  training pair with ``--fsdp --moe-shardmap`` (depth cut to one repeat
  a group for time).
"""
import dataclasses
import json
import os

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_arch as jget_arch
from repro.configs import input_specs as jinput_specs
from repro.configs import supports as jsupports
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.models import whisper as jwhisper
from repro.nn import sharding as jsh
from repro_torch.configs import ARCH_IDS, SHAPES, get_arch, input_specs, \
    supports
from repro_torch.launch import dryrun, roofline, steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import lm, whisper
from repro_torch.nn import sharding as sh
from repro_torch.nn.sharding import P

import _dist_ranks as ranks


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _M16:
    shape = {"data": 16, "model": 16}
    axis_names = ("data", "model")


class _M2x16x16:
    shape = {"pod": 2, "data": 16, "model": 16}
    axis_names = ("pod", "data", "model")


MESHES = {"none": None, "16x16": _M16(), "2x16x16": _M2x16x16()}


def _port(tree):
    """The reference's spec tree with its leaves as the port's ``P``."""
    return jax.tree.map(lambda s: P(*s), tree,
                        is_leaf=lambda s: isinstance(s, JP))


def _specs(arch_id, mesh):
    """(port's, reference's) parameter spec and cache spec trees (both
    ``seq_shard`` settings) of the full config, with ``mesh`` current in
    both packages."""
    arch, jarch = get_arch(arch_id), jget_arch(arch_id)
    cfg, jcfg = arch.make_full(), jarch.make_full()
    whisp = arch.kind == "whisper"
    mod, jmod = (whisper, jwhisper) if whisp else (lm, jlm)
    pfx = "whisper" if whisp else "lm"
    with sh.use_mesh(mesh), jsh.use_mesh(mesh):
        got = [getattr(mod, f"{pfx}_spec")(cfg)] + [
            getattr(mod, f"{pfx}_cache_spec")(cfg, seq_shard=s)
            for s in (None, "model")]
        want = [getattr(jmod, f"{pfx}_spec")(jcfg)] + [
            getattr(jmod, f"{pfx}_cache_spec")(jcfg, seq_shard=s)
            for s in (None, "model")]
    return got, [_port(w) for w in want]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_spec_trees_equal_the_reference(arch_id, mesh):
    got, want = _specs(arch_id, MESHES[mesh])
    for what, g, w in zip(("params", "cache", "cache seq_shard"), got,
                          want):
        assert g == w, what
        leaves = lm.tree_leaves(g)
        assert leaves and all(isinstance(s, P) for s in leaves), what


_SHAPES = {}


def _leaf_shapes(arch_id):
    """(port's meta leaves, the reference's eval_shape leaves, port spec
    leaves, reference spec leaves, the port's meta tree and spec tree) of
    the full config."""
    if arch_id not in _SHAPES:
        arch, jarch = get_arch(arch_id), jget_arch(arch_id)
        cfg, jcfg = arch.make_full(), jarch.make_full()
        if arch.kind == "whisper":
            jp = jax.eval_shape(lambda: jwhisper.whisper_init(
                jax.random.PRNGKey(0), jcfg))
            jspec = jwhisper.whisper_spec(jcfg)
        else:
            jp = jax.eval_shape(lambda: jlm.lm_init(jax.random.PRNGKey(0),
                                                     jcfg))
            jspec = jlm.lm_spec(jcfg)
        shapes, spec = steps.params_and_specs(arch, cfg)
        _SHAPES[arch_id] = (
            lm.tree_leaves(shapes), jax.tree.leaves(jp),
            lm.tree_leaves(spec),
            jax.tree.leaves(jspec, is_leaf=lambda s: isinstance(s, JP)),
            shapes, spec)
    return _SHAPES[arch_id]


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_fitted_specs_and_placements_equal_the_reference(arch_id, mesh):
    m = MESHES[mesh]
    shapes, jshapes, specs, jspecs, tree, spec = _leaf_shapes(arch_id)
    assert [tuple(t.shape) for t in shapes] == [tuple(s.shape)
                                                for s in jshapes]
    assert all(t.is_meta for t in shapes)
    assert len(specs) == len(jspecs)
    for t, s, js in zip(shapes, specs, jspecs):
        assert s == P(*js)
        for fsdp in (False, True):
            ps = steps.fsdp_spec(s, t.shape, m) if fsdp else s
            pj = jsteps.fsdp_spec(js, t.shape, m) if fsdp else js
            assert ps == P(*pj), (t.shape, s, fsdp)
            fit = sh.fit_spec(ps, t.shape, m)
            jfit = jsh.fit_spec(pj, t.shape, m)
            assert fit == P(*jfit), (t.shape, ps)
            assert sh.placements(fit, m) == sh.placements(P(*jfit), m)
    # the port's tree functions give the same placements leaf for leaf
    fspec = steps.apply_fsdp(spec, tree, m)
    placed = lm.tree_leaves(steps.spec_to_sharding(m, fspec, tree))
    assert placed == [sh.placements(sh.fit_spec(
        P(*jsteps.fsdp_spec(js, t.shape, m)), t.shape, m), m)
        for t, js in zip(shapes, jspecs)]


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_batch_spec_for_and_fit_spec_equal_the_reference(mesh):
    m = MESHES[mesh]
    for rest in ((), (None,), (None, "model"), (None, None, None)):
        assert steps.batch_spec_for(m, *rest) == P(
            *jsteps.batch_spec_for(m, *rest))
        for shape in ((512, 8, 8, 8), (32, 8, 8, 8), (1, 1, 1, 1),
                      (256, 4096, 16, 128)):
            s = steps.batch_spec_for(m, *rest)
            assert sh.fit_spec(s, shape, m) == P(*jsh.fit_spec(
                jsteps.batch_spec_for(m, *rest), shape, m))
    # the reference's own cases (tests/test_system.py)
    assert sh.fit_spec(P("model", None), (50280, 768), _M16()) == \
        P(None, None)
    assert sh.fit_spec(P(("data", "model"), None), (32, 8), _M16()) == \
        P("data", None)
    # a tuple entry puts both mesh dims on one tensor dim, major first
    from torch.distributed.tensor import Replicate, Shard
    assert sh.placements(P(("data", "model"), None), m) == (
        (Replicate(),) * (mesh == "2x16x16") + (Shard(0), Shard(0)))
    with pytest.raises(ValueError, match="order"):
        sh.placements(P(("model", "data")), m)


@pytest.mark.parametrize("arch_id,shape", [
    ("qwen2-0.5b", "train_4k"), ("mamba2-130m", "decode_32k"),
    ("deepseek-v2-236b", "prefill_32k"), ("whisper-small", "train_4k")])
def test_input_specs_match_the_reference_and_allocate_nothing(arch_id,
                                                              shape):
    step, got = input_specs(get_arch(arch_id), shape)
    jstep, want = jinput_specs(jget_arch(arch_id), shape)
    assert step == jstep and set(got) == set(want)
    dt = {"int32": torch.int32, "bfloat16": torch.bfloat16,
          "float32": torch.float32}
    for k in want:
        g = lm.tree_leaves(got[k]) if k == "cache" else [got[k]]
        w = jax.tree.leaves(want[k])
        assert len(g) == len(w), k
        for a, b in zip(g, w):
            assert a.is_meta, k
            assert tuple(a.shape) == tuple(b.shape), k
            assert a.dtype == dt[str(b.dtype)], k
    # 39 of the 40 (arch, shape) pairs are supported, as the reference's
    n = sum(supports(get_arch(a), s)[0] for a in ARCH_IDS for s in SHAPES)
    jn = sum(jsupports(jget_arch(a), s)[0] for a in J_ARCH_IDS
             for s in J_SHAPES)
    assert n == jn == 39


def test_collective_bytes_of_the_reference_parser_sizes():
    cb = roofline.collective_bytes([
        ("all-gather", 16 * 1024 * 2), ("all-reduce", 256 * 4),
        ("reduce-scatter", 8 * 32 * 4), ("collective-permute", 4 * 4 * 2)])
    assert cb["all-gather"] == 16 * 1024 * 2
    assert cb["all-reduce"] == 256 * 4
    assert cb["reduce-scatter"] == 8 * 32 * 4
    assert cb["collective-permute"] == 4 * 4 * 2
    assert cb["total"] == (16 * 1024 * 2 + 2 * 256 * 4 + 8 * 32 * 4
                           + 4 * 4 * 2)
    assert cb["counts"] == {"all-gather": 1, "all-reduce": 1,
                            "reduce-scatter": 1, "all-to-all": 0,
                            "collective-permute": 1}


def test_step_counter_records_the_collectives_dtensor_issues():
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard
    with ranks.fake_world(16):
        mesh = init_device_mesh("cpu", (16,), mesh_dim_names=("model",))
        group = mesh.get_group("model")

        def run():
            funcol.all_gather_tensor(torch.ones(16, 64, dtype=torch.bfloat16),
                                     1, group)
            funcol.all_reduce(torch.ones(256), "sum", group)
            funcol.reduce_scatter_tensor(torch.ones(8, 512), "sum", 1, group)
            funcol.all_to_all_single(torch.ones(32, 4), None, None, group)
            # DTensor's own: a column-sharded (64, 64) f32 gathered whole
            x = sh.distribute(torch.ones(64, 64), P(None, "model"), mesh)
            x.redistribute(mesh, (Replicate(),))
            y = torch.matmul(sh.distribute(torch.ones(8, 64), P(None,
                             "model"), mesh), sh.distribute(
                torch.ones(64, 4), P("model", None), mesh))
            y.redistribute(mesh, (Replicate(),))
            assert isinstance(x.placements[0], Shard)
        _, cost = roofline.step_cost(run)
    cb = cost["collectives"]
    assert cb["counts"] == {"all-gather": 2, "all-reduce": 2,
                            "reduce-scatter": 1, "all-to-all": 1,
                            "collective-permute": 0}
    assert cb["all-gather"] == 16 * 1024 * 2 + 64 * 64 * 4
    assert cb["all-reduce"] == 256 * 4 + 8 * 4 * 4
    assert cb["reduce-scatter"] == 8 * 32 * 4
    assert cb["all-to-all"] == 32 * 4 * 4
    # the matmul's local FLOPs: this rank's (8, 4) x (4, 4) shard product
    assert cost["flops"] == 2 * 8 * 4 * 4


class _ByteCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """Every dispatched op's tensor inputs and outputs, views and
    ``_unsafe_view`` counting none: the byte count of ``step_cost``."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func is torch.ops.aten._unsafe_view.default:
            return out
        for t in torch.utils._pytree.tree_leaves((args, kwargs, out)):
            if isinstance(t, torch.Tensor):
                self.bytes += t.numel() * t.element_size()
        return out


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_step_cost_counts_a_plain_train_step_as_the_flop_counter(arch_id):
    """Without a mesh, ``step_cost``'s FLOPs are ``FlopCounterMode``'s and
    its bytes the plain byte count, on one smoke train step."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.device import make_generator
    from repro_torch.launch.train import train_setup
    _, _, _, init_fn, step, batch_fn = train_setup(
        arch_id, smoke=True, steps=4, batch=2, seq_len=32, device="cpu")
    state = list(init_fn(make_generator(0, "cpu")))
    b = batch_fn(torch.Generator().manual_seed(1))

    def one():
        state[0], state[1], _ = step(state[0], state[1], b)

    one()
    flops, byts = FlopCounterMode(display=False), _ByteCounter()
    with flops, byts:
        one()
    _, cost = roofline.step_cost(one)
    assert cost["flops"] == flops.get_total_flops() > 0
    assert cost["bytes accessed"] == byts.bytes > 0
    assert cost["collectives"]["total"] == 0


def test_production_mesh_needs_its_world():
    with pytest.raises(RuntimeError, match="process group"):
        make_production_mesh()
    with ranks.fake_world(16):
        with pytest.raises(ValueError, match="256"):
            make_production_mesh()


def test_dryrun_olmo_decode_on_256_fake_ranks(tmp_path, capsys):
    dryrun.main(["--arch", "olmo-1b", "--shape", "decode_32k", "--out",
                 str(tmp_path)])
    assert "All dry-runs lowered + compiled successfully." in \
        capsys.readouterr().out
    rec = json.loads((tmp_path / "olmo_1b_decode_32k_pod16x16.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["chips"] == 256
    cfg = get_arch("olmo-1b").make_full()
    att = cfg.groups[0].cycle[0].attn
    # exact per-rank argument bytes: f32 params split 16 ways on "model"
    # where the spec splits them; the bf16 cache by batch and KV heads
    n_layers = cfg.n_layers
    cache = 2 * n_layers * (128 // 16) * 32768 * (att.n_kv_heads // 16) \
        * att.d_head * 2
    ab = rec["arg_bytes_per_rank"]
    assert ab["caches"] == cache
    assert ab["inputs"] == (128 // 16) * 4 + 4
    assert 0 < ab["params"] < 4 * sum(
        t.numel() for t in lm.tree_leaves(steps.param_shapes(
            get_arch("olmo-1b"), cfg))) / 8
    assert rec["collective_counts"]["all-reduce"] > 0
    assert rec["cost"]["flops"] > 0
    r = rec["roofline"]
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert r["collective_s"] == rec["collectives"]["total"] / \
        roofline.NVLINK_BW
    assert rec["peak"]["bytes"] is None or rec["peak"]["bytes"] > 0
    assert sh.current_mesh() is None
    import torch.distributed as dist
    assert not dist.is_initialized()


def _one_repeat(make_cfg):
    def cut(arch, shape, **kw):
        cfg = make_cfg(arch, shape, **kw)
        return dataclasses.replace(cfg, groups=tuple(
            dataclasses.replace(g, repeats=1) for g in cfg.groups))
    return cut


def test_dryrun_moe_training_with_fsdp_and_expert_parallel(tmp_path,
                                                           monkeypatch):
    monkeypatch.setattr(steps, "make_cfg", _one_repeat(steps.make_cfg))
    monkeypatch.setattr(dryrun, "make_cfg", _one_repeat(dryrun.make_cfg))
    opts = steps.PerfOpts(fsdp=True, moe_shardmap=True)
    with ranks.fake_world(256):
        rec = dryrun.run_one("deepseek-v2-236b", "train_4k",
                             multi_pod=False, out_dir=str(tmp_path),
                             opts=opts)
    assert rec["status"] == "ok" and rec["opts"] == "fsdp-moesm"
    assert os.path.exists(tmp_path / "deepseek_v2_236b_train_4k_pod16x16_"
                          "fsdp-moesm.json")
    ab = rec["arg_bytes_per_rank"]
    # ZeRO-3: params and moments over all 256 ranks, within a few leaves
    # that do not divide (norm scales, the router)
    total = 4 * rec["n_params"]
    assert ab["params"] < 2 * total / 256
    assert ab["moments"] == 2 * ab["params"]
    counts = rec["collective_counts"]
    assert counts["all-gather"] > 0 and counts["all-reduce"] > 0
    assert rec["cost"]["flops"] > 0
