"""Checkpoints of the port (``repro_torch.checkpoint``) against the JAX
package's (``repro.checkpoint``), on the CPU.  Everything here is exact:

* the port's msgpack codec writes ``msgpack.packb(..., use_bin_type=
  True)``'s bytes and reads what ``msgpack.unpackb`` reads;
* a JAX-written ``save_train_state`` file (single cell and B = 2, both
  learner modes, a classical cacher's state) loads into the port equal,
  leaf for leaf, to ``train_state_from_numpy`` of the same tree;
* a port-written file loads in the JAX package equal, leaf for leaf and
  dtype for dtype, to the tree it came from; policies (the diffusion
  actor and DDQN, an ARC resident set) cross both ways;
* a trained state survives save and load bit for bit, and a greedy
  episode from the restored policy is the live one's;
* the codec runs with no ``msgpack`` package importable.
"""
import os
import subprocess
import sys

import jax
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import load_train_state as jload
from repro.checkpoint import save_train_state as jsave
from repro.core import env as jenv
from repro.core import t2drl as jt2
from repro_torch.bridge import (policy_from_numpy, train_state_from_numpy,
                                train_state_to_numpy)
from repro_torch.checkpoint import (load_pytree, load_train_state,
                                    save_pytree, save_train_state)
from repro_torch.checkpoint import msgpack_codec
from repro_torch.core import env as tenv
from repro_torch.core import t2drl as tt2

SMALL = dict(U=3, M=4, T=2, K=2)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _paths(tree):
    return [(jax.tree_util.keystr(p), np.asarray(x)) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _assert_same_tree(a, b):
    pa, pb = _paths(a), _paths(b)
    assert [k for k, _ in pa] == [k for k, _ in pb]
    for (k, x), (_, y) in zip(pa, pb):
        assert x.dtype == y.dtype and x.shape == y.shape, (k, x.dtype,
                                                           y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=k)


def _port_leaves(ts):
    """Every tensor and host counter of a port state, in a fixed order."""
    out = []

    def walk(x, path):
        if isinstance(x, torch.nn.Module):
            for n, p in x.named_parameters():
                out.append((f"{path}.{n}", p.detach()))
        elif torch.is_tensor(x):
            out.append((path, x))
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], f"{path}/{k}")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, f"{path}[{i}]")
        else:
            out.append((path, x))
    walk(ts, "")
    return out


def _assert_same_port(a, b):
    la, lb = _port_leaves(a), _port_leaves(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and torch.equal(x, y), k
        else:
            assert x == y, k


@pytest.mark.parametrize("obj", [
    0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1,
    -2 ** 63, 0.25, -1e300, None, True, False, "", "a" * 31, "b" * 32,
    "c" * 256, "é" * 40000, b"", b"x" * 255, b"y" * 256, b"z" * 70000,
    list(range(15)), list(range(16)), list(range(70000)), ("t", (1, 2)),
    {str(i): i for i in range(15)}, {str(i): [i] for i in range(16)},
    {"k": {"__leaf__": True, "shape": [2, 3], "data": b"\x00" * 24}}])
def test_codec_bytes_equal_msgpack(obj):
    raw = msgpack.packb(obj, use_bin_type=True)
    assert msgpack_codec.packb(obj) == raw
    assert msgpack_codec.unpackb(raw) == msgpack.unpackb(
        raw, raw=False, strict_map_key=False)
    f32 = b"\xca" + np.float32(1.5).tobytes()[::-1]
    assert msgpack_codec.unpackb(f32) == 1.5
    with pytest.raises(ValueError):
        msgpack_codec.unpackb(raw + b"\xc0")


def _cfgs(policy="independent", cacher="arc"):
    kw = dict(L=2, cacher=cacher, policy=policy)
    return (jt2.T2DRLCfg(env=jenv.EnvCfg(**SMALL), **kw),
            tt2.T2DRLCfg(env=tenv.EnvCfg(**SMALL), **kw))


def _jax_state(cfg_j, B):
    key = jax.random.PRNGKey(7)
    ts = (jt2.t2drl_init(key, cfg_j) if B is None
          else jt2.t2drl_init_batch(key, cfg_j, B))
    # a non-trivial cache state and buffer counters
    ts["cache"] = jax.tree.map(lambda x: x + 1 if x.dtype != bool else ~x,
                               ts["cache"])
    ts["ebuf"]["ptr"] = ts["ebuf"]["ptr"] + 3
    ts["ebuf"]["size"] = ts["ebuf"]["size"] + 3
    ts["d3pg"]["opt_a"]["step"] = ts["d3pg"]["opt_a"]["step"] + 5
    return ts


@pytest.mark.parametrize("policy,B", [("independent", None),
                                      ("independent", 2), ("shared", 2)])
def test_jax_checkpoint_loads_into_the_port(policy, B, tmp_path):
    cfg_j, cfg_t = _cfgs(policy)
    ts = _jax_state(cfg_j, B)
    path = str(tmp_path / "jax.ckpt")
    jsave(path, ts, meta={"allocator": "d3pg", "seed": 7})
    got, meta = load_train_state(path, cfg_t, device="cpu")
    assert meta == {"allocator": "d3pg", "seed": 7}
    want = train_state_from_numpy(jax.tree.map(np.asarray, ts), cfg_t,
                                  device="cpu")
    _assert_same_port(got, want)
    assert got["d3pg"]["opt_a"]["step"] == 5
    with pytest.raises(ValueError, match="T2DRLCfg"):
        load_train_state(path, device="cpu")


@pytest.mark.parametrize("policy,B", [("independent", None),
                                      ("independent", 2), ("shared", 2)])
def test_port_checkpoint_loads_into_jax(policy, B, tmp_path):
    cfg_j, cfg_t = _cfgs(policy)
    tree = jax.tree.map(np.asarray, _jax_state(cfg_j, B))
    port = train_state_from_numpy(tree, cfg_t, device="cpu")
    _assert_same_tree(train_state_to_numpy(port, cfg_t), tree)
    path = str(tmp_path / "port.ckpt")
    save_train_state(path, port, meta={"note": "port"}, cfg=cfg_t)
    jts, meta = jload(path)
    assert meta == {"note": "port"}
    assert type(jts["models"]).__name__ == "ModelParams"
    _assert_same_tree(jax.tree.map(np.asarray, jts), tree)
    raw = open(path, "rb").read()
    assert msgpack.packb(msgpack.unpackb(raw, raw=False,
                                         strict_map_key=False),
                         use_bin_type=True) == raw
    assert not os.path.exists(path + ".tmp")


def test_policies_cross_both_ways(tmp_path):
    cfg_j, cfg_t = _cfgs(cacher="arc")
    ts = _jax_state(cfg_j, None)
    pol = jax.tree.map(np.asarray, jt2.export_policy(ts, cfg_j))
    assert set(pol) == {"actor", "cache"}
    path = str(tmp_path / "pol.ckpt")
    jsave(path, jt2.export_policy(ts, cfg_j))
    got, _ = load_train_state(path, device="cpu")
    want = policy_from_numpy(pol, device="cpu")
    _assert_same_port(got, want)
    save_train_state(str(tmp_path / "back.ckpt"), got)
    back, _ = jload(str(tmp_path / "back.ckpt"))
    _assert_same_tree(jax.tree.map(np.asarray, back), pol)


def test_trained_state_round_trips_and_serves_the_same(tmp_path):
    cfg = tt2.T2DRLCfg(env=tenv.EnvCfg(**SMALL), L=2, warmup=2,
                       cacher="ddqn")
    ts, _ = tt2.train_t2drl(cfg, episodes=2, device="cpu")
    path = str(tmp_path / "trained.ckpt")
    save_train_state(path, ts, cfg=cfg)
    got, _ = load_train_state(path, cfg, device="cpu")
    # the port keeps integer buffer leaves as int64, the file as int32
    _assert_same_port(got, ts)
    runs = []
    for state in (ts, got):
        pol = tt2.export_policy(state, cfg)
        runs.append(tt2.run_eval(pol, state["models"], cfg, episodes=1,
                                 seed=3, device="cpu"))
    assert runs[0] == runs[1]


def test_bfloat16_and_plain_trees(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)
            .to(torch.bfloat16),
            "xs": [np.arange(3, dtype=np.int32), (np.float64(2.5), True)]}
    path = str(tmp_path / "tree.ckpt")
    save_pytree(path, tree)
    got = load_pytree(path)
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"],
                                                            tree["w"])
    np.testing.assert_array_equal(got["xs"][0], tree["xs"][0])
    assert isinstance(got["xs"][1], tuple) and got["xs"][1][1] == True  # noqa: E712


def test_checkpoints_need_no_msgpack_package(tmp_path):
    code = f"""
import sys
sys.modules["msgpack"] = None
import numpy as np, torch
from repro_torch.checkpoint import save_pytree, load_pytree
save_pytree({str(tmp_path / 'x.ckpt')!r}, {{"a": np.arange(4), "b": [1.5]}})
t = load_pytree({str(tmp_path / 'x.ckpt')!r})
assert t["a"].tolist() == [0, 1, 2, 3] and float(t["b"][0]) == 1.5
try:
    import msgpack
except ImportError:
    print("no msgpack")
"""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"),
         os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "no msgpack" in out.stdout
