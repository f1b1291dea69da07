"""The continuous-batching ``Engine`` on the architectures this slice
adds, against the JAX package's engine, in bf16 on the CPU.

Weights cross over through the bridge.  The two frameworks' bf16 logits
differ by up to ~0.025 on the smoke configs, so token streams are
compared only for seeds whose JAX runs keep every greedy top-2 margin at
or above 0.05 (tests/test_torch_lm.py's rule; the margin is asserted, and
codeqwen's untied head gives narrow margins, so it serves two requests).
The port's engine routes a MoE layer's decode per slot, as the JAX
engine's mapped one-slot decode does.  Then every decoder-only
architecture of the registry is served by the port at ``make_smoke``, and
the serve demo refuses whisper as the reference's does.
"""
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import lm as jlm
from repro.serving import ServeCfg as JServeCfg
from repro_torch.bridge import lm_params_from_numpy
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.device import make_generator
from repro_torch.launch.serve import serve_demo
from repro_torch.models import lm
from repro_torch.serving import Engine, ServeCfg

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_lm import (MIN_MARGIN, _engine_requests,  # noqa: E402
                           _watched_jax_engine)

# (seed, requests): the first seeds whose JAX runs keep every margin wide
ENGINE_RUNS = {"olmo-1b": (1, 4), "codeqwen1.5-7b": (3, 2),
               "deepseek-v3-671b": (0, 4), "zamba2-7b": (6, 4),
               "deepseek-v2-236b": (0, 4), "internvl2-2b": (28, 4),
               "qwen3-4b": (2, 4)}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(ENGINE_RUNS))
def test_engine_token_streams_equal_the_jax_engine(name):
    seed, n = ENGINE_RUNS[name]
    jcfg = jget_arch(name).make_smoke()
    tcfg = get_arch(name).make_smoke()
    jp = jlm.lm_init(jax.random.PRNGKey(seed), jcfg)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                              device="cpu")
    reqs = _engine_requests(seed, n=n)
    jeng, margins = _watched_jax_engine(jcfg, jp, JServeCfg(max_batch=2,
                                                            max_seq=64))
    jdone, jstats = jeng.run(reqs)
    assert min(margins) >= MIN_MARGIN, sorted(margins)[:3]
    done, stats = Engine(tcfg, tp, ServeCfg(max_batch=2, max_seq=64),
                         device="cpu").run(reqs)
    assert done == jdone
    assert stats["decode_steps"] == jstats["decode_steps"]


def test_every_decoder_only_architecture_is_served():
    """The nine decoder-only architectures at make_smoke, random weights:
    four requests through Engine(max_batch=2), every request's tokens."""
    served = []
    for i in ARCH_IDS:
        arch = get_arch(i)
        if arch.kind != "lm":
            continue
        cfg = arch.make_smoke()
        params = lm.lm_init(make_generator(0, "cpu"), cfg)
        reqs = _engine_requests(3, n=4, vocab=cfg.vocab)
        done, stats = Engine(cfg, params, ServeCfg(max_batch=2, max_seq=64),
                             device="cpu").run(reqs)
        assert sorted(done) == [0, 1, 2, 3], arch.name
        assert all(len(done[u]) == mnt + 1 for u, _, mnt in reqs), arch.name
        served.append(arch.name)
    assert len(served) == 9


def test_serve_demo_refuses_whisper_as_the_reference_does():
    with pytest.raises(SystemExit, match="whisper"):
        serve_demo("whisper-small", device="cpu")
