"""A copy of the benchmark with a tiny serving cell added, for CPU tests.

``serve_copy(dest)`` makes ``tiny_copy(dest)`` and adds, as data files
and entries only, the configuration ``qwen3-smoke`` (the port's
``configs/qwen3_4b.py:make_smoke``: 2 layers, d_model 128, 4 query and 2
key-value heads of 32, qk-norm, d_ff 256, vocab 512) and the cell
``serve-tiny``: the ``serve_chat`` mix at 4 slots, prompts of 3 to 40
tokens (buckets 8 to 64) and answers of 2 to 12.  Its limits are its
own, set as the real cell's were from readings at this size on the CPU
(12 seeds, 2**31 + 7919 k for k = 20..31; each fault on 3 seeds): sound
runs read at most 0.0166 ``logit_gap`` and 0.0181 ``token_gap``, the
control at least 0.150 and 0.051, the faults at least 0.422 and 0.448.
The serving metrics list the tiny cell beside the real one.
"""
from __future__ import annotations

import json
from pathlib import Path

from perfbench.tests.tiny import tiny_copy

REAL = "serve-qwen3-4b-chat-b28"
CELL = "serve-tiny"
SMOKE_PORT = {
    "d_model": 128, "vocab": 512,
    "groups": [{"cycle": ["attn"], "repeats": 2}],
    "attn": {"n_heads": 4, "n_kv_heads": 2, "d_head": 32,
             "rope_theta": 10000.0, "qk_norm": True, "shared": False},
    "mlp": {"d_ff": 256, "gated": True, "act": "silu"}}
SMOKE_MIX = {"max_batch": 4, "max_seq": 128,
             "prompt": {"median": 12, "sigma": 1.0, "min": 3, "max": 40},
             "output": {"median": 6, "sigma": 0.5, "min": 2, "max": 12},
             "pool": 16, "warm_steps": 2, "trace_steps": 4,
             "checked_requests": 4, "checked_rows": 3}
SMOKE_LIMITS = {"token_gap": 0.1, "logit_gap": 0.05}


def smoke_config() -> dict:
    cfg = json.loads((Path(__file__).resolve().parents[1] / "configs"
                      / "qwen3-4b.json").read_text())
    cfg["name"] = "qwen3-smoke"
    cfg["program"]["make"] = "make_smoke"
    cfg["port"].update(SMOKE_PORT)
    return cfg


def serve_copy(dest: Path) -> Path:
    root = tiny_copy(dest)
    pkg = root / "perfbench"
    (pkg / "configs" / "qwen3-smoke.json").write_text(
        json.dumps(smoke_config()))
    mix = json.loads((pkg / "traffic" / "serve_chat.json").read_text())
    mix.update(SMOKE_MIX)
    (pkg / "traffic" / "serve_tiny.json").write_text(json.dumps(mix))
    w = json.loads((pkg / "workloads" / f"{REAL}.json").read_text())
    w.update(config="qwen3-smoke", traffic="serve_tiny",
             limits=SMOKE_LIMITS)
    (pkg / "workloads" / f"{CELL}.json").write_text(json.dumps(w))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": CELL, "config": "qwen3-smoke",
                               "traffic": "serve_tiny", "chips": 1,
                               "why": "a CPU rehearsal"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if REAL in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root
