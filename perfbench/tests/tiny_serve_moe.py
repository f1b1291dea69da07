"""A copy of the benchmark with a tiny MLA/MoE serving cell added, for
CPU tests.

``serve_moe_copy(dest)`` makes ``tiny_copy(dest)`` and adds, as data
files and entries only, the configuration ``dsv3-tiny`` (DeepSeek-V3's
layout at a tiny width: 1 dense and 2 MoE layers, d_model 64, 2 heads at
MLA's published head widths (nope 128, rope 64, v 128, so that the
prefill takes ``flash_attention``'s (192, 128) path), latent 32, 16
experts of which 4 are held from expert 4, top-4 in 4 groups keeping 2,
YaRN over 16 original positions; the program's model is
``tests.tiny_serve_moe:make_tiny``) and the cell ``serve-moe-tiny``: the
``serve_longctx`` mix at 4 slots, prompts of 3 to 40 tokens and answers
of 2 to 12.  Its limits are its own, set as the real cell's were from
readings at this size on the CPU (12 seeds, 2**31 + 7919 k for k =
20..31; the control on each, each fault on the first 3): sound runs
read at most 0 ``token_gap_p90``, 0.0203 ``logit_gap_p50`` and 0.0227
``prefill_gap_p50``; the control at least 0.0645, 0.214 and 0.189; the
V2 router 0.142, 0.202, 0.200; the missing mscale 1.33, 0.631, 0.521;
a decode that keeps its cache 0.079, 0.061; a prefill's token moved
(``prefill_gap_p50``) 1.35.  The serving metrics list the tiny cell
beside the real one.
"""
from __future__ import annotations

import json
from pathlib import Path

from perfbench.tests.tiny import tiny_copy

REAL = "serve-dsv3-ep32-longctx-b96"
CELL = "serve-moe-tiny"
TINY_PORT = {
    "d_model": 64, "vocab": 97, "tie_embeddings": False, "norm_eps": 1e-06,
    "dense_layers": 1, "moe_layers": 2,
    "mla": {"n_heads": 2, "q_lora_rank": 48, "kv_lora_rank": 32,
            "qk_nope_dim": 128, "qk_rope_dim": 64, "v_head_dim": 128,
            "rope_theta": 10000.0,
            "yarn": {"factor": 40.0, "original_max_positions": 16,
                     "beta_fast": 32.0, "beta_slow": 1.0, "mscale": 1.0,
                     "mscale_all_dim": 1.0}},
    "mlp": {"d_ff": 96, "gated": True, "act": "silu"},
    "moe": {"n_experts": 16, "top_k": 4, "d_ff": 32, "n_shared": 1,
            "score_func": "sigmoid", "score_correction": True,
            "n_group": 4, "topk_group": 2, "routed_scaling": 2.5,
            "first_expert": 4, "n_held": 4}}
TINY_MIX = {"max_batch": 4, "max_seq": 128,
            "prompt": {"median": 12, "sigma": 1.0, "min": 3, "max": 40},
            "output": {"median": 6, "sigma": 0.5, "min": 2, "max": 12},
            "pool": 16, "warm_steps": 2, "trace_steps": 4, "layer_steps": 2,
            "checked_requests": 4, "checked_rows": 3}
TINY_LIMITS = {"token_gap_p90": 0.05, "logit_gap_p50": 0.05,
               "prefill_gap_p50": 0.06}


def make_tiny():
    """The program's model of ``TINY_PORT``."""
    from repro_torch.configs.common import deepseek_lm
    from repro_torch.configs.deepseek_v3_671b import V3_ROUTER
    from repro_torch.nn.rotary import YaRN
    a, e = TINY_PORT["mla"], TINY_PORT["moe"]
    return deepseek_lm(
        "dsv3-tiny", layers=3, dense_layers=1, d_model=64, n_heads=2,
        vocab=97, moe_d_ff=32, dense_d_ff=96, n_experts=16, top_k=4,
        n_shared=1, kv_lora_rank=32, q_lora_rank=48,
        qk_nope_dim=a["qk_nope_dim"], qk_rope_dim=a["qk_rope_dim"],
        v_head_dim=a["v_head_dim"],
        rope_scaling=YaRN(40.0, 16, 32.0, 1.0, 1.0, 1.0),
        router={**V3_ROUTER, "n_group": e["n_group"],
                "topk_group": e["topk_group"],
                "first_expert": e["first_expert"], "n_held": e["n_held"]})


def tiny_config() -> dict:
    cfg = json.loads((Path(__file__).resolve().parents[1] / "configs"
                      / "deepseek-v3-ep32.json").read_text())
    cfg["name"] = "dsv3-tiny"
    cfg["program"] = {"module": "perfbench.tests.tiny_serve_moe",
                      "make": "make_tiny"}
    cfg["port"].update(TINY_PORT)
    return cfg


def serve_moe_copy(dest: Path) -> Path:
    root = tiny_copy(dest)
    pkg = root / "perfbench"
    (pkg / "configs" / "dsv3-tiny.json").write_text(
        json.dumps(tiny_config()))
    mix = json.loads((pkg / "traffic" / "serve_longctx.json").read_text())
    mix.update(TINY_MIX)
    (pkg / "traffic" / "serve_moe_tiny.json").write_text(json.dumps(mix))
    w = json.loads((pkg / "workloads" / f"{REAL}.json").read_text())
    w.update(config="dsv3-tiny", traffic="serve_moe_tiny",
             limits=TINY_LIMITS)
    (pkg / "workloads" / f"{CELL}.json").write_text(json.dumps(w))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": CELL, "config": "dsv3-tiny",
                               "traffic": "serve_moe_tiny", "chips": 1,
                               "why": "a CPU rehearsal"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if REAL in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root
