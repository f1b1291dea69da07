"""deepseek-v3-671b [moe] — 61L d_model=7168 128H, MLA (kv_lora=512),
MoE: 1 shared + 256 routed top-8, expert d_ff=2048, vocab=129280, MTP.
First 3 layers dense (d_ff=18432).  [arXiv:2412.19437]

``make_full`` and ``make_smoke`` are the JAX package's twins: they keep
its DeepSeek-V2-style router (softmax top-k, renormalised, tokens past a
capacity of 1.25 dropped) and plain RoPE.  ``make_ep32`` is the model as
published (huggingface.co/deepseek-ai/DeepSeek-V3, config.json) at one
chip's share of a stated deployment: the sigmoid router with its
correction bias, 8 groups of which 4 are kept, renormalised weights
times 2.5 (``topk_method: noaux_tc``), dropless; MLA's RoPE under YaRN
(factor 40 over 4096 original positions, beta 32 / 1, mscale and
mscale_all_dim 1); every width as published.  The deployment: each MoE
layer's 256 experts over 32 chips (EP32, 8 a chip), attention data
parallel, the 61 layers in four pipeline stages of 16/15/15/15; this
chip holds stage 1 (the 3 dense layers and 13 MoE layers, experts
[first_expert, first_expert + 8) and the shared expert of each) and
both vocabulary matrices whole; no MTP module (the engine decodes one
token a step).
"""
from repro_torch.configs import Arch
from repro_torch.configs.common import deepseek_lm
from repro_torch.nn.rotary import YaRN

EP32_LAYERS = 16            # pipeline stage 1 of 16/15/15/15
EP32_HELD = 8               # 256 experts over 32 chips
V3_YARN = YaRN(factor=40.0, original_max_positions=4096, beta_fast=32.0,
               beta_slow=1.0, mscale=1.0, mscale_all_dim=1.0)
V3_ROUTER = {"score_func": "sigmoid", "score_correction": True,
             "n_group": 8, "topk_group": 4, "routed_scaling": 2.5}


def make_full(window=None, remat=False):
    return deepseek_lm("deepseek-v3-671b", layers=61, dense_layers=3,
                       d_model=7168, n_heads=128, vocab=129280,
                       moe_d_ff=2048, dense_d_ff=18432, n_experts=256,
                       top_k=8, n_shared=1, kv_lora_rank=512,
                       q_lora_rank=1536, mtp=True, window=window,
                       remat=remat)


def make_smoke():
    return deepseek_lm("deepseek-v3-671b-smoke", layers=2, dense_layers=1,
                       d_model=256, n_heads=4, vocab=512, moe_d_ff=128,
                       dense_d_ff=512, n_experts=4, top_k=2, n_shared=1,
                       kv_lora_rank=64, q_lora_rank=96, qk_nope_dim=32,
                       qk_rope_dim=16, v_head_dim=32, mtp=True)


def make_ep32(first_expert: int = 0):
    """DeepSeek-V3 as published, one EP32 chip's share of pipeline stage
    1 (module docstring): experts [first_expert, first_expert + 8)."""
    return deepseek_lm("deepseek-v3-671b-ep32", layers=EP32_LAYERS,
                       dense_layers=3, d_model=7168, n_heads=128,
                       vocab=129280, moe_d_ff=2048, dense_d_ff=18432,
                       n_experts=256, top_k=8, n_shared=1, kv_lora_rank=512,
                       q_lora_rank=1536, rope_scaling=V3_YARN,
                       router={**V3_ROUTER, "first_expert": first_expert,
                               "n_held": EP32_HELD})


ARCH = Arch(name="deepseek-v3-671b", family="moe", cite="arXiv:2412.19437",
            make_full=make_full, make_smoke=make_smoke)
