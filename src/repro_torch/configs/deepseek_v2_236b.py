"""deepseek-v2-236b [moe] — 60L d_model=5120 128H, MLA kv_lora=512,
MoE: 2 shared + 160 routed top-6, expert d_ff=1536, vocab=102400.
First layer dense (d_ff=12288).  [arXiv:2405.04434]"""
from repro_torch.configs import Arch
from repro_torch.configs.common import deepseek_lm


def make_full(window=None, remat=False):
    return deepseek_lm("deepseek-v2-236b", layers=60, dense_layers=1,
                       d_model=5120, n_heads=128, vocab=102400,
                       moe_d_ff=1536, dense_d_ff=12288, n_experts=160,
                       top_k=6, n_shared=2, kv_lora_rank=512,
                       q_lora_rank=1536, window=window, remat=remat)


def make_smoke():
    return deepseek_lm("deepseek-v2-236b-smoke", layers=2, dense_layers=1,
                       d_model=256, n_heads=4, vocab=512, moe_d_ff=128,
                       dense_d_ff=512, n_experts=4, top_k=2, n_shared=2,
                       kv_lora_rank=64, q_lora_rank=96, qk_nope_dim=32,
                       qk_rope_dim=16, v_head_dim=32)


ARCH = Arch(name="deepseek-v2-236b", family="moe", cite="arXiv:2405.04434",
            make_full=make_full, make_smoke=make_smoke)
