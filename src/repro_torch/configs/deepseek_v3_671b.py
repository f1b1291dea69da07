"""deepseek-v3-671b [moe] — 61L d_model=7168 128H, MLA (kv_lora=512),
MoE: 1 shared + 256 routed top-8, expert d_ff=2048, vocab=129280, MTP.
First 3 layers dense (d_ff=18432).  [arXiv:2412.19437]"""
from repro_torch.configs import Arch
from repro_torch.configs.common import deepseek_lm


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


ARCH = Arch(name="deepseek-v3-671b", family="moe", cite="arXiv:2412.19437",
            make_full=make_full, make_smoke=make_smoke)
