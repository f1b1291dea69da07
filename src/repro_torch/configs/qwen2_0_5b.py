"""qwen2-0.5b [dense] — 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151936; GQA with QKV bias.  [arXiv:2407.10671]"""
from repro_torch.configs import Arch
from repro_torch.configs.common import dense_lm


def make_full(window=None, remat=False):
    return dense_lm("qwen2-0.5b", layers=24, d_model=896, n_heads=14,
                    n_kv_heads=2, d_ff=4864, vocab=151936, qkv_bias=True,
                    rope_theta=1e6, tie=True, window=window, remat=remat)


def make_smoke():
    return dense_lm("qwen2-0.5b-smoke", layers=2, d_model=128, n_heads=4,
                    n_kv_heads=2, d_ff=256, vocab=512, qkv_bias=True,
                    rope_theta=1e6, tie=True)


ARCH = Arch(name="qwen2-0.5b", family="dense", cite="arXiv:2407.10671",
            make_full=make_full, make_smoke=make_smoke)
