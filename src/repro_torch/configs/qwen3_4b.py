"""qwen3-4b [dense] — 36L d_model=2560 32H (GQA kv=8) d_ff=9728
vocab=151936; qk-norm, no QKV bias, head_dim=128.  [hf:Qwen/Qwen3-8B]"""
from repro_torch.configs import Arch
from repro_torch.configs.common import dense_lm


def make_full(window=None, remat=False):
    return dense_lm("qwen3-4b", layers=36, d_model=2560, n_heads=32,
                    n_kv_heads=8, d_ff=9728, vocab=151936, d_head=128,
                    qk_norm=True, rope_theta=1e6, tie=True, window=window,
                    remat=remat)


def make_smoke():
    return dense_lm("qwen3-4b-smoke", layers=2, d_model=128, n_heads=4,
                    n_kv_heads=2, d_ff=256, vocab=512, d_head=32,
                    qk_norm=True, tie=True)


ARCH = Arch(name="qwen3-4b", family="dense", cite="hf:Qwen/Qwen3-8B",
            make_full=make_full, make_smoke=make_smoke)
