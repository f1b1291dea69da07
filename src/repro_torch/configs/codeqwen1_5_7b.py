"""codeqwen1.5-7b [dense] — 32L d_model=4096 32H (kv=32) d_ff=13440
vocab=92416; qwen1.5 arch (QKV bias).  [hf:Qwen/CodeQwen1.5-7B]"""
from repro_torch.configs import Arch
from repro_torch.configs.common import dense_lm


def make_full(window=None, remat=False):
    return dense_lm("codeqwen1.5-7b", layers=32, d_model=4096, n_heads=32,
                    n_kv_heads=32, d_ff=13440, vocab=92416, qkv_bias=True,
                    rope_theta=1e6, tie=False, window=window, remat=remat)


def make_smoke():
    return dense_lm("codeqwen1.5-7b-smoke", layers=2, d_model=128, n_heads=4,
                    n_kv_heads=4, d_ff=320, vocab=512, qkv_bias=True,
                    tie=False)


ARCH = Arch(name="codeqwen1.5-7b", family="dense",
            cite="hf:Qwen/CodeQwen1.5-7B", make_full=make_full,
            make_smoke=make_smoke)
