"""olmo-1b [dense] — 16L d_model=2048 16H (kv=16) d_ff=8192 vocab=50304;
non-parametric LayerNorm (no scale/bias).  [arXiv:2402.00838]"""
from repro_torch.configs import Arch
from repro_torch.configs.common import dense_lm


def make_full(window=None, remat=False):
    return dense_lm("olmo-1b", layers=16, d_model=2048, n_heads=16,
                    n_kv_heads=16, d_ff=8192, vocab=50304, norm="ln_np",
                    tie=True, window=window, remat=remat)


def make_smoke():
    return dense_lm("olmo-1b-smoke", layers=2, d_model=128, n_heads=4,
                    n_kv_heads=4, d_ff=256, vocab=512, norm="ln_np", tie=True)


ARCH = Arch(name="olmo-1b", family="dense", cite="arXiv:2402.00838",
            make_full=make_full, make_smoke=make_smoke)
