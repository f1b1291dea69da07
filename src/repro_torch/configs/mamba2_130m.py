"""mamba2-130m [ssm] — 24L d_model=768 (attention-free) vocab=50280,
ssm_state=128, SSD (state-space duality).  [arXiv:2405.21060]"""
from repro_torch.configs import Arch
from repro_torch.configs.common import mamba_lm


def make_full(window=None, remat=False):
    del window  # attention-free: long contexts are native
    return mamba_lm("mamba2-130m", layers=24, d_model=768, d_state=128,
                    vocab=50280, head_dim=64, n_groups=1, remat=remat)


def make_smoke():
    return mamba_lm("mamba2-130m-smoke", layers=2, d_model=128, d_state=32,
                    vocab=512, head_dim=32, chunk=16)


ARCH = Arch(name="mamba2-130m", family="ssm", cite="arXiv:2405.21060",
            make_full=make_full, make_smoke=make_smoke,
            needs_window_for_long=False)
