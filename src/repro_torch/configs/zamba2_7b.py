"""zamba2-7b [hybrid] — 81L d_model=3584, Mamba2 (ssm_state=64) + SHARED
attention blocks (32H kv=32, d_ff=14336) interleaved every 6th position:
13 × (5 Mamba2 + 1 shared attn) + 3 Mamba2 tail = 81.  [arXiv:2411.15242]"""
from repro_torch.configs import Arch
from repro_torch.configs.common import zamba_lm


def make_full(window=None, remat=False):
    del window  # hybrid runs long_500k natively (attn share is windowless
    # but only 13/81 layers; the SSM majority keeps state constant-size)
    return zamba_lm("zamba2-7b", mamba_per_cycle=5, cycles=13, tail_mamba=3,
                    d_model=3584, d_state=64, n_heads=32, n_kv_heads=32,
                    d_ff=14336, vocab=32000, remat=remat)


def make_smoke():
    return zamba_lm("zamba2-7b-smoke", mamba_per_cycle=2, cycles=1,
                    tail_mamba=1, d_model=128, d_state=16, n_heads=4,
                    n_kv_heads=4, d_ff=256, vocab=512, head_dim=32,
                    n_groups=1, chunk=16)


ARCH = Arch(name="zamba2-7b", family="hybrid", cite="arXiv:2411.15242",
            make_full=make_full, make_smoke=make_smoke,
            needs_window_for_long=False)
