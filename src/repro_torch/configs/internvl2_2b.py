"""internvl2-2b [vlm] — InternViT frontend STUBBED (precomputed patch
embeddings, 256 × 1024 per image); LM backbone = InternLM2-1.8B:
24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.  [arXiv:2404.16821]"""
from repro_torch.configs import Arch
from repro_torch.configs.common import dense_lm

N_PREFIX = 256          # patch slots per image (448px / 14 / pixel-shuffle 2)
PATCH_DIM = 1024        # InternViT-300M hidden size


def make_full(window=None, remat=False):
    return dense_lm("internvl2-2b", layers=24, d_model=2048, n_heads=16,
                    n_kv_heads=8, d_ff=8192, vocab=92553, tie=False,
                    window=window, remat=remat, n_prefix=N_PREFIX,
                    prefix_embed_dim=PATCH_DIM)


def make_smoke():
    return dense_lm("internvl2-2b-smoke", layers=2, d_model=128, n_heads=4,
                    n_kv_heads=2, d_ff=256, vocab=512, tie=False,
                    n_prefix=8, prefix_embed_dim=64)


ARCH = Arch(name="internvl2-2b", family="vlm", cite="arXiv:2404.16821",
            make_full=make_full, make_smoke=make_smoke, n_prefix=N_PREFIX,
            prefix_embed_dim=PATCH_DIM)
