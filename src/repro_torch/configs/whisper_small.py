"""whisper-small [audio] — enc-dec, 12L each, d_model=768 12H d_ff=3072
vocab=51865.  Conv/mel frontend STUBBED: encoder consumes precomputed frame
embeddings (B, 1500, 768) per the assignment carve-out.  long_500k is
SKIPPED (learned absolute decoder positions, 448-token spec cap — see
DESIGN.md §Shape skips).  [arXiv:2212.04356]"""
from repro_torch.configs import Arch
from repro_torch.models.whisper import WhisperCfg


def make_full(window=None, remat=False):
    del window
    return WhisperCfg(name="whisper-small", vocab=51865, d_model=768,
                      n_layers=12, n_heads=12, d_ff=3072, n_frames=1500,
                      max_positions=32768, remat=remat)


def make_smoke():
    return WhisperCfg(name="whisper-small-smoke", vocab=512, d_model=128,
                      n_layers=2, n_heads=4, d_ff=256, n_frames=30,
                      max_positions=128)


ARCH = Arch(name="whisper-small", family="audio", cite="arXiv:2212.04356",
            make_full=make_full, make_smoke=make_smoke, kind="whisper",
            supports_long=False, needs_window_for_long=False)
