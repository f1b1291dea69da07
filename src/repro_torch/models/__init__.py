"""Models of the LM side branch (port of ``repro.models``): blocks, the
CompositeLM and whisper, with the names ``repro.models`` exports but the
parameter and cache specs (``*_spec``), which come with the mesh half
(ROADMAP A.12 step 4)."""
from .blocks import BlockCfg  # noqa: F401
from .lm import (GroupCfg, LMCfg, lm_decode, lm_forward, lm_init,  # noqa: F401
                 lm_init_cache, lm_loss, lm_prefill, softmax_xent)
from .whisper import (WhisperCfg, whisper_decode, whisper_forward,  # noqa: F401
                      whisper_init, whisper_init_cache, whisper_loss,
                      whisper_prefill)
from . import whisper  # noqa: F401
