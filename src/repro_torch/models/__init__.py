"""Models of the LM side branch (port of ``repro.models``): blocks, the
CompositeLM and whisper, with the names ``repro.models`` exports, the
parameter and cache PartitionSpec trees (``*_spec``) among them."""
from .blocks import BlockCfg  # noqa: F401
from .lm import (GroupCfg, LMCfg, lm_cache_spec, lm_decode,  # noqa: F401
                 lm_forward, lm_init, lm_init_cache, lm_loss, lm_prefill,
                 lm_spec, softmax_xent)
from .whisper import (WhisperCfg, whisper_cache_spec,  # noqa: F401
                      whisper_decode, whisper_forward, whisper_init,
                      whisper_init_cache, whisper_loss, whisper_prefill,
                      whisper_spec)
from . import whisper  # noqa: F401
