"""Architecture registry (port of ``repro.configs``).

Each ported ``configs/<id>.py`` exports ``ARCH: Arch`` with the assigned
full-width config (``make_full``) and a reduced same-family smoke variant
(``make_smoke``), as in the JAX package.  ``get_arch`` on an architecture
that is not ported yet raises ``NotImplementedError`` naming its ROADMAP
item.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Dict


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    step: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class Arch:
    name: str
    family: str                      # dense|moe|hybrid|ssm|audio|vlm
    cite: str
    make_full: Callable[..., Any]    # kwargs: window, remat
    make_smoke: Callable[[], Any]
    kind: str = "lm"                 # "lm" | "whisper"
    n_prefix: int = 0
    prefix_embed_dim: int = 0
    needs_window_for_long: bool = True
    supports_long: bool = True


ARCH_IDS = [
    "qwen2_0_5b", "olmo_1b", "codeqwen1_5_7b", "deepseek_v3_671b",
    "zamba2_7b", "deepseek_v2_236b", "mamba2_130m", "whisper_small",
    "internvl2_2b", "qwen3_4b",
]
PORTED = ("qwen2_0_5b", "mamba2_130m")

_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}
_ALIASES.update({
    "qwen2-0.5b": "qwen2_0_5b", "olmo-1b": "olmo_1b",
    "codeqwen1.5-7b": "codeqwen1_5_7b", "deepseek-v3-671b": "deepseek_v3_671b",
    "zamba2-7b": "zamba2_7b", "deepseek-v2-236b": "deepseek_v2_236b",
    "mamba2-130m": "mamba2_130m", "whisper-small": "whisper_small",
    "internvl2-2b": "internvl2_2b", "qwen3-4b": "qwen3_4b",
})


def canonical_id(name: str) -> str:
    """'qwen2-0.5b' -> 'qwen2_0_5b' (the module id used in filenames)."""
    return _ALIASES.get(name, name)


def get_arch(name: str) -> Arch:
    mod_name = canonical_id(name)
    if mod_name not in ARCH_IDS:
        raise KeyError(f"unknown architecture {name!r}")
    if mod_name not in PORTED:
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP queue A: the other eight "
            f"architectures); ported: {', '.join(PORTED)}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").ARCH
