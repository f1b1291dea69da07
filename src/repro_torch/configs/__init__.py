"""Architecture registry (port of ``repro.configs``): the ten assigned
architectures.

Each ``configs/<id>.py`` exports ``ARCH: Arch`` with the assigned
full-width config (``make_full``) and a reduced same-family smoke variant
(``make_smoke``), as in the JAX package; ``make_cfg`` applies a shape's
variant (the sliding window of ``long_500k``).  ``input_specs(arch,
shape)`` gives meta-tensor stand-ins (shapes and dtypes, no storage) for
every model input of the shape's step, as the dry run uses them.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Dict, Optional, Tuple

import torch


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

# window applied to attention archs for the sub-quadratic long_500k variant
LONG_CONTEXT_WINDOW = 8192


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
    return importlib.import_module(f"repro_torch.configs.{mod_name}").ARCH


def list_archs():
    return [get_arch(i) for i in ARCH_IDS]


def supports(arch: Arch, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and not arch.supports_long:
        return False, ("decoder uses learned absolute positions capped at "
                       "448 in the source model; a 524k decoder context has "
                       "no meaningful analogue (DESIGN.md §Shape skips)")
    return True, ""


def make_cfg(arch: Arch, shape: str, *, remat: Optional[bool] = None,
             unroll: bool = False):
    """Model config for (arch, shape): the sliding-window variant for
    attention-family archs on long_500k, remat for training shapes (a
    training flag the port's forward ignores), ``unroll`` as given."""
    kw = {}
    if shape == "long_500k" and arch.needs_window_for_long:
        kw["window"] = LONG_CONTEXT_WINDOW
    if remat is None:
        remat = SHAPES[shape].step == "train"
    kw["remat"] = remat
    cfg = arch.make_full(**kw)
    if unroll:
        cfg = dataclasses.replace(cfg, unroll=True)
    return cfg


# -- input specs (meta-tensor stand-ins: no allocation) ------------------------------

def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(arch: Arch, shape: str, *, cache_dtype=torch.bfloat16):
    """Returns (step, inputs: dict[str, tree of meta tensors]).

    train:   {tokens, labels[, prefix_embeds | frame_embeds]}
    prefill: {tokens[, prefix_embeds | frame_embeds], cache}
    decode:  {token, cache, pos}

    Token ids are int32, as the reference's are."""
    sc = SHAPES[shape]
    cfg = make_cfg(arch, shape)
    B, L = sc.global_batch, sc.seq_len
    step = sc.step
    i32, bf16 = torch.int32, torch.bfloat16

    if arch.kind == "whisper":
        from repro_torch.models.whisper import whisper_init_cache
        fe = _sds((B, cfg.n_frames, cfg.d_model), bf16)
        if step == "train":
            return step, {"frame_embeds": fe, "tokens": _sds((B, L), i32),
                          "labels": _sds((B, L), i32)}
        cache = whisper_init_cache(cfg, B, L, dtype=cache_dtype,
                                   device="meta")
        if step == "prefill":
            return step, {"frame_embeds": fe, "tokens": _sds((B, L), i32),
                          "cache": cache}
        return step, {"token": _sds((B, 1), i32), "cache": cache,
                      "pos": _sds((), i32)}

    from repro_torch.models.lm import lm_init_cache
    n_pre = arch.n_prefix
    if step == "train":
        d = {"tokens": _sds((B, L - n_pre), i32),
             "labels": _sds((B, L), i32)}
        if n_pre:
            d["prefix_embeds"] = _sds((B, n_pre, arch.prefix_embed_dim),
                                      bf16)
        return step, d
    cache = lm_init_cache(cfg, B, L, dtype=cache_dtype, device="meta")
    if step == "prefill":
        d = {"tokens": _sds((B, L - n_pre), i32), "cache": cache}
        if n_pre:
            d["prefix_embeds"] = _sds((B, n_pre, arch.prefix_embed_dim),
                                      bf16)
        return step, d
    return step, {"token": _sds((B, 1), i32), "cache": cache,
                  "pos": _sds((), i32)}
