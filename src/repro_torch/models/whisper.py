"""Whisper-style encoder-decoder backbone (port of ``repro.models.whisper``).

The mel-spectrogram and conv frontend are stubbed, as in the reference:
the encoder takes precomputed frame embeddings (B, n_frames, d_model).
Then: sinusoidal encoder positions and a non-causal encoder stack (the
plain attention path), learned decoder positions, a decoder of causal
self-attention (through the ``flash_attention`` kernel in prefill),
cross-attention over the encoder output and a GELU MLP, and the tied
unembedding.  The decoder's cache holds its self-attention K/V per
position and, per layer, the encoder's cross K/V, which prefill computes
once and decode only reads.  ``whisper_loss`` trains teacher-forced
through the plain path, as the reference's does; ``cfg.remat`` recomputes
each encoder and decoder layer in the backward.  ``whisper_spec`` and
``whisper_cache_spec`` are the reference's PartitionSpec trees; under a
mesh the encoder and decoder streams and the logits cross the
reference's ``constrain`` points.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.nn import core
from repro_torch.nn.attention import AttnCfg
from repro_torch.nn.mlp import MLPCfg
from repro_torch.nn.sharding import (P, batch_spec, constrain, is_dtensor,
                                     replicate_like)

from .blocks import (BlockCfg, block_cache_spec, block_forward,
                     block_init_cache)
from .lm import (GroupCfg, _group_init, _group_spec, _stack_spec,
                 group_decode, group_prefill, repeat_params, run_repeats,
                 softmax_xent, stacked_cache)


@dataclasses.dataclass(frozen=True)
class WhisperCfg:
    name: str
    vocab: int
    d_model: int
    n_layers: int          # per stack (encoder and decoder)
    n_heads: int
    d_ff: int
    n_frames: int = 1500   # encoder positions (stubbed conv output length)
    max_positions: int = 4096  # decoder learned positions
    remat: bool = False        # recompute each layer in the backward
    unroll: bool = False       # the port always loops in Python

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    def enc_block(self) -> BlockCfg:
        return BlockCfg(
            d_model=self.d_model, mixer="attn", ffn="mlp", norm="ln",
            attn=AttnCfg(self.d_model, self.n_heads, self.n_heads,
                         self.d_head, rope=False, causal=False),
            mlp=MLPCfg(self.d_model, self.d_ff, gated=False, act="gelu"))

    def dec_block(self) -> BlockCfg:
        return BlockCfg(
            d_model=self.d_model, mixer="attn", ffn="mlp", norm="ln",
            attn=AttnCfg(self.d_model, self.n_heads, self.n_heads,
                         self.d_head, rope=False, causal=True),
            cross=AttnCfg(self.d_model, self.n_heads, self.n_heads,
                          self.d_head, rope=False, causal=False, cross=True,
                          d_kv_in=self.d_model),
            mlp=MLPCfg(self.d_model, self.d_ff, gated=False, act="gelu"))

    def enc_group(self) -> GroupCfg:
        return GroupCfg((self.enc_block(),), self.n_layers)

    def dec_group(self) -> GroupCfg:
        return GroupCfg((self.dec_block(),), self.n_layers)


def sinusoids(length: int, d: int, device=None) -> torch.Tensor:
    half = d // 2
    log_timescale = math.log(10000.0) / (half - 1)
    inv = torch.exp(-log_timescale * torch.arange(half, dtype=torch.float32,
                                                  device=device))
    ang = torch.arange(length, dtype=torch.float32,
                       device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)


def whisper_init(generator: torch.Generator, cfg: WhisperCfg, *,
                 dtype=torch.float32) -> dict:
    dev = generator.device
    return {
        "embed": core.embedding_init(generator, cfg.vocab, cfg.d_model,
                                     dtype=dtype),
        "pos": core.normal_init(generator, (cfg.max_positions, cfg.d_model),
                                0.02, dtype),
        "enc": _group_init(generator, cfg.enc_group(), dtype=dtype),
        "enc_norm": core.layernorm_init(cfg.d_model, dtype=dtype,
                                        device=dev),
        "dec": _group_init(generator, cfg.dec_group(), dtype=dtype),
        "dec_norm": core.layernorm_init(cfg.d_model, dtype=dtype,
                                        device=dev),
    }


def whisper_spec(cfg: WhisperCfg) -> dict:
    return {"embed": core.embedding_spec(),
            "pos": P(None, None),
            "enc": _group_spec(cfg.enc_group()),
            "enc_norm": core.layernorm_spec(),
            "dec": _group_spec(cfg.dec_group()),
            "dec_norm": core.layernorm_spec()}


def whisper_encode(p, cfg: WhisperCfg, frame_embeds, *,
                   compute_dtype=torch.bfloat16):
    """frame_embeds: (B, n_frames, d_model), the stubbed frontend's
    output -> the encoder states, layer-normed."""
    x = frame_embeds.to(compute_dtype)
    x = x + replicate_like(sinusoids(x.shape[1], cfg.d_model, x.device)
                           .to(compute_dtype), x)
    x = constrain(x, batch_spec(None, None))
    g = cfg.enc_group()

    def body(bps, x, aux):
        return block_forward(bps[0], g.cycle[0], x, impl="plain",
                             compute_dtype=compute_dtype)
    x, _ = run_repeats(body, repeat_params(p["enc"], g), x, None, cfg.remat)
    return core.layernorm(p["enc_norm"], x)


def _decode_embed(p, cfg: WhisperCfg, tokens, pos_offset, compute_dtype):
    """Token embeddings plus learned positions from ``pos_offset`` (an int,
    or a (B,) tensor for one token a row), the start clamped as
    ``dynamic_slice`` clamps it."""
    x = core.embed(p["embed"], tokens, compute_dtype=compute_dtype)
    L = tokens.shape[1]
    if torch.is_tensor(pos_offset) and pos_offset.dim():
        table = p["pos"]
        if is_dtensor(table):        # replicated: every rank's whole table
            table = constrain(table, P(None, None)).to_local()
        pos = replicate_like(
            table[pos_offset.clamp(0, cfg.max_positions - 1)[:, None]], x)
    else:
        s = min(max(int(pos_offset), 0), cfg.max_positions - L)
        pos = p["pos"][s: s + L]
    return x + pos.to(compute_dtype)


def _unembed(p, x, compute_dtype):
    x = core.layernorm(p["dec_norm"], x)
    return core.unembed(p["embed"], x, compute_dtype=compute_dtype)


def _logits(p, x, compute_dtype):
    return constrain(_unembed(p, x, compute_dtype), batch_spec(None, "model"))


def whisper_forward(p, cfg: WhisperCfg, frame_embeds, tokens, *,
                    impl: str = "kernel", compute_dtype=torch.bfloat16):
    """Teacher-forced forward.  Returns (logits (B, L, vocab) f32, aux=0)."""
    enc = whisper_encode(p, cfg, frame_embeds, compute_dtype=compute_dtype)
    x = constrain(_decode_embed(p, cfg, tokens, 0, compute_dtype),
                  batch_spec(None, None))
    g = cfg.dec_group()
    positions = torch.arange(x.shape[1], device=x.device)

    def body(bps, x, aux):
        x, _ = block_forward(bps[0], g.cycle[0], x, positions=positions,
                             enc=enc, impl=impl, compute_dtype=compute_dtype)
        return x, aux
    x, _ = run_repeats(body, repeat_params(p["dec"], g), x, None, cfg.remat)
    return (_logits(p, x, compute_dtype),
            x.new_zeros((), dtype=torch.float32))


def whisper_loss(p, cfg: WhisperCfg, batch: dict, *,
                 compute_dtype=torch.bfloat16):
    """batch: {"frame_embeds", "tokens", "labels"}.  Teacher-forced
    cross-entropy through the plain path (the reference's decoder runs
    ``"xla"``).  Returns (loss, {"loss", "xent"})."""
    logits, _ = whisper_forward(p, cfg, batch["frame_embeds"],
                                batch["tokens"], impl="plain",
                                compute_dtype=compute_dtype)
    loss = softmax_xent(logits, batch["labels"])
    return loss, {"loss": loss, "xent": loss}


# -- serving ------------------------------------------------------------------

def whisper_init_cache(cfg: WhisperCfg, B: int, S: int, *,
                       dtype=torch.bfloat16, device=None) -> dict:
    """The decoder's cache: per layer its self-attention K/V over S
    positions and its cross K/V over the n_frames encoder states; leaves
    lead with the layer axis."""
    return stacked_cache(cfg.dec_group(), lambda b: block_init_cache(
        b, B, S, enc_len=cfg.n_frames, dtype=dtype, device=device))


def whisper_cache_spec(cfg: WhisperCfg, *, seq_shard=None) -> dict:
    g = cfg.dec_group()
    return {str(i): _stack_spec(block_cache_spec(b, seq_shard=seq_shard))
            for i, b in enumerate(g.cycle)}


def whisper_prefill(p, cfg: WhisperCfg, frame_embeds, tokens, cache, *,
                    impl: str = "kernel", compute_dtype=torch.bfloat16):
    """Encode the audio and prefill decoder tokens [0, L).  Returns
    (last-token logits (B, 1, vocab) f32, the filled cache: self-attention
    K/V at [0, L) and the cross K/V computed from the encoder output); the
    cache passed in is not changed."""
    enc = whisper_encode(p, cfg, frame_embeds, compute_dtype=compute_dtype)
    x = constrain(_decode_embed(p, cfg, tokens, 0, compute_dtype),
                  batch_spec(None, None))
    x, new = group_prefill(p["dec"], cfg.dec_group(), x, cache,
                           positions=torch.arange(x.shape[1],
                                                  device=x.device),
                           enc=enc, impl=impl, compute_dtype=compute_dtype)
    return _unembed(p, x[:, -1:], compute_dtype), new


def whisper_decode(p, cfg: WhisperCfg, token, cache, pos, *,
                   compute_dtype=torch.bfloat16):
    """One decoder token (B, 1) at position ``pos`` (scalar or (B,))
    against the self- and cross-attention caches.  Returns (logits (B, 1,
    vocab) f32, new cache)."""
    if not torch.is_tensor(pos) or pos.dim() == 0:
        pos = torch.as_tensor(pos, device=token.device).expand(
            token.shape[0])
    x = constrain(_decode_embed(p, cfg, token, pos, compute_dtype),
                  batch_spec(None, None))
    x, new = group_decode(p["dec"], cfg.dec_group(), x, cache, pos,
                          compute_dtype=compute_dtype)
    return _unembed(p, x, compute_dtype), new
