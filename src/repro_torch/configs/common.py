"""Shared builders for the ported architecture configs (port of
``repro.configs.common``: the dense and the Mamba2 LM)."""
from __future__ import annotations

from typing import Optional

from repro_torch.models.blocks import BlockCfg
from repro_torch.models.lm import GroupCfg, LMCfg
from repro_torch.nn.attention import AttnCfg
from repro_torch.nn.mlp import MLPCfg
from repro_torch.nn.ssm import SSMCfg


def dense_lm(name: str, *, layers: int, d_model: int, n_heads: int,
             n_kv_heads: int, d_ff: int, vocab: int,
             d_head: Optional[int] = None, qkv_bias: bool = False,
             qk_norm: bool = False, norm: str = "rms",
             rope_theta: float = 10000.0, tie: bool = True,
             window: Optional[int] = None, remat: bool = False,
             n_prefix: int = 0, prefix_embed_dim: int = 0) -> LMCfg:
    d_head = d_head or d_model // n_heads
    blk = BlockCfg(
        d_model=d_model, mixer="attn", ffn="mlp", norm=norm,
        attn=AttnCfg(d_model, n_heads, n_kv_heads, d_head, qkv_bias=qkv_bias,
                     qk_norm=qk_norm, rope_theta=rope_theta, window=window),
        mlp=MLPCfg(d_model, d_ff))
    return LMCfg(name=name, vocab=vocab, d_model=d_model,
                 groups=(GroupCfg((blk,), layers),),
                 final_norm="rms" if norm == "rms" else "ln_np",
                 tie_embeddings=tie, remat=remat, n_prefix=n_prefix,
                 prefix_embed_dim=prefix_embed_dim)


def mamba_lm(name: str, *, layers: int, d_model: int, d_state: int,
             vocab: int, head_dim: int = 64, n_groups: int = 1,
             expand: int = 2, chunk: int = 128, remat: bool = False) -> LMCfg:
    blk = BlockCfg(
        d_model=d_model, mixer="ssm", ffn="none",
        ssm=SSMCfg(d_model, expand * d_model, head_dim=head_dim,
                   n_groups=n_groups, d_state=d_state, chunk=chunk))
    return LMCfg(name=name, vocab=vocab, d_model=d_model,
                 groups=(GroupCfg((blk,), layers),), tie_embeddings=True,
                 remat=remat)
