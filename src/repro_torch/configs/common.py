"""Shared builders for the architecture configs (port of
``repro.configs.common``): the dense, DeepSeek (MLA + MoE), Mamba2 and
Zamba2 (hybrid) LMs."""
from __future__ import annotations

from typing import Optional

from repro_torch.models.blocks import BlockCfg
from repro_torch.models.lm import GroupCfg, LMCfg
from repro_torch.nn.attention import AttnCfg
from repro_torch.nn.mla import MLACfg
from repro_torch.nn.mlp import MLPCfg
from repro_torch.nn.moe import MoECfg
from repro_torch.nn.rotary import YaRN
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


def deepseek_lm(name: str, *, layers: int, dense_layers: int, d_model: int,
                n_heads: int, vocab: int, moe_d_ff: int, dense_d_ff: int,
                n_experts: int, top_k: int, n_shared: int,
                kv_lora_rank: int = 512, q_lora_rank: int = 1536,
                qk_nope_dim: int = 128, qk_rope_dim: int = 64,
                v_head_dim: int = 128, mtp: bool = False,
                window: Optional[int] = None, remat: bool = False,
                capacity_factor: float = 1.25,
                rope_scaling: Optional[YaRN] = None,
                router: Optional[dict] = None) -> LMCfg:
    """A DeepSeek-V2/V3 decoder: ``dense_layers`` MLA + dense MLP layers,
    then MLA + MoE layers.  ``rope_scaling``: MLA's YaRN; ``router``:
    further ``MoECfg`` fields (the router's options, an expert share)."""
    mla = MLACfg(d_model, n_heads, q_lora_rank=q_lora_rank,
                 kv_lora_rank=kv_lora_rank, qk_nope_dim=qk_nope_dim,
                 qk_rope_dim=qk_rope_dim, v_head_dim=v_head_dim,
                 window=window, rope_scaling=rope_scaling)
    dense_blk = BlockCfg(d_model=d_model, mixer="mla", ffn="mlp", mla=mla,
                         mlp=MLPCfg(d_model, dense_d_ff))
    moe_blk = BlockCfg(d_model=d_model, mixer="mla", ffn="moe", mla=mla,
                       moe=MoECfg(d_model, moe_d_ff, n_experts=n_experts,
                                  top_k=top_k, n_shared=n_shared,
                                  capacity_factor=capacity_factor,
                                  **(router or {})))
    return LMCfg(name=name, vocab=vocab, d_model=d_model,
                 groups=(GroupCfg((dense_blk,), dense_layers),
                         GroupCfg((moe_blk,), layers - dense_layers)),
                 tie_embeddings=False, mtp=mtp, remat=remat)


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


def zamba_lm(name: str, *, mamba_per_cycle: int, cycles: int,
             tail_mamba: int, d_model: int, d_state: int, n_heads: int,
             n_kv_heads: int, d_ff: int, vocab: int, head_dim: int = 64,
             n_groups: int = 2, chunk: int = 128,
             remat: bool = False) -> LMCfg:
    """Zamba2-style hybrid: cycles of (mamba_per_cycle × Mamba2 + 1 shared
    attention block) followed by a tail of Mamba2 blocks.  The attention
    block's parameters are shared across cycle repeats; its KV caches stay
    per occurrence."""
    ssm = SSMCfg(d_model, 2 * d_model, head_dim=head_dim, n_groups=n_groups,
                 d_state=d_state, chunk=chunk)
    m_blk = BlockCfg(d_model=d_model, mixer="ssm", ffn="none", ssm=ssm)
    a_blk = BlockCfg(
        d_model=d_model, mixer="attn", ffn="mlp", shared=True,
        attn=AttnCfg(d_model, n_heads, n_kv_heads, d_model // n_heads),
        mlp=MLPCfg(d_model, d_ff))
    groups = [GroupCfg((m_blk,) * mamba_per_cycle + (a_blk,), cycles)]
    if tail_mamba:
        groups.append(GroupCfg((m_blk,), tail_mamba))
    return LMCfg(name=name, vocab=vocab, d_model=d_model,
                 groups=tuple(groups), tie_embeddings=True, remat=remat)
