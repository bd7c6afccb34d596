"""Architecture configuration (counterpart of ``repro/models/config.py``;
the fields the dense and moe families read)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe (the families ported so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    act: str = "silu"  # silu (SwiGLU) | gelu (GeGLU)
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    embed_scale: bool = False  # gemma multiplies embeddings by sqrt(d)

    # --- attention variant ---
    attn_kind: str = "gqa"  # gqa | mla
    # MLA (deepseek)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    d_expert: int = 0
    n_dense_layers: int = 0  # leading dense FFN layers (deepseek)
    d_ff_dense: int = 0  # FFN width of those leading dense layers
    router_fn: str = "softmax"  # softmax (v2) | sigmoid (v3)
    moe_impl: str = "dense"  # dense (all-experts) | ep (not ported)

    # --- MTP (deepseek v3) ---
    mtp_depth: int = 0

    # --- serving optimizations ---
    mla_absorb: bool = False  # weight-absorbed MLA attention

    dtype: str = "bfloat16"
    # activation checkpointing for the training path: none | full | dots
    remat: str = "none"

    @property
    def q_dim(self) -> int:
        if self.attn_kind == "mla":
            return self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def o_in_dim(self) -> int:
        if self.attn_kind == "mla":
            return self.n_heads * self.v_head_dim
        return self.n_heads * self.head_dim

    @property
    def attn_head_dim(self) -> int:
        """The head dim of the attention's q·k (MLA: nope + rope), which
        decides its route (``KernelContext.attention_plan``)."""
        if self.attn_kind == "mla":
            return self.qk_nope_dim + self.qk_rope_dim
        return self.head_dim

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU tests (the reference's sizes)."""
    if cfg.n_kv_heads == 0:
        kv_small = 0
    elif cfg.n_kv_heads == 1:
        kv_small = 1  # keep MQA character
    elif cfg.n_kv_heads == cfg.n_heads:
        kv_small = 4  # MHA
    else:
        kv_small = 2  # GQA
    small = dict(n_layers=min(cfg.n_layers, 2), d_model=64, n_heads=4,
                 n_kv_heads=kv_small, head_dim=16, d_ff=128, vocab_size=256,
                 dtype="float32")
    if cfg.attn_kind == "mla":
        small.update(q_lora_rank=32, kv_lora_rank=16, qk_rope_dim=8,
                     qk_nope_dim=8, v_head_dim=16)
    if cfg.n_experts:
        small.update(n_experts=8, moe_top_k=2, d_expert=32,
                     n_shared_experts=min(cfg.n_shared_experts, 1),
                     n_dense_layers=min(cfg.n_dense_layers, 1), d_ff_dense=128)
    if cfg.mtp_depth:
        small.update(mtp_depth=1)
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
