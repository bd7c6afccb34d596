"""Architecture configuration (counterpart of ``repro/models/config.py``;
the fields the dense family reads)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense (the only family ported so far)
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
    dtype: str = "bfloat16"
    # activation checkpointing for the training path: none | full | dots
    remat: str = "none"

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU tests (the reference's sizes)."""
    if cfg.n_kv_heads == 1:
        kv_small = 1  # keep MQA character
    elif cfg.n_kv_heads == cfg.n_heads:
        kv_small = 4  # MHA
    else:
        kv_small = 2  # GQA
    small = dict(n_layers=min(cfg.n_layers, 2), d_model=64, n_heads=4,
                 n_kv_heads=kv_small, head_dim=16, d_ff=128, vocab_size=256,
                 dtype="float32")
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
