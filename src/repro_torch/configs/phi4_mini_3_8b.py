"""Phi-4-mini 3.8B — RoPE SwiGLU GQA. [arXiv:2412.08905; hf]

A copy of ``repro/configs/phi4_mini_3_8b.py``: 24 query heads over 8 KV
heads of 128, d_ff 8,192, a vocabulary of 200,064.  The reference models
it with a full rotary embedding and an untied head, where the published
model rotates part of each head and ties its embeddings; the port computes
what the reference computes.  Its K (3,072 and 8,192) is too wide for the
single fused kernel, so every QLinear takes the chained path, as
Phi-3-mini's do (``kernels/context.py``).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    act="silu",
    rope_theta=10000.0,
)
