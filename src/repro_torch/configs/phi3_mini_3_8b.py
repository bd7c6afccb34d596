"""Phi-3-mini 3.8B — RoPE SwiGLU (kv=32 i.e. MHA). [arXiv:2404.14219; unverified]

The paper's own primary evaluation model (Phi-3 mini-4k-instruct).  Its K
(3072 and 8192) is too wide for the single fused kernel, so every QLinear
takes the chained path (``kernels/context.py``).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    act="silu",
    rope_theta=10000.0,
)
