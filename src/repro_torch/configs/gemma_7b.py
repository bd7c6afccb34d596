"""Gemma-7B — GeGLU, head_dim=256, embed scaling. [arXiv:2403.08295; hf]

A copy of ``repro/configs/gemma_7b.py``.  Its 16 heads of 256 take the
dense flash kernels (D up to 256) for prefill; every
QLinear has K >= 3072 and takes the chained path (``kernels/context.py``).
The head reads the embedding (``tie_embeddings``): the parameters hold no
``lm_head``.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    act="gelu",
    rope_theta=10000.0,
    tie_embeddings=True,
    embed_scale=True,
)
