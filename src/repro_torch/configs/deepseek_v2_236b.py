"""DeepSeek-V2 236B — MLA (kv_lora=512) + MoE 160 routed top-6, 2 shared.
[arXiv:2405.04434; hf]

A copy of ``repro/configs/deepseek_v2_236b.py``.  The moe family serves in
the engine's per-slot mode (B=1 contiguous latent caches).  Of its
QLinears only MLA's ``wkv_b`` (K 512) fits the single fused kernel; every
other site (K 1536 / 5120 / 12,288 / 16,384) takes the chained path
(``kernels/context.py``).  MLA's 128 heads of D 192 / Dv 128 attend
through the dense flash kernel (#7) on the card.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=1536,            # routed-expert width (spec)
    vocab_size=102400,
    act="silu",
    rope_theta=10000.0,
    attn_kind="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    n_experts=160,
    n_shared_experts=2,
    moe_top_k=6,
    d_expert=1536,
    n_dense_layers=1,
    d_ff_dense=12288,
    router_fn="softmax",
)
