"""DeepSeek-V3 671B — MLA + MoE 256 routed top-8, 1 shared, MTP.
[arXiv:2412.19437; hf]

A copy of ``repro/configs/deepseek_v3_671b.py``: the sigmoid router and
the multi-token-prediction block (``params["mtp"]``), trained through
``model.loss_fn``'s MTP term (``deepseek.mtp_logits``: 0.3 · CE of the
t → t+2 predictions) and not run in serving, as in the reference.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=2048,            # routed-expert width (spec)
    vocab_size=129280,
    act="silu",
    rope_theta=10000.0,
    attn_kind="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    n_experts=256,
    n_shared_experts=1,
    moe_top_k=8,
    d_expert=2048,
    n_dense_layers=3,
    d_ff_dense=18432,
    router_fn="sigmoid",
    mtp_depth=1,
)
