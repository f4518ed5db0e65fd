"""kimi-k2-1t-a32b [moe]
61L d_model=7168 64H (GQA kv=8) d_ff=2048 vocab=163840, MoE 384e top-8
— Kimi K2, trillion-param MoE (paper-table) [arXiv:2501.kimi2; unverified]

We follow the assignment's structured spec verbatim: GQA (64H, kv=8),
384 routed experts with expert d_ff=2048, top-8 routing, 1 shared expert,
first layer dense (d_ff dense = 8*2048).  (The public K2 uses MLA; the
assignment pins GQA kv=8, which we honor — noted in DESIGN.md.)
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,            # dense first layer: 8 * 2048
    vocab_size=163840,
    n_experts=384,
    n_shared_experts=1,
    top_k=8,
    moe_d_ff=2048,
    first_k_dense=1,
    rope_theta=5e4,
    fsdp=True,             # 1T params require param sharding over data axis
))
