"""deepseek-v2-lite-16b [moe]
27L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400, MoE 64e top-6
— MLA kv_lora=512, 2 shared + routed top-6 [arXiv:2405.04434; hf]

Notes vs the assignment line: the line says "2 shared+160 routed top-6" in
the free-text but "MoE 64e top-6" in the structured spec; the published
V2-Lite config is 64 routed experts (160 is the full V2).  We follow the
structured spec: 64 routed, top-6, 2 shared, expert d_ff=1408.
MLA: kv_lora_rank=512, qk_nope=128, qk_rope=64, v_head=128, no q-lora.
First layer uses a dense MLP (d_ff = 10944 in the release; we use the
assignment's structured d_ff for experts and 8*1408 for the dense layer).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=11264,            # dense first layer: 8 * 1408
    vocab_size=102400,
    attn_kind="mla",
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    head_dim=192,          # qk_nope + qk_rope
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    first_k_dense=1,
    rope_theta=1e4,
))
