"""zamba2-7b [hybrid]
81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64
— Mamba2 + shared attn blocks [arXiv:2411.15242; unverified]

Backbone: 81 Mamba-2 layers.  A single *weight-tied* attention+MLP block
(32 MHA heads, d_ff=14336) is invoked after every 6th mamba layer
(Zamba2-style shared block; the per-invocation LoRA deltas of the release
are omitted — noted in DESIGN.md).  Mamba2: d_inner=2*d_model=7168,
head_dim=64 (112 SSD heads), state=64, groups=16 (16 to divide the 16-way model axis).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    mamba_version=2,
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=16,
    shared_attn_every=6,
))
