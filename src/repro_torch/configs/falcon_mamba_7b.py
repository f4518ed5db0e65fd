"""falcon-mamba-7b [ssm]
64L d_model=4096 (attn-free) d_ff=0 vocab=65024, ssm_state=16 — mamba1 arch
[arXiv:2410.05355; unverified]

Pure Mamba-1: each layer is a single Mamba block (no attention, no separate
FFN — d_ff=0).  d_inner = 2*d_model = 8192, dt_rank = d_model/16 = 256,
conv kernel 4.  Constant-size recurrent state makes long_500k decode
in-scope (the flagship long-context arch for this assignment).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,            # unused (attn-free)
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=65024,
    mamba_version=1,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    tie_embeddings=True,
))
