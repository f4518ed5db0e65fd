"""internvl2-76b [vlm]
80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256 — InternViT + InternLM2
[arXiv:2404.16821; unverified]

Per the assignment, the entry specifies the transformer BACKBONE only; the
InternViT modality frontend is a STUB: ``input_specs()`` provides precomputed
patch embeddings of shape (B, S, d_model).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    frontend="embed",
    rope_theta=1e6,
))
