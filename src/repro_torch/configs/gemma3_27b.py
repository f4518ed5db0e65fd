"""gemma3-27b [dense]
62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144 — 5:1 local:global, 128k
[hf:google/gemma-3-1b-pt; unverified]

5 sliding-window (1024) layers per 1 global layer.  Mostly-local attention
makes the arch sub-quadratic for long-context decode: local layers keep a
window-sized cache; only every 6th layer keeps the full-length cache.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    local_global_pattern=5,
    sliding_window=1024,
    rope_theta=1e6,
    tie_embeddings=True,
))
