"""command-r-35b [dense]
40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000 — GQA, no-bias
[hf:CohereForAI/c4ai-command-r-v01; unverified]

Note: vocab 256000 is not divisible by the 16-way model axis; we round up to
256016? No — we keep the published 256000 and shard the vocab over the model
axis only when divisible; 256000 = 16 * 16000, so it divides cleanly.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
    rope_theta=1e4,
    tie_embeddings=True,   # Command-R ties input/output embeddings
))
