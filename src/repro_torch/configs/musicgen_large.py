"""musicgen-large [audio]
48L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=2048 — decoder-only over
EnCodec tokens [arXiv:2306.05284; hf]

The backbone is a plain decoder-only transformer over EnCodec codebook
tokens (vocab 2048).  The EnCodec encoder/decoder and the 4-codebook delay
pattern are modality-frontend concerns and are STUBBED at the data layer:
inputs are already flattened token ids.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,   # MHA (kv=32)
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    rope_theta=1e4,
))
