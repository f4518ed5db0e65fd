"""Reduced same-family configs for smoke tests (port of
``repro/configs/tiny.py``).

Each assigned architecture gets a scaled-down twin: same layer pattern /
mixer kinds / routing structure, small widths.  Used by
tests/test_torch_models.py and tests/test_torch_serving.py.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.configs import get_config


def tiny_config(arch: str, **extra) -> ModelConfig:
    cfg = get_config(arch)
    kw: dict = dict(
        d_model=64, n_heads=4, n_kv_heads=4 if cfg.n_kv_heads == cfg.n_heads else 2,
        head_dim=16, d_ff=128 if cfg.d_ff else 0, vocab_size=256,
        attn_q_block=8, attn_kv_block=8, ssm_chunk=8,
        dtype="float32",
    )
    # layer counts small but pattern-preserving
    if cfg.local_global_pattern:
        kw.update(n_layers=8, local_global_pattern=3, sliding_window=8)
    elif cfg.shared_attn_every:
        kw.update(n_layers=7, shared_attn_every=3)
    elif cfg.first_k_dense:
        kw.update(n_layers=3)
    else:
        kw.update(n_layers=2)
    if cfg.n_experts:
        kw.update(n_experts=8, top_k=2, moe_d_ff=32,
                  n_shared_experts=min(cfg.n_shared_experts, 1) or 0)
    if cfg.attn_kind == "mla":
        kw.update(kv_lora_rank=16, qk_rope_dim=8, qk_nope_dim=16,
                  v_head_dim=16, head_dim=24)
    if cfg.mamba_version:
        kw.update(ssm_state=8, ssm_expand=2, ssm_head_dim=8, ssm_groups=2)
    kw.update(extra)
    return cfg.scaled(**kw)
