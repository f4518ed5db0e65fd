"""Serving steps (port of ``repro/serving/serve_step.py``): prefill (full
prompt forward, returns last-position logits) and serve_step (one new
token against the decode cache).

The batched-request engine (continuous batching, a page directory backed
by the HiStore hybrid index) is ``serving/engine.py``.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.models.transformer import (apply_model, decode_step,
                                            hidden_to_logits, init_cache)


@torch.no_grad()
def prefill(cfg, model, inputs):
    """Full-prompt forward, building no graph; returns float32 logits at
    the final position [B, V].  With ``cfg.ssm_impl="pallas"`` each Mamba-1 layer's scan is
    the fused kernel (``kernels/mamba_scan.py``)."""
    hidden, _ = apply_model(cfg, model, inputs)
    last = hidden[:, -1:]
    return hidden_to_logits(cfg, model, last)[:, 0]


def serve_step(cfg, model, cache, inputs):
    """One decode step: inputs {tokens [B,1] | embeds [B,1,D], pos [B]}.
    Returns (logits [B, V], new_cache)."""
    return decode_step(cfg, model, cache, inputs)


def make_serve_step(cfg):
    return functools.partial(serve_step, cfg)


def make_cache(cfg, batch: int, seq_len: int, *, device=None):
    return init_cache(cfg, batch, seq_len, device=device)
