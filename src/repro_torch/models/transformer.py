"""Decoder stack driven by ModelConfig (port of
``repro/models/transformer.py``).

``Model`` holds the embedding, the final norm and an ``nn.ModuleList`` of
blocks, one per layer in ``cfg.layer_specs()`` order.  The JAX package
stacks repeated layers into scanned stages to keep XLA's compile time
down; here ``apply_model`` and ``decode_step`` are a Python loop over
``model.layers``, and a decode cache is a list with one dict per layer.
The slice is forward-only: parameters carry no gradient, and ``remat``
stays a config field with nothing to do.

Only the Mamba-1 block (``("mamba1", None)``, the falcon-mamba family) is
ported.  Every other mixer or ffn raises NotImplementedError naming its
ROADMAP.md item.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.client import _resolve_device
from repro_torch.models import ssm
from repro_torch.models.layers import (
    embed_init, embed_lookup, lm_head_init, logits_from_hidden, rmsnorm,
    rmsnorm_init,
)

F32 = torch.float32
MODELS_ITEM = ("ROADMAP.md item 16 (attention, MoE, Mamba-2 and the "
               "shared block of the other model families)")


def _unported(what) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: {MODELS_ITEM}")


def _frozen(t) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------------------
# Single block
# ---------------------------------------------------------------------------
class Mamba1Block(nn.Module):
    """One falcon-mamba layer: RMSNorm, then the Mamba-1 mixer, residual.
    ``ln1`` is the norm's (1 + scale) parameter, ``mixer`` the mixer's
    parameters by the JAX package's names."""

    def __init__(self, cfg: ModelConfig, generator, device):
        super().__init__()
        self.ln1 = _frozen(rmsnorm_init(cfg.d_model, device))
        self.mixer = nn.ParameterDict(
            {k: _frozen(v) for k, v in
             ssm.mamba1_init(cfg, generator, device).items()})

    def forward(self, cfg, x):
        h = rmsnorm(self.ln1, x, cfg.norm_eps)
        return x + ssm.mamba1_apply(cfg, self.mixer, h)

    def decode(self, cfg, x, cache):
        h = rmsnorm(self.ln1, x, cfg.norm_eps)
        y, cache = ssm.mamba1_decode(cfg, self.mixer, h, cache)
        return x + y, cache


def _mamba1_only(specs):
    """The layer specs this slice runs; any other raises."""
    for spec in specs:
        if spec != ("mamba1", None):
            raise _unported(f"the layer spec {spec!r}")


# ---------------------------------------------------------------------------
# Whole model
# ---------------------------------------------------------------------------
class Model(nn.Module):
    """The embedding (or an untied ``lm_head``), the final norm and one
    block per layer, built with random weights from ``generator`` on
    ``device``: the card unless the caller names another device.  With no
    generator, one seeded with 0 on that device."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        specs = cfg.layer_specs()
        _mamba1_only(specs)
        dev = _resolve_device(device, "Model")
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self.cfg = cfg
        dt = cfg.param_dtype
        if cfg.frontend == "token" or cfg.tie_embeddings:
            self.embed = _frozen(embed_init(generator, cfg.vocab_size,
                                            cfg.d_model, dt, dev))
        if not cfg.tie_embeddings:
            self.lm_head = _frozen(lm_head_init(generator, cfg.d_model,
                                                cfg.vocab_size, dt, dev))
        self.final_norm = _frozen(rmsnorm_init(cfg.d_model, dev))
        self.layers = nn.ModuleList(
            [Mamba1Block(cfg, generator, dev) for _ in specs])

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def forward(self, inputs):
        return apply_model(self.cfg, self, inputs)


def init_params(cfg: ModelConfig, generator=None, *, device=None) -> Model:
    """A ``Model`` with random weights (the JAX ``init_params``)."""
    return Model(cfg, device=device, generator=generator)


def _frontend(cfg, model, inputs):
    if cfg.frontend == "token":
        key = "tokens" if "tokens" in inputs else "token"
        return embed_lookup(model.embed, inputs[key])
    return inputs["embeds"]


@torch.no_grad()
def apply_model(cfg: ModelConfig, model: Model, inputs):
    """Prefill forward.  Returns (hidden [B,S,D], aux_loss)."""
    x = _frontend(cfg, model, inputs)
    for block in model.layers:
        x = block(cfg, x)
    x = rmsnorm(model.final_norm, x, cfg.norm_eps)
    # the auxiliary loss is the MoE layers'; Mamba-1 layers add none
    return x, torch.zeros((), dtype=F32, device=x.device)


def hidden_to_logits(cfg, model, hidden):
    return logits_from_hidden(cfg, model, hidden)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *, device=None):
    """One cache dict per layer, on ``device`` (the card by default)."""
    specs = cfg.layer_specs()
    _mamba1_only(specs)
    dev = _resolve_device(device, "init_cache")
    return [ssm.mamba1_cache_init(cfg, batch, dev) for _ in specs]


@torch.no_grad()
def decode_step(cfg: ModelConfig, model: Model, cache, inputs):
    """One decode step.  inputs: {tokens [B,1] | embeds [B,1,D], pos [B]}.
    Returns (logits [B,V] float32, new cache)."""
    x = _frontend(cfg, model, inputs)
    new_cache = []
    for block, c in zip(model.layers, cache):
        x, c = block.decode(cfg, x, c)     # Mamba reads no position
        new_cache.append(c)
    x = rmsnorm(model.final_norm, x, cfg.norm_eps)
    return logits_from_hidden(cfg, model, x)[:, 0], new_cache


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
