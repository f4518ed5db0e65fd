"""Decoder stack driven by ModelConfig (port of
``repro/models/transformer.py``).

``Model`` holds the embedding, the final norm and an ``nn.ModuleList`` of
blocks, one per layer in ``cfg.layer_specs()`` order.  The JAX package
stacks repeated layers into scanned stages to keep XLA's compile time
down; here ``apply_model`` and ``decode_step`` are a Python loop over
``model.layers``, and a decode cache is a list with one dict per layer.
The slice is forward-only: parameters carry no gradient, and ``remat``
stays a config field with nothing to do.

Ported blocks: ``Mamba1Block`` (``("mamba1", None)``, the falcon-mamba
family) and ``AttnBlock`` (``("attn", "mlp")`` and ``("local", "mlp")``,
the dense GQA family: mistral-nemo, command-r, gemma3, mistral-large,
internvl2's backbone and musicgen).  MLA, MoE, Mamba-2 and the shared
block raise NotImplementedError naming their ROADMAP.md item.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.client import _resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.layers import (
    embed_init, embed_lookup, lm_head_init, logits_from_hidden, mlp_apply,
    mlp_init, rmsnorm, rmsnorm_init,
)

F32 = torch.float32
MAMBA2_ITEM = "ROADMAP.md A3.2 (Mamba-2 and the shared block: zamba2)"
# the layer kinds still to port, by the ROADMAP.md item that ports them
UNPORTED = {"mamba2": MAMBA2_ITEM, "mamba2+shared": MAMBA2_ITEM,
            "mla": attn.MLA_ITEM, "moe": attn.MLA_ITEM}


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

    def forward(self, cfg, x, positions=None):
        h = rmsnorm(self.ln1, x, cfg.norm_eps)
        return x + ssm.mamba1_apply(cfg, self.mixer, h)

    def decode(self, cfg, x, pos, cache):
        h = rmsnorm(self.ln1, x, cfg.norm_eps)     # Mamba reads no position
        y, cache = ssm.mamba1_decode(cfg, self.mixer, h, cache)
        return x + y, cache


class AttnBlock(nn.Module):
    """One dense layer: RMSNorm, GQA (global, or sliding-window for the
    ``"local"`` spec), residual; RMSNorm, the SwiGLU MLP, residual.
    ``mixer`` holds ``wq``/``wk``/``wv``/``wo``, ``ffn`` ``wi``/``wg``/``wo``
    and ``ln1``/``ln2`` the norms' (1 + scale) parameters."""

    def __init__(self, cfg: ModelConfig, spec, generator, device):
        super().__init__()
        dt = cfg.param_dtype
        self.window = cfg.sliding_window if spec[0] == "local" else 0
        self.ln1 = _frozen(rmsnorm_init(cfg.d_model, device))
        self.mixer = nn.ParameterDict(
            {k: _frozen(v) for k, v in
             attn.attn_init(cfg, generator, device).items()})
        self.ln2 = _frozen(rmsnorm_init(cfg.d_model, device))
        self.ffn = nn.ParameterDict(
            {k: _frozen(v) for k, v in
             mlp_init(generator, cfg.d_model, cfg.d_ff, dt, device).items()})

    def forward(self, cfg, x, positions):
        h = rmsnorm(self.ln1, x, cfg.norm_eps)
        x = x + attn.gqa_apply(cfg, self.mixer, h, positions,
                               window=self.window)
        return x + mlp_apply(self.ffn, rmsnorm(self.ln2, x, cfg.norm_eps))

    def decode(self, cfg, x, pos, cache):
        h = rmsnorm(self.ln1, x, cfg.norm_eps)
        y, cache = attn.gqa_decode(cfg, self.mixer, h, pos, cache,
                                   window=self.window)
        x = x + y
        return (x + mlp_apply(self.ffn, rmsnorm(self.ln2, x, cfg.norm_eps)),
                cache)


PORTED = (("mamba1", None), ("attn", "mlp"), ("local", "mlp"))


def _check_ported(specs):
    """Raise NotImplementedError, naming its ROADMAP.md item, for the
    first layer spec this port cannot run yet."""
    for spec in specs:
        if spec not in PORTED:
            item = UNPORTED.get(spec[0]) or UNPORTED[spec[1]]
            raise NotImplementedError(
                f"the layer spec {spec!r} is not ported yet: {item}")


def _block(cfg, spec, generator, device):
    if spec == ("mamba1", None):
        return Mamba1Block(cfg, generator, device)
    return AttnBlock(cfg, spec, generator, device)


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
        _check_ported(specs)
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
            [_block(cfg, spec, generator, dev) for spec in specs])

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
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    for block in model.layers:
        x = block(cfg, x, positions)
    x = rmsnorm(model.final_norm, x, cfg.norm_eps)
    # the auxiliary loss is the MoE layers'; the ported layers add none
    return x, torch.zeros((), dtype=F32, device=x.device)


def hidden_to_logits(cfg, model, hidden):
    return logits_from_hidden(cfg, model, hidden)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *, device=None):
    """One cache dict per layer, on ``device`` (the card by default):
    Mamba-1 layers {conv, ssm}, attention layers {k, v, pos} (a local
    layer's ring holds min(sliding_window, seq_len) slots)."""
    specs = cfg.layer_specs()
    _check_ported(specs)
    dev = _resolve_device(device, "init_cache")
    return [ssm.mamba1_cache_init(cfg, batch, dev) if spec[0] == "mamba1"
            else attn.gqa_cache_init(
                cfg, batch, seq_len, dev,
                window=cfg.sliding_window if spec[0] == "local" else 0)
            for spec in specs]


@torch.no_grad()
def decode_step(cfg: ModelConfig, model: Model, cache, inputs):
    """One decode step.  inputs: {tokens [B,1] | embeds [B,1,D], pos [B]}.
    Returns (logits [B,V] float32, new cache)."""
    x = _frontend(cfg, model, inputs)
    pos = inputs["pos"]
    new_cache = []
    for block, c in zip(model.layers, cache):
        x, c = block.decode(cfg, x, pos, c)
        new_cache.append(c)
    x = rmsnorm(model.final_norm, x, cfg.norm_eps)
    return logits_from_hidden(cfg, model, x)[:, 0], new_cache


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
