"""Decoder stack driven by ModelConfig (port of
``repro/models/transformer.py``).

``Model`` holds the embedding, the final norm, an ``nn.ModuleList`` of
blocks, one per layer in ``cfg.layer_specs()`` order, and, for a config
with ``shared_attn_every``, the one weight-tied ``SharedBlock`` that
every ``"mamba2+shared"`` layer calls (``model.shared``: its weights are
held, and counted, once).  The JAX package stacks repeated layers into
scanned stages to keep XLA's compile time down; here ``apply_model`` and
``decode_step`` are a Python loop over ``model.layers``, and a decode
cache is a list with one dict per layer.  Parameters are built with
``requires_grad`` off, so that serving builds no graph; the train step
(``train/step.py``) switches it on.  ``apply_model`` under autograd with
``cfg.remat == "unit"`` checkpoints each layer: the JAX package
checkpoints each scanned pattern unit, and one layer is the port's unit
(the gradients are the same function).  ``decode_step`` runs under
``torch.no_grad``.

Blocks, by layer spec (mixer, ffn), for every config of
``repro_torch.configs``: ``Mamba1Block`` (``("mamba1", None)``,
falcon-mamba), ``Mamba2Block`` (``("mamba2", None)`` and
``("mamba2+shared", None)``, zamba2) and ``AttnBlock`` (a GQA, local or
MLA mixer with an MLP or MoE ffn: the dense family, deepseek-v2-lite's
MLA and kimi-k2's GQA with MoE).  A block's ``forward`` returns (x, its
MoE auxiliary loss or None), its ``decode`` (x, its new cache).

Over a (data x model) mesh of ranks (``train/dp.Ranks``) a ``Model`` is
built whole and cut to its rank's shard (``Model.cut_to``:
``sharding/partition.cut_model``); the layers then run on their slices
(``sharding/tp.py``) while ``sharding/context.use_dp`` holds the model
group.  ``init_cache`` with ``ranks`` gives the rank's rows and its cut
of each layer's cache.

Under FSDP (``cfg.fsdp`` over a data axis of more than one rank) the cut
also keeps only each parameter's data slice (``sharding/fsdp.py``), and a
layer gathers its block's parameters whole inside the checkpointed
function: the recompute gathers them again, in one order on every rank,
and the whole weights are not saved for the backward.  The weight-tied
shared block is gathered at each call, so its gradient sums over every
call.  Under the sequence cut (``current_seq()``) each rank runs its
block of the sequence, with the global positions.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.client import _resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models import ssm
from repro_torch.models.layers import (
    embed_init, embed_lookup, lm_head_init, logits_from_hidden, mlp_apply,
    mlp_init, rmsnorm, rmsnorm_init,
)
from repro_torch.sharding import fsdp

F32 = torch.float32
MIXERS = ("attn", "local", "mla", "mamba1", "mamba2", "mamba2+shared")


def _frozen(t) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _params(tree: dict) -> nn.ParameterDict:
    """A ParameterDict of frozen parameters from a dict of tensors, a
    nested dict becoming a nested ParameterDict (MoE's ``shared``)."""
    return nn.ParameterDict(
        {k: _params(v) if isinstance(v, dict) else _frozen(v)
         for k, v in tree.items()})


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
class Mamba1Block(nn.Module):
    """One falcon-mamba layer: RMSNorm, then the Mamba-1 mixer, residual.
    ``ln1`` is the norm's (1 + scale) parameter, ``mixer`` the mixer's
    parameters by the JAX package's names."""

    def __init__(self, cfg: ModelConfig, generator, device):
        super().__init__()
        self.ln1 = _frozen(rmsnorm_init(cfg.d_model, device))
        self.mixer = _params(ssm.mamba1_init(cfg, generator, device))

    def forward(self, cfg, x, positions=None, shared=None):
        h = rmsnorm(self.ln1, x, cfg.norm_eps)
        return x + ssm.mamba1_apply(cfg, self.mixer, h), None

    def decode(self, cfg, x, pos, cache, shared=None):
        h = rmsnorm(self.ln1, x, cfg.norm_eps)     # Mamba reads no position
        y, cache = ssm.mamba1_decode(cfg, self.mixer, h, cache)
        return x + y, cache


class SharedBlock(nn.Module):
    """Zamba2's weight-tied block: RMSNorm, global GQA, residual;
    RMSNorm, the SwiGLU MLP, residual.  ``attn`` holds
    ``wq``/``wk``/``wv``/``wo``, ``mlp`` ``wi``/``wg``/``wo``."""

    def __init__(self, cfg: ModelConfig, generator, device):
        super().__init__()
        dt = cfg.param_dtype
        self.ln1 = _frozen(rmsnorm_init(cfg.d_model, device))
        self.attn = _params(attn.attn_init(cfg, generator, device))
        self.ln2 = _frozen(rmsnorm_init(cfg.d_model, device))
        self.mlp = _params(mlp_init(generator, cfg.d_model, cfg.d_ff, dt,
                                    device))

    def forward(self, cfg, x, positions):
        h = rmsnorm(self.ln1, x, cfg.norm_eps)
        x = x + attn.gqa_apply(cfg, self.attn, h, positions)
        return x + mlp_apply(self.mlp, rmsnorm(self.ln2, x, cfg.norm_eps))

    def decode(self, cfg, x, pos, cache):
        h = rmsnorm(self.ln1, x, cfg.norm_eps)
        y, cache = attn.gqa_decode(cfg, self.attn, h, pos, cache)
        x = x + y
        return (x + mlp_apply(self.mlp, rmsnorm(self.ln2, x, cfg.norm_eps)),
                cache)


class Mamba2Block(nn.Module):
    """One zamba2 layer: RMSNorm, the Mamba-2 mixer, residual; a
    ``"mamba2+shared"`` layer then runs the model's ``SharedBlock``
    (passed in as ``shared``).  Its decode cache is the mixer's
    {conv_x, conv_B, conv_C, ssm}, or {"mamba": that, "shared": the
    shared attention's {k, v, pos}} for a shared layer."""

    def __init__(self, cfg: ModelConfig, spec, generator, device):
        super().__init__()
        self.calls_shared = spec[0] == "mamba2+shared"
        self.ln1 = _frozen(rmsnorm_init(cfg.d_model, device))
        self.mixer = _params(ssm.mamba2_init(cfg, generator, device))

    def forward(self, cfg, x, positions, shared=None):
        h = rmsnorm(self.ln1, x, cfg.norm_eps)
        x = x + ssm.mamba2_apply(cfg, self.mixer, h)
        if self.calls_shared:
            x = shared(cfg, x, positions)
        return x, None

    def decode(self, cfg, x, pos, cache, shared=None):
        h = rmsnorm(self.ln1, x, cfg.norm_eps)
        mcache = cache["mamba"] if self.calls_shared else cache
        y, mcache = ssm.mamba2_decode(cfg, self.mixer, h, mcache)
        x = x + y
        if not self.calls_shared:
            return x, mcache
        x, scache = shared.decode(cfg, x, pos, cache["shared"])
        return x, {"mamba": mcache, "shared": scache}


class AttnBlock(nn.Module):
    """One attention layer: RMSNorm, the mixer (GQA, global or
    sliding-window for the ``"local"`` spec, or MLA), residual; RMSNorm,
    the ffn (the SwiGLU MLP or the MoE), residual.  ``mixer`` holds the
    attention weights, ``ffn`` the MLP's ``wi``/``wg``/``wo`` or the MoE's
    ``router``/``e_wi``/``e_wg``/``e_wo`` (and ``shared``), and
    ``ln1``/``ln2`` the norms' (1 + scale) parameters."""

    def __init__(self, cfg: ModelConfig, spec, generator, device):
        super().__init__()
        mixer, ffn = spec
        dt = cfg.param_dtype
        self.mla = mixer == "mla"
        self.moe = ffn == "moe"
        self.window = cfg.sliding_window if mixer == "local" else 0
        self.ln1 = _frozen(rmsnorm_init(cfg.d_model, device))
        self.mixer = _params(attn.attn_init(
            cfg, generator, device, "mla" if self.mla else "gqa"))
        self.ln2 = _frozen(rmsnorm_init(cfg.d_model, device))
        self.ffn = _params(
            moe.moe_init(cfg, generator, device) if self.moe else
            mlp_init(generator, cfg.d_model, cfg.d_ff, dt, device))

    def _ffn(self, cfg, x):
        h = rmsnorm(self.ln2, x, cfg.norm_eps)
        if self.moe:
            y, aux = moe.moe_apply(cfg, self.ffn, h)
            return x + y, aux
        return x + mlp_apply(self.ffn, h), None

    def forward(self, cfg, x, positions, shared=None):
        h = rmsnorm(self.ln1, x, cfg.norm_eps)
        if self.mla:
            x = x + attn.mla_apply(cfg, self.mixer, h, positions)
        else:
            x = x + attn.gqa_apply(cfg, self.mixer, h, positions,
                                   window=self.window)
        return self._ffn(cfg, x)

    def decode(self, cfg, x, pos, cache, shared=None):
        h = rmsnorm(self.ln1, x, cfg.norm_eps)
        if self.mla:
            y, cache = attn.mla_decode(cfg, self.mixer, h, pos, cache)
        else:
            y, cache = attn.gqa_decode(cfg, self.mixer, h, pos, cache,
                                       window=self.window)
        return self._ffn(cfg, x + y)[0], cache


def _check_spec(spec):
    """JAX's ``_block_init`` raises ValueError on a mixer it does not
    know; so does the port."""
    if spec[0] not in MIXERS:
        raise ValueError(f"unknown layer spec {spec!r}")


def _block(cfg, spec, generator, device):
    _check_spec(spec)
    if spec[0] == "mamba1":
        return Mamba1Block(cfg, generator, device)
    if spec[0].startswith("mamba2"):
        return Mamba2Block(cfg, spec, generator, device)
    return AttnBlock(cfg, spec, generator, device)


# ---------------------------------------------------------------------------
# Whole model
# ---------------------------------------------------------------------------
class Model(nn.Module):
    """The embedding (or an untied ``lm_head``), the final norm and one
    block per layer, built with random weights from ``generator`` on
    ``device``: the card unless the caller names another device.  With no
    generator, one seeded with 0 on that device.  A config with
    ``shared_attn_every`` also holds the weight-tied ``shared`` block."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        specs = cfg.layer_specs()
        for spec in specs:
            _check_spec(spec)
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
        self.shared = (SharedBlock(cfg, generator, dev)
                       if cfg.shared_attn_every else None)
        self.layers = nn.ModuleList(
            [_block(cfg, spec, generator, dev) for spec in specs])
        self.model_group = self.data_group = None

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def cut_to(self, ranks) -> list:
        """Cut the weights in place to ``ranks``' model index's slices
        (``sharding/partition.cut_model``) and, under ``cfg.fsdp`` over a
        data axis of more than one rank, to their data slices
        (``sharding/fsdp.plan``), freeing the whole; returns each leaf's
        model cut dim in ``convert.param_tree`` order (None: whole)."""
        from repro_torch.convert import param_tree
        from repro_torch.pytree import leaves
        from repro_torch.sharding.partition import cut_model
        self.model_dims = cut_model(self, self.cfg, ranks.mesh,
                                    ranks.model.rank)
        self.model_group = ranks.model
        data = getattr(ranks, "data", None)
        if self.cfg.fsdp and data is not None and data.world > 1:
            tree = param_tree(self, self.cfg)
            _, _, views, owners = fsdp.plan(self.cfg, tree, data.world,
                                            data.rank, ranks.model.world,
                                            self.model_dims)
            fsdp.cut(leaves(tree), views, owners)
            self.data_group = data
        return self.model_dims

    def forward(self, inputs):
        return apply_model(self.cfg, self, inputs)


def init_params(cfg: ModelConfig, generator=None, *, device=None) -> Model:
    """A ``Model`` with random weights (the JAX ``init_params``)."""
    return Model(cfg, device=device, generator=generator)


def _frontend(cfg, model, inputs, table=None):
    if cfg.frontend == "token":
        key = "tokens" if "tokens" in inputs else "token"
        return embed_lookup(fsdp.whole(model.embed) if table is None
                            else table, inputs[key])
    return inputs["embeds"]


def _groups(model):
    """The model group of a cut model, and the data group its parameters
    are cut over, for a forward the caller has not put under ``use_dp``
    (a decode, a prefill or the logits; the train step sets them for the
    loss and its gradient)."""
    import contextlib

    from repro_torch.sharding.context import (current_dp, current_fsdp,
                                              current_model, current_seq,
                                              use_dp)
    g = getattr(model, "model_group", None)
    d = getattr(model, "data_group", None)
    if ((g is None or current_model() is not None)
            and (d is None or current_fsdp() is not None)):
        return contextlib.nullcontext()
    return use_dp(current_dp(), current_model() or g,
                  fsdp=current_fsdp() or d, seq=current_seq() is not None)


def apply_model(cfg: ModelConfig, model: Model, inputs, table=None):
    """Train/prefill forward.  Returns (hidden [B,S,D], aux_loss).
    ``table``: the embedding table gathered whole (the loss gathers a
    tied table once for the embedding and the head)."""
    with _groups(model):
        return _apply(cfg, model, inputs, table)


def _apply(cfg, model, inputs, table=None):
    x = _frontend(cfg, model, inputs, table)
    B, S, _ = x.shape
    positions = (torch.arange(S, device=x.device)
                 + fsdp.seq_offset(S)).expand(B, S)
    aux_total = torch.zeros((), dtype=F32, device=x.device)
    for block in model.layers:
        x, aux_total = layer_step(cfg, block, x, positions, model.shared,
                                  aux_total)
    x = rmsnorm(model.final_norm, x, cfg.norm_eps)
    return x, aux_total


def _run_block(block, cfg, x, positions, shared):
    """The block, its parameters cut over data gathered whole for the
    call, and the shared block's at each of its calls."""
    if shared is not None:
        shared = functools.partial(fsdp.call, shared)
    return fsdp.call(block, cfg, x, positions, shared)


def layer_step(cfg, block, x, positions, shared, aux_total):
    """One layer of ``apply_model``: the block (checkpointed under
    autograd with ``cfg.remat == "unit"``, the FSDP gathers inside),
    its MoE loss added to ``aux_total``.  Returns (x, aux_total)."""
    if cfg.remat == "unit" and torch.is_grad_enabled():
        x, aux = checkpoint(_run_block, block, cfg, x, positions, shared,
                            use_reentrant=False)
    else:
        x, aux = _run_block(block, cfg, x, positions, shared)
    if aux is not None:                      # the MoE layers' losses
        aux_total = aux_total + aux
    return x, aux_total


def hidden_to_logits(cfg, model, hidden):
    """hidden [B, T, D] -> float32 logits [B, T, V], over the groups of
    a cut model (``logits_from_hidden``)."""
    with _groups(model):
        return logits_from_hidden(cfg, model, hidden)


def _block_cache_init(cfg, spec, batch, seq_len, dev, r=0, m=1,
                      seq=False):
    mixer = spec[0]
    if mixer in ("attn", "local"):
        window = cfg.sliding_window if mixer == "local" else 0
        return attn.gqa_cache_init(
            cfg, batch, seq_len, dev, window=window,
            **attn.gqa_cache_layout(cfg, seq_len, window, r, m, seq))
    if mixer == "mla":
        return attn.mla_cache_init(cfg, batch, seq_len, dev)
    if mixer == "mamba1":
        return ssm.mamba1_cache_init(cfg, batch, dev, ssm.cache_parts(cfg, m))
    if mixer == "mamba2":
        return ssm.mamba2_cache_init(cfg, batch, dev, ssm.cache_parts(cfg, m))
    if mixer == "mamba2+shared":
        return {"mamba": ssm.mamba2_cache_init(cfg, batch, dev,
                                               ssm.cache_parts(cfg, m)),
                "shared": attn.gqa_cache_init(
                    cfg, batch, seq_len, dev,
                    **attn.gqa_cache_layout(cfg, seq_len, 0, r, m, seq))}
    raise ValueError(f"unknown layer spec {spec!r}")


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *, device=None,
               ranks=None):
    """One cache dict per layer, on ``device`` (the card by default), as
    JAX's ``init_cache`` gives it: Mamba-1 {conv, ssm}; Mamba-2 {conv_x,
    conv_B, conv_C, ssm}, and for a shared layer {"mamba": that, "shared":
    {k, v, pos} of ``seq_len`` slots}; GQA {k, v, pos} (a local layer's
    ring holds min(sliding_window, seq_len) slots); MLA {ckv, k_rope,
    pos}.  With ``ranks`` (a ``train/dp.Ranks`` whose model index's cut
    the model holds) the rank's rows of the batch and its cut of each
    cache: the channels and heads the layers' cut weights run, or, under
    ``use_mesh`` with ``cfg.decode_cache_hint`` where the batch divides
    over data, a GQA cache's slots over the model axis."""
    dev = _resolve_device(device, "init_cache")
    r, m, seq = 0, 1, False
    if ranks is not None:
        from repro_torch.sharding.context import get_mesh
        rows = ranks.data.rows(batch)
        seq = (get_mesh() is not None and cfg.decode_cache_hint
               and ranks.data.shards(batch))
        batch = rows.stop - rows.start
        r, m = ranks.model.rank, ranks.model.world
    return [_block_cache_init(cfg, spec, batch, seq_len, dev, r, m, seq)
            for spec in cfg.layer_specs()]


@torch.no_grad()
def decode_step(cfg: ModelConfig, model: Model, cache, inputs):
    """One decode step.  inputs: {tokens [B,1] | embeds [B,1,D], pos [B]}.
    Returns (logits [B,V] float32, new cache).  On a model cut over data
    (FSDP) each layer's parameters are gathered for its call; where the
    caller has split the batch's rows over the data group, it puts the
    call under ``use_dp(ranks.data)``, so that the MoE plans over the
    global tokens, as JAX's does."""
    with _groups(model):
        return _decode(cfg, model, cache, inputs)


def _decode(cfg, model, cache, inputs):
    x = _frontend(cfg, model, inputs)
    pos = inputs["pos"]
    new_cache = []
    with fsdp.gathered(model.shared):
        for block, c in zip(model.layers, cache):
            with fsdp.gathered(block):
                x, c = block.decode(cfg, x, pos, c, model.shared)
            new_cache.append(c)
    x = rmsnorm(model.final_norm, x, cfg.norm_eps)
    return logits_from_hidden(cfg, model, x)[:, 0], new_cache


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
