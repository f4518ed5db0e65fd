"""Shared primitive layers: RMSNorm, RoPE, SwiGLU MLP, embeddings (port of
``repro/models/layers.py``).

Plain functions on tensors.  Weights are stored in the config's dtype and
the JAX package's layouts (``[d_in, d_out]`` projections, a ``[V, D]``
embedding table); norms and their sums are float32.  A matmul of two bf16
tensors on the card accumulates in float32 (cuBLAS) and rounds the result
to bf16, as the JAX package's ``dot`` does with ``preferred_element_type``.

Initialisers draw from an explicit ``torch.Generator`` straight into the
target dtype on the target device (no float32 or host copy), so a
full-width model is built on the card.  They do not give the JAX
package's numbers: tests carry weights across with ``convert.py``.

Over the model axis (``sharding/tp.py``) the MLP is Megatron's:
``wi`` and ``wg`` column-cut, ``wo`` row-cut, one all-reduce; the
embedding's vocab rows are cut (a masked lookup, then an all-reduce),
and so are the head's vocab columns (``logits_local``; the tied head is
the embedding's transpose, cut the same way).  Under FSDP the embedding
and the head are gathered whole over data (``head_table``): the train
step gathers the head once, outside its loss chunks, and a tied table
once for both of its uses, so that its gradient is reduce-scattered
once, summed.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.sharding import fsdp, tp

F32 = torch.float32


def normal(shape, scale: float, dtype, generator, device):
    """N(0, scale^2) draws of ``shape`` in ``dtype`` on ``device``."""
    t = torch.empty(shape, dtype=dtype, device=device)
    t.normal_(0.0, 1.0, generator=generator)
    return t.mul_(scale)


def dot(x, w):
    """Matmul with fp32 accumulation, result in x.dtype."""
    return torch.matmul(x, w.to(x.dtype))


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
def rmsnorm_init(d: int, device) -> torch.Tensor:
    return torch.zeros((d,), dtype=F32, device=device)  # (1+scale) form


def rmsnorm(scale, x, eps: float):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * (1.0 + scale)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=F32, device=device)
                            / half))


def apply_rope(x, positions, theta: float):
    """x: [..., T, H, hd]; positions: broadcastable to [..., T]."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)             # [hd/2]
    ang = positions.float()[..., None] * inv          # [..., T, hd/2]
    cos = torch.cos(ang)[..., None, :]                # [..., T, 1, hd/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------
def mlp_init(generator, d_model: int, d_ff: int, dtype, device) -> dict:
    s_in = d_model ** -0.5
    s_ff = d_ff ** -0.5
    return {
        "wi": normal((d_model, d_ff), s_in, dtype, generator, device),
        "wg": normal((d_model, d_ff), s_in, dtype, generator, device),
        "wo": normal((d_ff, d_model), s_ff, dtype, generator, device),
    }


def mlp_apply(params, x):
    if tp.cut(params["wo"]) is not None:
        xc = tp.copy(x)
        h = dot(xc, params["wi"])
        g = dot(xc, params["wg"])
        h = h * F.silu(g.float()).to(h.dtype)
        return tp.reduce(dot(h, params["wo"]))
    h = dot(x, params["wi"])
    g = dot(x, params["wg"])
    h = h * F.silu(g.float()).to(h.dtype)
    return dot(h, params["wo"])


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------
def embed_init(generator, vocab: int, d_model: int, dtype, device):
    return normal((vocab, d_model), d_model ** -0.5, dtype, generator, device)


def embed_lookup(table, tokens):
    """The table's rows; ``F.embedding``, whose gradient adds each row's
    contributions in a fixed order on the CPU (indexing's does not)."""
    if tp.cut(table) is None:
        return F.embedding(tokens.long(), table)
    r, _ = tp.rank_parts()
    n = table.shape[0]
    local = tokens.long() - r * n
    mine = (local >= 0) & (local < n)
    rows = F.embedding(torch.where(mine, local, 0), table)
    return tp.reduce(torch.where(mine[..., None], rows, 0))


def lm_head_init(generator, d_model: int, vocab: int, dtype, device):
    return normal((d_model, vocab), d_model ** -0.5, dtype, generator, device)


def logits_from_hidden(cfg, model, x):
    """x: [B, T, D] -> float32 logits [B, T, V] (the tied embedding's
    transpose, or the untied ``[D, V]`` head), products summed in float32
    as the JAX package's ``preferred_element_type=F32`` does."""
    logits, sliced = logits_local(cfg, model, x)
    return tp.gather(logits, -1) if sliced else logits


def head_table(cfg, model):
    """The head's table, gathered whole over data where FSDP cuts it:
    the embedding's where the two are tied, else ``lm_head``."""
    return fsdp.whole(model.embed if cfg.tie_embeddings else model.lm_head)


def logits_local(cfg, model, x, w=None):
    """(this rank's vocab columns of the float32 logits, whether they
    are a slice): the whole logits where the head is whole.  ``w``: the
    head's table as ``head_table`` gives it (gathered here if None)."""
    w = head_table(cfg, model) if w is None else w
    sliced = tp.cut(w) is not None
    w = w.t() if cfg.tie_embeddings else w
    return torch.matmul((tp.copy(x) if sliced else x).float(),
                        w.float()), sliced
