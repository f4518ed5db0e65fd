"""Training step: blockwise cross-entropy loss + AdamW update (port of
``repro/train/step.py``).

The LM-head matmul and softmax run over sequence chunks of
``LOSS_CHUNK``, each under ``torch.utils.checkpoint`` (the JAX package's
``jax.checkpoint``), so the [B, S, V] logits are never held at once.
The gradients are those of the whole loss with respect to the model's
parameters, in ``convert.param_tree``'s layout, and AdamW runs over that
tree (``optim/adamw.py``).

Every family trains: the dense GQA family (local attention, the token
and embed frontends), Mamba-1 with the chunked scan, Mamba-2 with the
weight-tied shared block (its gradient sums over every layer that calls
it), MLA and the MoE (CE plus the router's aux loss).
``ssm_impl="pallas"`` raises: the fused scan is forward-only in both
packages (the JAX kernel has no VJP, and ``jax.grad`` fails there).

Over ranks (``dp``, ``train/dp.py``) each rank's loss is its share of
the global loss, so that the ranks' gradients sum to the global one, as
GSPMD keeps the JAX step's global semantics: the CE is the rank's CE sum
over the global count of valid targets (summed over the ranks first,
with no gradient), and the MoE router's statistics and capacity are
taken over the global token set (``models/moe.py``, under ``use_dp``).
The gradients are then all-reduced in place, leaf by leaf in their own
dtype (``reduce_grads``), and the metrics summed.  One process (no
``dp``) takes the one-process path, whose answers stay bit for bit.

Over the model axis too (a model cut by ``Model.cut_to``, whose model
group ``train/dp.Ranks`` gave it) the layers run on their slices
(``sharding/tp.py``) and the head's logits are this rank's vocab
columns: the CE takes the max over the ranks' columns (all-reduced, no
gradient), the sum of exponentials and the target's logit summed over
model.  The loss is then whole on every model rank; the gradients are
summed over data only, since a cut leaf's gradient is its own and a
whole leaf's is equal on every model rank (``sharding/tp.py``'s copy and
reduce pairs).  The layers that ``remat="unit"`` checkpoints run their
collectives again in the recompute, in one order on every rank.

Under FSDP (a model ``Model.cut_to`` cut over data too) the layers
gather their weights over the data group and the gradients of those
leaves arrive reduce-scattered (``sharding/fsdp.py``): ``reduce_grads``
sums only the leaves FSDP leaves whole.  The head is gathered once a
step, outside the loss chunks (each chunk checkpointed would gather it
again), and a tied table once for the embedding and the head.  The
sequence cut at a global batch of 1 (``seq``) is a split like the
batch's: the CE over the global count of valid targets, the gradients
summed over data; the loss chunk is JAX's, of the global length.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.convert import param_tree
from repro_torch.models.layers import head_table, logits_local
from repro_torch.models.transformer import apply_model
from repro_torch.optim.adamw import adamw_update
from repro_torch.pytree import leaves, unflatten
from repro_torch.sharding import fsdp, tp
from repro_torch.sharding.context import current_model, current_seq, use_dp

F32 = torch.float32
LOSS_CHUNK = 512


def check_trainable(cfg):
    """Raise for a config the port cannot train: the forward-only fused
    scan."""
    if cfg.mamba_version == 1 and cfg.ssm_impl == "pallas":
        raise ValueError(
            f"training {cfg.name} with ssm_impl='pallas': the fused Mamba "
            f"scan is forward-only in both packages (the JAX kernel has no "
            f"VJP); train with ssm_impl='jnp'")


def _ce_chunk(cfg, model, hidden_chunk, target_chunk, head):
    """hidden: [B,c,D]; targets: [B,c] -> (sum_loss, n_valid); a target
    of -1 drops out of both.  ``head``: the head's table gathered whole
    (``layers.head_table``)."""
    logits, sliced = logits_local(cfg, model, hidden_chunk,
                                  head)                   # [B,c,V] f32
    valid = target_chunk >= 0
    tgt = torch.where(valid, target_chunk, 0).long()
    if sliced:
        lse, picked = _vocab_parallel(logits, tgt)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, tgt[..., None])[..., 0]
    loss = torch.where(valid, lse - picked, 0.0)
    return loss.sum(), valid.sum(dtype=torch.int32)


def _vocab_parallel(logits, tgt):
    """(logsumexp, the target's logit) of logits whose vocab columns are
    cut over the model group: this rank holds columns r * Vl .. (r + 1)
    * Vl - 1."""
    g = current_model()
    with torch.no_grad():
        mx = g.max_(logits.amax(dim=-1).contiguous())
    se = tp.reduce(torch.exp(logits - mx[..., None]).sum(dim=-1))
    Vl = logits.shape[-1]
    local = tgt - g.rank * Vl
    mine = (local >= 0) & (local < Vl)
    picked = torch.gather(logits, -1, torch.where(mine, local, 0)[..., None])
    picked = tp.reduce(torch.where(mine, picked[..., 0], 0.0))
    return torch.log(se) + mx, picked


def blockwise_ce(cfg, model, hidden, targets, n_valid_all=None, head=None):
    """The mean CE over the valid targets; with ``n_valid_all`` (the
    global count over the ranks) the CE sum over it instead: this rank's
    share.  ``head``: the head's table gathered whole (gathered once
    here if None).  Under the sequence cut the chunk is JAX's, of the
    global length, and a rank's block may end in a shorter one (each
    target's loss is its own)."""
    B, S, D = hidden.shape
    g = current_seq()
    S_all = S * (1 if g is None else g.world)
    c = min(LOSS_CHUNK, S_all)
    if S_all % c:
        raise ValueError(f"sequence length {S_all} is not a multiple of "
                         f"the loss chunk {c} (the JAX package's reshape "
                         f"fails too)")
    if head is None:
        head = head_table(cfg, model)
    loss_sum = torch.zeros((), dtype=F32, device=hidden.device)
    n_valid = torch.zeros((), dtype=torch.int32, device=hidden.device)
    for i in range(0, S, c):
        args = (cfg, model, hidden[:, i:i + c], targets[:, i:i + c], head)
        if torch.is_grad_enabled():
            ls, nv = checkpoint(_ce_chunk, *args, use_reentrant=False)
        else:
            ls, nv = _ce_chunk(*args)
        loss_sum = loss_sum + ls
        n_valid = n_valid + nv
    if n_valid_all is not None:
        n_valid = n_valid_all
    return loss_sum / torch.clamp(n_valid, min=1)


def loss_fn(cfg, model, batch, n_valid=None):
    """(CE + the MoE aux, {"ce", "aux"}) of ``batch`` ({tokens | embeds,
    targets}); with ``n_valid`` the CE is over that count
    (``blockwise_ce``).  Under FSDP a tied table is gathered once for
    the embedding and the head; an untied head once, after the
    layers."""
    check_trainable(cfg)
    table = head_table(cfg, model) if cfg.tie_embeddings else None
    hidden, aux = apply_model(cfg, model, batch, table)
    head = table if table is not None else head_table(cfg, model)
    ce = blockwise_ce(cfg, model, hidden, batch["targets"], n_valid, head)
    return ce + aux, {"ce": ce, "aux": aux}


def value_and_grad(cfg, model, batch, dp=None, seq=False):
    """(loss, metrics, gradients in ``param_tree``'s layout): the
    parameters' ``requires_grad`` is switched on, and the gradients are
    new tensors (``.grad`` is not touched).  With ``dp`` (a group over
    which the batch's rows, or with ``seq`` its sequence, are split) the
    loss is the rank's share and the gradients and metrics come back
    summed over the ranks: those of the global batch.  A model cut over
    the model axis (``Model.cut_to``) runs its layers over its model
    group, and one cut over data (FSDP) gathers its parameters over its
    data group; their gradients arrive as the rank's slices, summed."""
    params = param_tree(model, cfg)
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    ranks = dp is not None and dp.distributed
    n_valid = (dp.sum_((batch["targets"] >= 0).sum(dtype=torch.int32))
               if ranks else None)
    groups = use_dp(dp if ranks else None,
                    getattr(model, "model_group", None),
                    fsdp=getattr(model, "data_group", None),
                    seq=ranks and seq)
    with groups, torch.enable_grad():
        loss, metrics = loss_fn(cfg, model, batch, n_valid)
        grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                    materialize_grads=True)
    loss, metrics = loss.detach(), {k: v.detach() for k, v in metrics.items()}
    if ranks:
        reduce_grads(dp, [g for g, p in zip(grads, flat)
                          if not fsdp.marked(p)])
        sums = dp.sum_(torch.stack([loss, metrics["ce"],
                                    metrics["aux"].to(loss.dtype)]))
        loss, metrics = sums[0], {"ce": sums[1], "aux": sums[2]}
    return loss, metrics, unflatten(params, grads)


def reduce_grads(dp, grads):
    """Sum the ranks' gradients in place, leaf by leaf in the leaves'
    own dtype (no float32 copy of the gradients is made: at full width
    it would not fit beside the state).  The caller leaves out the
    leaves FSDP cuts: their gradients arrive summed."""
    with torch.no_grad():
        for g in grads:
            dp.sum_(g)


def train_step(cfg, model, opt_state, batch, *, lr: float = 3e-4, dp=None,
               zero=None, seq=False):
    """One full training step (fwd + bwd + AdamW).  The model's
    parameters and the state's m and v are updated in place; returns
    (model, the new opt state, {ce, aux, loss, grad_norm} as tensors).
    ``dp``: the group the batch's rows (with ``seq``, its sequence) are
    split over (``value_and_grad``); ``zero``: the ZeRO-1 plan
    (``optim/adamw.py``'s ``Zero1``) whose slice of m and v ``opt_state``
    holds."""
    loss, metrics, grads = value_and_grad(cfg, model, batch, dp, seq)
    if zero is None:
        _, opt_state, gnorm = adamw_update(param_tree(model, cfg), grads,
                                           opt_state, lr=lr)
    else:
        opt_state, gnorm = zero.update(param_tree(model, cfg), grads,
                                       opt_state, lr=lr)
    metrics = dict(metrics, loss=loss, grad_norm=gnorm)
    return model, opt_state, metrics


def make_train_step(cfg, *, lr: float = 3e-4):
    return functools.partial(train_step, cfg, lr=lr)
