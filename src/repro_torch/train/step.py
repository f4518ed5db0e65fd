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
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.convert import param_tree
from repro_torch.models.layers import logits_from_hidden
from repro_torch.models.transformer import apply_model
from repro_torch.optim.adamw import adamw_update
from repro_torch.pytree import leaves, unflatten

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


def _ce_chunk(cfg, model, hidden_chunk, target_chunk):
    """hidden: [B,c,D]; targets: [B,c] -> (sum_loss, n_valid); a target
    of -1 drops out of both."""
    logits = logits_from_hidden(cfg, model, hidden_chunk)     # [B,c,V] f32
    lse = torch.logsumexp(logits, dim=-1)
    valid = target_chunk >= 0
    picked = torch.gather(logits, -1, torch.where(
        valid, target_chunk, 0).long()[..., None])[..., 0]
    loss = torch.where(valid, lse - picked, 0.0)
    return loss.sum(), valid.sum(dtype=torch.int32)


def blockwise_ce(cfg, model, hidden, targets):
    B, S, D = hidden.shape
    c = min(LOSS_CHUNK, S)
    if S % c:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"loss chunk {c} (the JAX package's reshape fails "
                         f"too)")
    loss_sum = torch.zeros((), dtype=F32, device=hidden.device)
    n_valid = torch.zeros((), dtype=torch.int32, device=hidden.device)
    for i in range(0, S, c):
        args = (cfg, model, hidden[:, i:i + c], targets[:, i:i + c])
        if torch.is_grad_enabled():
            ls, nv = checkpoint(_ce_chunk, *args, use_reentrant=False)
        else:
            ls, nv = _ce_chunk(*args)
        loss_sum = loss_sum + ls
        n_valid = n_valid + nv
    return loss_sum / torch.clamp(n_valid, min=1)


def loss_fn(cfg, model, batch):
    """(CE + the MoE aux, {"ce", "aux"}) of ``batch`` ({tokens | embeds,
    targets})."""
    check_trainable(cfg)
    hidden, aux = apply_model(cfg, model, batch)
    ce = blockwise_ce(cfg, model, hidden, batch["targets"])
    return ce + aux, {"ce": ce, "aux": aux}


def value_and_grad(cfg, model, batch):
    """(loss, metrics, gradients in ``param_tree``'s layout): the
    parameters' ``requires_grad`` is switched on, and the gradients are
    new tensors (``.grad`` is not touched)."""
    params = param_tree(model, cfg)
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    with torch.enable_grad():
        loss, metrics = loss_fn(cfg, model, batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                    materialize_grads=True)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, unflatten(params, grads)


def train_step(cfg, model, opt_state, batch, *, lr: float = 3e-4):
    """One full training step (fwd + bwd + AdamW).  The model's
    parameters and the state's m and v are updated in place; returns
    (model, the new opt state, {ce, aux, loss, grad_norm} as tensors)."""
    loss, metrics, grads = value_and_grad(cfg, model, batch)
    _, opt_state, gnorm = adamw_update(param_tree(model, cfg), grads,
                                       opt_state, lr=lr)
    metrics = dict(metrics, loss=loss, grad_norm=gnorm)
    return model, opt_state, metrics


def make_train_step(cfg, *, lr: float = 3e-4):
    return functools.partial(train_step, cfg, lr=lr)
