"""Pipeline parallelism (GPipe-style) on a stacked stage axis (port of
``repro/train/pipeline.py``).

The JAX package runs S stages on S devices of a mesh's "stage" axis
under ``shard_map``, handing each stage's output to the next with
``ppermute``.  Here the S stages are a leading [S] axis on one device,
as the distributed store stacks its groups: each tick applies
``stage_fn`` to all S stages at once (``torch.func.vmap`` over the
stacked parameters and an [S, mb, ...] buffer), and the handoff i ->
i + 1 mod S is ``torch.roll`` along that axis.  The schedule is JAX's:
S + M - 1 ticks for M microbatches (fill + steady state + drain); stage
0 injects microbatch t, a stage with no microbatch passes its input
through, and the last stage emits microbatch t - (S - 1).  The outputs
are the last stage's, so no sum over stages is needed.  Backward is
autograd through the ticks, as JAX differentiates through the ppermutes.

``stage_fn(params_slice, x)`` is any per-stage block: model-agnostic, as
in the JAX package.  Tensors stay on the device they are given (the card
unless the caller passes CPU tensors).
"""
from __future__ import annotations

import torch

from repro_torch.pytree import leaves, unflatten


def pipeline_apply(stage_fn, params_stacked, x_microbatches):
    """params_stacked: a tree of [S, ...] tensors (stage s's parameters
    at index s); x_microbatches: [M, mb, ...] inputs.  Returns outputs
    [M, mb, ...] after all S stages."""
    S = leaves(params_stacked)[0].shape[0]
    M = x_microbatches.shape[0]
    dev = x_microbatches.device
    stages = torch.func.vmap(stage_fn)
    me = torch.arange(S, device=dev).view((S,) + (1,) * (
        x_microbatches.ndim - 1))
    buf = torch.zeros((S,) + x_microbatches.shape[1:],
                      dtype=x_microbatches.dtype, device=dev)
    outs = []
    for t in range(S + M - 1):
        # stage 0 injects microbatch t (if any); the others take the handoff
        inject = x_microbatches[min(t, M - 1)]
        cur = torch.where(me == 0, inject, buf)
        active = (t - me >= 0) & (t - me < M)
        y = torch.where(active, stages(params_stacked, cur), cur)
        if t >= S - 1:                       # the last stage emits
            outs.append(y[S - 1])
        buf = torch.roll(y, 1, dims=0)       # handoff i -> i + 1 mod S
    return torch.stack(outs)


def pipeline_loss(stage_fn, loss_fn, params_stacked, x_mb, y_mb):
    out = pipeline_apply(stage_fn, params_stacked, x_mb)
    return loss_fn(out, y_mb)


def make_pipeline_train_step(stage_fn, loss_fn, lr=1e-2):
    """step(params_stacked, x_mb, y_mb) -> (new params, loss): one plain
    SGD step, p - lr * g, on the pipeline's loss (JAX's step)."""
    def step(params_stacked, x_mb, y_mb):
        flat = [p.detach().requires_grad_(True)
                for p in leaves(params_stacked)]
        params = unflatten(params_stacked, flat)
        with torch.enable_grad():
            loss = pipeline_loss(stage_fn, loss_fn, params, x_mb, y_mb)
            grads = torch.autograd.grad(loss, flat)
        new = [(p - lr * g).detach() for p, g in zip(flat, grads)]
        return unflatten(params_stacked, new), loss.detach()
    return step
