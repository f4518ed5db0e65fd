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

Over ranks (``dp``, ``train/dp.py``) there is one stage a rank, as JAX
has one a device: rank s holds stage s's parameters (``params`` is its
stage's tree, no [S] axis), the handoff i -> i + 1 mod S is
``dp.shift`` (one ``all_to_all_single``), and the last stage's outputs
reach every rank by JAX's masked psum (an all-reduce sum in which the
other ranks add zeros).  The schedule is the same S + M - 1 ticks.  The
whole schedule is one ``torch.autograd.Function`` (``_RingPipeline``):
autograd cannot see across ranks, and a rank whose handoffs feed no
local output (stage 0 never reads what it receives) would skip their
backward while its neighbours wait in theirs.  Its backward walks the
ticks in reverse on every rank, each tick sending the cotangent back
i + 1 -> i (the transpose of ``ppermute``) and taking each stage's
vector-Jacobian product.  The outputs are replicated and the loss is the
same on every rank, so the backward takes the last stage's own
cotangent of them: summing the S ranks' (the transpose of a
differentiable all-reduce) would give S times the gradient.
"""
from __future__ import annotations

import torch

from repro_torch.pytree import leaves, unflatten


def pipeline_apply(stage_fn, params_stacked, x_microbatches, dp=None):
    """params_stacked: a tree of [S, ...] tensors (stage s's parameters
    at index s); x_microbatches: [M, mb, ...] inputs.  Returns outputs
    [M, mb, ...] after all S stages.  With ``dp`` the S = W stages are
    the ranks, and ``params_stacked`` is this rank's stage's tree."""
    if dp is not None:
        flat = leaves(params_stacked)
        needs = torch.is_grad_enabled() and (
            x_microbatches.requires_grad or any(p.requires_grad
                                                for p in flat))
        return _RingPipeline.apply(stage_fn, params_stacked, dp, needs,
                                   x_microbatches, *flat)
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


class _RingPipeline(torch.autograd.Function):
    """The schedule over ``dp``'s ranks, one stage a rank: forward and
    its transpose (see the module's docstring)."""

    @staticmethod
    def forward(ctx, stage_fn, params, dp, needs, xs, *flat):
        S, M, me = dp.world, xs.shape[0], dp.rank
        alias = [p.detach().requires_grad_(p.requires_grad) for p in flat]
        tree = unflatten(params, alias)
        buf = torch.zeros_like(xs[0])
        outs = torch.zeros_like(xs)
        ticks = {}
        for t in range(S + M - 1):
            # stage 0 injects microbatch t (if any); the others take the
            # handoff; a stage with no microbatch passes its input through
            cur = xs[min(t, M - 1)] if me == 0 else buf
            if 0 <= t - me < M:
                if needs:
                    cur = cur.detach().requires_grad_(True)
                    with torch.enable_grad():
                        y = stage_fn(tree, cur)
                    ticks[t] = (cur, y)
                    y = y.detach()
                else:
                    y = stage_fn(tree, cur)
            else:
                y = cur
            if me == S - 1 and t >= S - 1:       # the last stage emits
                outs[t - (S - 1)] = y
            buf = dp.shift(y, 1)                 # handoff i -> i + 1 mod S
        # the outputs live on the last stage: JAX's psum of the masked
        # outputs brings them to every rank
        if me != S - 1:
            outs.zero_()
        dp.sum_(outs)
        ctx.stage = (dp, ticks, alias, xs.requires_grad, xs.shape, xs.dtype)
        return outs

    @staticmethod
    def backward(ctx, d_outs):
        dp, ticks, alias, x_grad, x_shape, x_dtype = ctx.stage
        S, M, me = dp.world, x_shape[0], dp.rank
        d_flat = [torch.zeros_like(p) if p.requires_grad else None
                  for p in alias]
        d_xs = (torch.zeros(x_shape, dtype=x_dtype, device=d_outs.device)
                if x_grad else None)
        d_buf = torch.zeros_like(d_outs[0])      # of what a tick received
        for t in reversed(range(S + M - 1)):
            dy = dp.shift(d_buf, -1)             # back i + 1 -> i
            if me == S - 1 and t >= S - 1:       # the last stage's own
                dy = dy + d_outs[t - (S - 1)]
            if t in ticks:
                cur, y = ticks.pop(t)
                want = [cur] + [p for p in alias if p.requires_grad]
                got = torch.autograd.grad(y, want, dy, allow_unused=True)
                d_cur = got[0] if got[0] is not None else torch.zeros_like(
                    cur)
                it = iter(got[1:])
                for i, p in enumerate(alias):
                    if p.requires_grad:
                        g = next(it)
                        if g is not None:
                            d_flat[i] += g
            else:
                d_cur = dy
            if me == 0:                          # stage 0 read the input
                if d_xs is not None:
                    d_xs[min(t, M - 1)] += d_cur
                d_buf = torch.zeros_like(d_buf)
            else:
                d_buf = d_cur
        if d_xs is not None:                     # a replicated input
            dp.sum_(d_xs)
        ctx.stage = None
        return (None, None, None, None, d_xs, *d_flat)


def pipeline_loss(stage_fn, loss_fn, params_stacked, x_mb, y_mb, dp=None):
    out = pipeline_apply(stage_fn, params_stacked, x_mb, dp)
    return loss_fn(out, y_mb)


def make_pipeline_train_step(stage_fn, loss_fn, lr=1e-2, dp=None):
    """step(params_stacked, x_mb, y_mb) -> (new params, loss): one plain
    SGD step, p - lr * g, on the pipeline's loss (JAX's step).  With
    ``dp``, over its ranks: each rank steps its own stage's tree."""
    def step(params_stacked, x_mb, y_mb):
        flat = [p.detach().requires_grad_(True)
                for p in leaves(params_stacked)]
        params = unflatten(params_stacked, flat)
        with torch.enable_grad():
            loss = pipeline_loss(stage_fn, loss_fn, params, x_mb, y_mb, dp)
            grads = torch.autograd.grad(loss, flat)
        new = [(p - lr * g).detach() for p, g in zip(flat, grads)]
        return unflatten(params_stacked, new), loss.detach()
    return step
