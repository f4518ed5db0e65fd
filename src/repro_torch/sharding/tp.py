"""Tensor parallelism's four collectives over the model group, with their
gradients (Megatron's f and g, and the gather and split between a cut
and a whole activation), and the mark a cut weight carries.

A weight cut over the model axis (``sharding/partition.cut_model``)
carries ``model_dim``, the dim it was cut on, and ``model_parts``, the
size of the model axis; ``cut(w)`` reads the dim, None for a whole
weight.  The collectives run over ``sharding/context.current_model()``
and are the identity where there is none (one process, or a model axis
of one rank), so a layer whose weights are whole takes its one-process
path unchanged.

    copy(x)          forward x; backward the gradient summed over model
                     (x is whole on every rank and feeds rank-local work)
    reduce(x)        forward the sum over model; backward the gradient
                     (partial sums whose result is whole on every rank)
    gather(x, dim)   forward the ranks' slices concatenated along dim;
                     backward this rank's slice of the gradient
    split(x, dim)    forward this rank's slice of a whole x; backward the
                     ranks' gradients concatenated

A whole tensor that feeds rank-local work gets ``copy`` (or ``split``),
so that every gradient that leaves a rank-local region is summed, and
the ranks' gradients of a whole weight stay equal without another
all-reduce.
"""
from __future__ import annotations

import torch

from repro_torch.sharding.context import current_model


def cut(w):
    """The dim ``w`` is cut on over the model axis, or None."""
    return getattr(w, "model_dim", None)


def mark(w, dim, parts):
    """Mark ``w`` as this rank's slice along ``dim`` of ``parts``."""
    w.model_dim, w.model_parts = dim, parts
    return w


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return ctx.g.sum_(dy.contiguous().clone()), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        return g.sum_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim, ctx.n = g, dim, x.shape[dim]
        return g.all_gather(x.contiguous(), dim)

    @staticmethod
    def backward(ctx, dy):
        return (dy.narrow(ctx.dim, ctx.g.rank * ctx.n, ctx.n).contiguous(),
                None, None)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        n = x.shape[dim] // g.world
        return x.narrow(dim, g.rank * n, n).contiguous()

    @staticmethod
    def backward(ctx, dy):
        return ctx.g.all_gather(dy.contiguous(), ctx.dim), None, None


def copy(x):
    g = current_model()
    return x if g is None else _Copy.apply(x, g)


def reduce(x):
    g = current_model()
    return x if g is None else _Reduce.apply(x, g)


def gather(x, dim=-1):
    g = current_model()
    return x if g is None else _Gather.apply(x, g, dim % x.ndim)


def split(x, dim=-1):
    g = current_model()
    return x if g is None else _Split.apply(x, g, dim % x.ndim)


def whole(w):
    """A cut weight gathered whole (its gradient this rank's slice), or
    ``w`` itself where it is whole."""
    d = cut(w)
    return w if d is None else gather(w, d)


def local(w, dim):
    """This rank's slice of a per-channel weight along ``dim``: the weight
    itself where it is cut, else split from the whole (the rules leave
    some whole, such as a stacked ``dt_bias``)."""
    return w if cut(w) is not None else split(w, dim)


def rank_parts():
    """(model index, model size) of this rank; (0, 1) with no group."""
    g = current_model()
    return (0, 1) if g is None else (g.rank, g.world)


def row(h, w, sliced: bool):
    """``dot(h, w)`` of a row-cut weight, summed over model: ``h`` is this
    rank's slice of the input (``sliced``) or whole (split first)."""
    from repro_torch.models.layers import dot
    if cut(w) is None:
        return dot(gather(h, -1) if sliced else h, w)
    return reduce(dot(h if sliced else split(h, -1), w))
