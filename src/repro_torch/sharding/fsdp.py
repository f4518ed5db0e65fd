"""The data axis's cuts of the training step: FSDP (``cfg.fsdp``: every
parameter of 2 or more dims cut over the data group) and the sequence cut
at a global batch of 1, as autograd Functions over the data group whose
backwards are the layouts GSPMD gives the JAX step.

The plan.  JAX's ``param_pspecs`` under ``cfg.fsdp`` adds the data axis
to the first dim of a leaf's stacked shape that the model axis leaves
whole and the data axis divides (``_with_extra_data``); ``opt_pspecs``
does the same, so under FSDP m and v are cut as the parameter is.
``plan`` computes that once for the port's per-layer leaves, after the
model cut: ZeRO-1 (``optim/adamw.Zero1``) reads it for m and v, and
``Model.cut_to`` for the parameters.  A leaf's view is ``WHOLE``, a
slice (dim, start, size) of the port leaf, or None where the data axis
cuts a scanned stage's stack axis and the layer is another rank's
(``owners`` names the rank that holds it).  The plan reads the state
under JAX's "m" key, as ``make_sharded_step``'s ``opt_pspecs`` does, so
the embedding's and head's tables take the data axis on the vocab rows
of the rank's model slice, where JAX's parameter spec puts it on the
other dim (ROADMAP.md §C): the bytes a rank holds are the same.

A parameter cut by ``cut`` carries ``fsdp`` = (the shape it had, its
view, its owner) and holds only its slice, or nothing (a 0-element
tensor) where its layer is another rank's.  ``whole(p)`` gives it back
inside the step (``call`` a block's, ``gathered`` for a decode):

    gather(x, dim)      forward the ranks' slices concatenated along dim;
                        backward the gradient reduce-scattered (summed over
                        the ranks where the loss is split over them, else
                        this rank's slice of it: every rank then computed
                        the whole gradient)
    owned(x, owner)     forward the owner's layer broadcast; backward the
                        gradient reduced to the owner (or its own)

and, for the sequence cut (``current_seq()``: each rank holds the block
[r S_l, (r + 1) S_l) of the sequence, the loss split over the ranks):

    seq_prefix(x)       the sequence up to this rank's last position,
                        gathered along dim 1 (keys and values, MLA's
                        latent); backward reduce-scattered
    halo(x, h)          the h positions before this rank's block (zeros
                        on rank 0): a causal conv's left context; backward
                        the reverse shift
    carry_in(a, e)      the state entering this rank's block of a linear
                        recurrence h_t = a_t h_{t-1} + b_t, from every
                        rank's (total decay, end state from zero),
                        combined in rank order; backward its gradients
                        summed over the ranks

A Function's output is used on every rank, so that its backward, which
calls a collective, runs on every rank; autograd runs the backwards in
the reverse of the forward's order, the same on every rank.
"""
from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.sharding.context import current_dp, current_fsdp, current_seq

WHOLE = ()                  # a view: the whole leaf


def _data_dim(spec):
    """The dim a spec puts the data axis on, or None."""
    for i, e in enumerate(spec):
        if e == "data" or (isinstance(e, tuple) and "data" in e):
            return i
    return None


def plan(cfg, params, world: int, rank: int, model_world: int = 1,
         dims=None):
    """The data-axis plan of ``params`` (``convert.param_tree``'s layout,
    each leaf its model slice, or a parameter ``cut`` already cut over
    data) over ``world`` data ranks.  Returns (JAX's whole stacked shapes
    as meta tensors, for each JAX leaf (its first port leaf, its port
    leaves, whether it is a stack, the data dim of its stacked shape or
    None), each port leaf's view, each port leaf's owner or None)."""
    from repro_torch.convert import _is_stack, stack_like
    from repro_torch.pytree import leaves, unflatten
    from repro_torch.sharding.partition import opt_pspecs

    flat = leaves(params)
    dims = dims if dims is not None else [None] * len(flat)
    whole = unflatten(params, [
        torch.empty(tuple(n * (model_world if i == d else 1)
                          for i, n in enumerate(held_shape(t))),
                    dtype=t.dtype, device="meta")
        for t, d in zip(flat, dims)])
    whole_like = stack_like(whole)
    specs = opt_pspecs(cfg, {"m": whole_like},
                       {"data": world, "model": model_world})["m"]
    shards, views, owners = [], [], []

    def walk(p, s):
        if _is_stack(p) or torch.is_tensor(p):
            stacked = _is_stack(p)
            ts = p if stacked else [p]
            d = _data_dim(s)
            if d is not None and not (stacked and d == 0):
                e = d - 1 if stacked else d
                if held_shape(ts[0])[e] % world:   # the model slice does
                    d = None                        # not divide: kept whole
            shards.append((len(views), len(ts), stacked, d))
            for j, t in enumerate(ts):
                if d is None:
                    views.append(WHOLE)
                    owners.append(None)
                elif stacked and d == 0:
                    q = j // (len(ts) // world)
                    views.append(WHOLE if q == rank else None)
                    owners.append(q)
                else:
                    e = d - 1 if stacked else d
                    size = held_shape(t)[e] // world
                    views.append((e, rank * size, size))
                    owners.append(None)
            return
        if isinstance(p, dict):
            for k in sorted(p):
                walk(p[k], s[k])
        else:
            for x, sx in zip(p, s):
                walk(x, sx)

    walk(params, specs)
    return whole_like, shards, views, owners


def held_shape(p) -> tuple:
    """The shape of ``p`` before its data cut (its own where it is
    whole)."""
    mark = getattr(p, "fsdp", None)
    return tuple(p.shape) if mark is None else mark[0]


def marked(p) -> bool:
    """Whether ``p`` is cut over the data group."""
    return getattr(p, "fsdp", None) is not None


@torch.no_grad()
def cut(flat, views, owners):
    """Cut each parameter of ``flat`` in place to its ``views`` entry
    (``plan``), freeing the whole: a slice, or nothing where its layer is
    another rank's; each cut one marked."""
    for p, view, owner in zip(flat, views, owners):
        if view == WHOLE and owner is None:
            continue
        shape = tuple(p.shape)
        if view is None:
            p.data = torch.empty((0,), dtype=p.dtype, device=p.device)
        elif view != WHOLE:
            p.data = p.data.narrow(*view).clone()
        p.fsdp = (shape, view, owner)


def _copy_marks(out, p):
    for a in ("model_dim", "model_parts"):
        if hasattr(p, a):
            setattr(out, a, getattr(p, a))
    return out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim, summed):
        ctx.g, ctx.dim, ctx.n, ctx.summed = g, dim, x.shape[dim], summed
        return g.all_gather(x.contiguous(), dim)

    @staticmethod
    def backward(ctx, dy):
        g, dim = ctx.g, ctx.dim
        if ctx.summed:
            dx = g.reduce_scatter(dy.contiguous(), dim)
        else:
            dx = dy.narrow(dim, g.rank * ctx.n, ctx.n)
        return dx.contiguous(), None, None, None


class _Owned(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, owner, shape, summed):
        ctx.g, ctx.owner, ctx.summed = g, owner, summed
        ctx.empty = x.shape
        if g.rank == owner:
            g.broadcast(x.detach(), owner)
            return x.view_as(x)
        buf = torch.empty(shape, dtype=x.dtype, device=x.device)
        return g.broadcast(buf, owner)

    @staticmethod
    def backward(ctx, dy):
        g = ctx.g
        dx = g.reduce_to(dy, ctx.owner) if ctx.summed else dy
        if g.rank != ctx.owner:
            dx = dy.new_zeros(ctx.empty)
        return dx, None, None, None, None


def whole(p):
    """``p`` gathered whole over the data group (``current_fsdp()``),
    marked with its model cut: ``p`` itself where it is not cut."""
    mark = getattr(p, "fsdp", None)
    if mark is None:
        return p
    g = current_fsdp()
    summed = current_dp() is not None
    shape, view, owner = mark
    if view is None or view == WHOLE:
        out = _Owned.apply(p, g, owner, shape, summed)
    else:
        out = _Gather.apply(p, g, view[0], summed)
    return _copy_marks(out, p)


@contextlib.contextmanager
def gathered(module):
    """For a step that takes no gradient (a decode step): inside the
    block, each parameter of ``module`` (None: none) cut over data holds
    its whole tensor, gathered over ``current_fsdp()`` in
    ``parameters`` order (one order on every rank), and its slice again
    after it."""
    cut = ([p for p in module.parameters() if marked(p)]
           if module is not None and current_fsdp() is not None else [])
    held = [p.data for p in cut]
    with torch.no_grad():
        for p in cut:
            p.data = whole(p)
    try:
        yield
    finally:
        for p, h in zip(cut, held):
            p.data = h


def call(module, *args):
    """``module(*args)`` with its parameters cut over data gathered whole
    for the call (``torch.func.functional_call``), in
    ``named_parameters`` order (one order on every rank); a module with
    none is called as it is."""
    got = ({n: whole(p) for n, p in module.named_parameters() if marked(p)}
           if current_fsdp() is not None else {})
    if not got:
        return module(*args)
    from torch.func import functional_call
    return functional_call(module, got, args)


# ---------------------------------------------------------------------------
# The sequence cut
# ---------------------------------------------------------------------------
def seq_offset(n_local: int) -> int:
    """The global position of this rank's first position (0 with no
    sequence cut)."""
    g = current_seq()
    return 0 if g is None else g.rank * n_local


def seq_prefix(x):
    """x: [B, S_l, ...] this rank's block -> [B, (r + 1) S_l, ...], the
    sequence from position 0 to this rank's last; ``x`` itself with no
    sequence cut."""
    g = current_seq()
    if g is None:
        return x
    full = _Gather.apply(x, g, 1, True)
    return full[:, :(g.rank + 1) * x.shape[1]]


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tail, g):
        ctx.g = g
        got = g.shift(tail, 1)
        if g.rank == 0:
            got.zero_()
        return got

    @staticmethod
    def backward(ctx, dy):
        g = ctx.g
        send = torch.zeros_like(dy) if g.rank == 0 else dy
        return g.shift(send, -1), None


def halo(x, h: int):
    """The ``h`` positions of the sequence before this rank's block of
    ``x`` [B, S_l, C] (zeros before position 0), [B, h, C]; None with no
    sequence cut."""
    g = current_seq()
    if g is None:
        return None
    if h == 0:
        return x[:, :0]
    if x.shape[1] >= h:
        return _Halo.apply(x[:, -h:].contiguous(), g)
    start = g.rank * x.shape[1]
    full = _Gather.apply(x, g, 1, True)[:, max(0, start - h):start]
    pad = h - full.shape[1]
    if pad:
        full = torch.cat([full.new_zeros((x.shape[0], pad) + x.shape[2:]),
                          full], dim=1)
    return full


def _prefix(decay, end, upto):
    """The state entering block ``upto`` from blocks 0 .. upto - 1 of
    [W, ...] (total decay, end state from zero): h = a_q h + e_q."""
    h = torch.zeros_like(end[0])
    for q in range(upto):
        h = decay[q] * h + end[q]
    return h


class _CarryIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, decay, end, g):
        ctx.g = g
        a = g.all_gather(decay.contiguous()[None], 0)
        e = g.all_gather(end.contiguous()[None], 0)
        ctx.save_for_backward(a, e)
        return _prefix(a, e, g.rank)

    @staticmethod
    def backward(ctx, dh):
        g = ctx.g
        a, e = ctx.saved_tensors
        with torch.enable_grad():
            a_, e_ = a.detach().requires_grad_(), e.detach().requires_grad_()
            h = _prefix(a_, e_, g.rank)
            if g.rank:
                da, de = torch.autograd.grad(h, (a_, e_), dh)
            else:
                da, de = torch.zeros_like(a), torch.zeros_like(e)
        return (g.reduce_scatter(da.contiguous(), 0)[0],
                g.reduce_scatter(de.contiguous(), 0)[0], None)


def carry_in(decay, end):
    """The state entering this rank's block of the sequence: ``decay``
    (the product of the block's decays, broadcast against the state) and
    ``end`` (its final state from a zero start) of every lower rank
    combined in rank order; zeros on rank 0 and with no sequence cut."""
    g = current_seq()
    if g is None:
        return torch.zeros_like(end)
    return _CarryIn.apply(decay, end, g)


def local_chunk(chunk: int, n_global: int, n_local: int) -> int:
    """A chunk length for this rank's ``n_local`` positions of a
    sequence the JAX function chunks by ``min(chunk, n_global)``: that
    length where it divides the block, else the largest length that
    divides both (the chunked scans' answer is the same function of the
    inputs for every chunk length)."""
    T = min(chunk, n_global)
    return T if n_local % T == 0 else math.gcd(T, n_local)
