"""Gradient compression for data-parallel sync: int8 quantisation with
error feedback (port of ``repro/optim/compression.py``).

``compress`` quantises to int8 with a per-tensor scale; the residual
(quantisation error) is carried in a feedback buffer and added to the
next step's gradient, which restores convergence (the EF trick).
``dp_allreduce_compressed`` is the all-reduce: quantise, sum the int32
payloads, dequantise.  The JAX function runs inside ``shard_map`` over
the data axis.  Over ranks (``dp``, ``train/dp.py``) each rank passes
its own leaves: JAX's ``pmax`` of the scale is an all-reduce MAX and
its ``psum`` an all-reduce SUM of the int32 payload.  Without a group
the n ranks are a leading [n] axis of every leaf on one device, as the
distributed store stacks its groups: the ``pmax`` is an amax over that
axis and the ``psum`` an int32 sum over it.  Both forms give the same
bits.

The JAX docstring counts "an 8x reduction in all-reduce bytes", but the
payload it sums is int32, 4 B an element as float32's is; the port sums
what JAX sums, and ``dp.stats`` counts those bytes.
"""
from __future__ import annotations

import torch

from repro_torch.pytree import leaves, tree_map, unflatten

F32 = torch.float32


def compress(g, err):
    """g float, err float32 feedback.  Returns (q int8, scale, new_err)."""
    gf = g.to(F32) + err
    scale = torch.clamp(torch.amax(torch.abs(gf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    new_err = gf - q.to(F32) * scale
    return q, scale, new_err


def decompress(q, scale):
    return q.to(F32) * scale


def ef_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                          device=p.device), params)


def dp_allreduce_compressed(grads, err, dp=None):
    """Error-feedback int8 all-reduce over the leading [n] rank axis of
    every leaf.  Returns (the mean gradients, float32 [n, ...], every
    rank's row the same; the new error state [n, ...]).  With ``dp``,
    over its ranks: each rank's own leaves in, (the mean gradients, this
    rank's new error state) out."""
    if dp is not None:
        outs = [_one_rank(g, e, dp) for g, e in zip(leaves(grads),
                                                      leaves(err))]
        return (unflatten(grads, [o[0] for o in outs]),
                unflatten(grads, [o[1] for o in outs]))

    def one(g, e):
        n = g.shape[0]
        gf = g.to(F32) + e
        # one scale for every rank (JAX's pmax), taken BEFORE quantising,
        # so that the summed int8 payloads dequantise exactly
        scale = torch.amax(torch.abs(gf)) / 127.0
        scale = torch.clamp(scale, min=1e-12)
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        new_e = gf - q.to(F32) * scale
        s = q.to(torch.int32).sum(dim=0, dtype=torch.int32)     # JAX's psum
        out = s.to(F32) * scale / n
        return out.expand(g.shape).clone(), new_e

    outs = [one(g, e) for g, e in zip(leaves(grads), leaves(err))]
    return (unflatten(grads, [o[0] for o in outs]),
            unflatten(grads, [o[1] for o in outs]))


def _one_rank(g, e, dp):
    """One leaf over ``dp``'s ranks: JAX's ``one`` under shard_map."""
    gf = g.to(F32) + e
    # one scale for every rank (JAX's pmax), taken BEFORE quantising
    scale = dp.max_(torch.amax(torch.abs(gf))) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    new_e = gf - q.to(F32) * scale
    s = dp.sum_(q.to(torch.int32))                           # JAX's psum
    out = s.to(F32) * scale / dp.world
    return out, new_e
