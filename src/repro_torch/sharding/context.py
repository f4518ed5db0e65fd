"""Two process-wide slots the layers read (the port's counterparts of
the JAX package's GSPMD partitioning and of its ``sharding/context``
mesh):

    with use_dp(dp, model, fsdp=g, seq=True):   # train/step.py
        ...                   # current_dp(): the data group the loss is
                              # split over (models/moe.py)
                              # current_model(): the model group (the
                              # tensor-parallel layers)
                              # current_fsdp(): the data group the
                              # parameters are cut over (sharding/fsdp.py)
                              # current_seq(): with seq, the data group,
                              # over which the sequence is cut then
                              # (attention, the SSM blocks)
    with use_mesh(ranks):     # JAX's use_mesh: get_mesh() is ranks
        ...                   # moe_impl="smap" and decode_cache_hint

The first slot is what GSPMD does for the JAX step: the groups the
layers' collectives run over while a loss, its gradient or a forward is
taken.  The second is JAX's ``use_mesh`` / ``get_mesh`` and switches only
what JAX switches with it: the shard_map MoE dispatch and the
sequence-sharded decode cache.  Setting the first never sets the second:
JAX's trainer jits its step over a mesh without ``use_mesh``, and its MoE
takes the sort dispatch there.  ``use_mesh`` sets the groups too, as a
JAX mesh shards the arrays it constrains.

Both are slots of the process, not ``ContextVar``s: on the card autograd
runs the backward, and so the forward that ``remat="unit"`` recomputes
there, on a thread of its own, which does not see the caller's context
variables.  A process takes one step at a time, so one slot each is
enough.  The slots sit below both the models and the trainer, which
import them.
"""
from __future__ import annotations

import contextlib

_GROUPS = (None, None, None, False)         # (data, model, fsdp, seq)
_MESH = None


@contextlib.contextmanager
def use_dp(dp, model=None, *, fsdp=None, seq=False):
    """Make ``dp`` (the data group the loss is split over), ``model``
    (the model group) and ``fsdp`` (the data group the parameters are
    cut over) the groups ``current_dp``, ``current_model`` and
    ``current_fsdp`` answer, on every thread, inside the block; with
    ``seq`` the sequence is cut over ``dp`` (``current_seq``)."""
    global _GROUPS
    prev, _GROUPS = _GROUPS, (dp, model, fsdp, seq)
    try:
        yield dp
    finally:
        _GROUPS = prev


def current_dp():
    """The data group set by ``use_dp``, or None."""
    return _GROUPS[0]


def current_model():
    """The model group set by ``use_dp``, or None: a group of one
    process counts as none."""
    m = _GROUPS[1]
    return m if m is not None and m.world > 1 else None


def current_fsdp():
    """The data group the parameters are cut over, set by ``use_dp``, or
    None."""
    return _GROUPS[2]


def current_seq():
    """The data group the sequence is cut over (``use_dp``'s ``dp`` where
    its ``seq`` is set), or None: each rank holds a contiguous block of
    it, in rank order."""
    return _GROUPS[0] if _GROUPS[3] else None


@contextlib.contextmanager
def use_mesh(ranks):
    """JAX's ``use_mesh``: ``get_mesh`` answers ``ranks`` (a
    ``train/dp.Ranks``) inside the block, whose data and model groups are
    the layers' groups there too."""
    global _MESH
    prev = _MESH
    _MESH = ranks
    try:
        with use_dp(ranks.data if ranks.data.world > 1 else None,
                    ranks.model):
            yield ranks
    finally:
        _MESH = prev


def get_mesh():
    """The ranks set by ``use_mesh``, or None."""
    return _MESH
