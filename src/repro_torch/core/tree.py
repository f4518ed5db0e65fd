"""NamedTuple states stacked along leading axes: the port's stand-in for
``jax.tree.map`` over the store's [G] and [R, G] leaves.

Over W ranks a rank stacks only its L groups ([L], [R, L]); ``at``,
``put`` and ``put_leaf`` given a ``comm`` take the last index as a
global group index: the owner rank's local row, an IndexError on the
other ranks."""
from __future__ import annotations

import torch


def _local(idx, comm):
    if comm is None:
        return idx
    return idx[:-1] + (comm.local(idx[-1]),)


def at(state, *idx, comm=None):
    """The state of one group (``at(s, g)``) or one replica slot
    (``at(s, r, g)``): views of every leaf, nothing copied."""
    idx = _local(idx, comm)
    return type(state)(*[leaf[idx] for leaf in state])


def stack(states):
    """One state whose leaves stack the leaves of ``states`` along a new
    leading axis; nested lists stack along several."""
    if isinstance(states[0], (list, tuple)) and not hasattr(states[0],
                                                            "_fields"):
        states = [stack(s) for s in states]
    return type(states[0])(*[torch.stack(leaves)
                             for leaves in zip(*states)])


def replicate(state, n: int):
    """``n`` copies of ``state`` stacked along a new leading axis."""
    return type(state)(*[leaf[None].expand((n,) + tuple(leaf.shape))
                         .clone() for leaf in state])


def put_leaf(leaf, value, *idx, comm=None):
    """A copy of ``leaf`` with ``leaf[idx] = value`` (JAX's
    ``.at[idx].set``); ``leaf`` is unchanged."""
    idx = _local(idx, comm)
    leaf = leaf.clone()
    leaf[idx] = value
    return leaf


def put(state, one, *idx, comm=None):
    """A new state equal to ``state`` with ``one`` set at ``idx`` on every
    leaf (``put_leaf`` over a tree); ``state`` is unchanged."""
    idx = _local(idx, comm)
    return type(state)(*[put_leaf(leaf, v, *idx)
                         for leaf, v in zip(state, one)])
