"""Carry a store's state across from the JAX package (the port's
counterpart of carrying weights across).

Both functions take the state as numpy leaves with the JAX package's
field names — e.g. ``jax.tree.map(np.asarray, backend.group)`` — and
build the port's state on ``device``.  This module reads attributes
only; it imports nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import hash_index as hi
from repro_torch.core import index_group as ig
from repro_torch.core import log as lg
from repro_torch.core import sorted_index as si


def _t(a, device):
    return torch.as_tensor(np.array(a, copy=True), device=device)


def _state(cls, src, device, r=None):
    """``cls`` from the same-named fields of ``src``; with ``r``, replica
    r of a state stacked along a leading [R] dimension."""
    return cls(*[_t(getattr(src, f) if r is None else getattr(src, f)[r],
                    device) for f in cls._fields])


def group_from_numpy(group, device) -> ig.IndexGroup:
    """An IndexGroup on ``device`` from a JAX IndexGroup's numpy leaves
    (hash, plog, sorted replicas and backup logs stacked [R, ...],
    alive); the stacks are split into R separate states."""
    R = np.asarray(group.blogs.tail).shape[0]
    return ig.IndexGroup(
        hash=_state(hi.HashIndex, group.hash, device),
        plog=_state(lg.UpdateLog, group.plog, device),
        sorted=tuple(_state(si.SortedIndex, group.sorted, device, r)
                     for r in range(R)),
        blogs=tuple(_state(lg.UpdateLog, group.blogs, device, r)
                    for r in range(R)),
        alive=_t(group.alive, device).bool(),
    )


def backend_from_numpy(group, vals, used, cfg, device, *,
                       pending_bound: int | None = None):
    """A LocalBackend on ``device`` holding a JAX LocalBackend's state:
    its group plus the value shard ``vals`` [cap, W] and the slot bitmap
    ``used`` [cap].  The servers' liveness comes from ``group.alive``, so
    a store in the middle of a failure carries across whole.
    ``pending_bound`` is the host-side bound on the backup logs' pending
    entries (default: their exact count)."""
    from repro_torch.core.client import LocalBackend

    vals = np.asarray(vals)
    be = LocalBackend(vals.shape[0], cfg, vals.shape[1], device=device)
    be.group = group_from_numpy(group, be.device)
    be.vals = _t(vals, be.device)
    be.used = _t(used, be.device).bool()
    alive = [bool(a) for a in np.asarray(group.alive)]
    be._primary_alive = alive[0]
    be._backups_alive = alive[1:]
    be._pending_bound = (be.pending_ops() if pending_bound is None
                         else pending_bound)
    return be
