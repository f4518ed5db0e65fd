"""The value-slot allocator of a single data shard (the part of
``repro/core/data_plane.py`` that LocalBackend uses).

Every shard tracks its slots with a ``used`` bitmap.  PUT allocates the
lowest free slots; DELETE and overwrite free the old slot (the paper's
data-server GC), so a long-running store reuses capacity.
"""
from __future__ import annotations

import torch

from repro_torch.core import hash_index as hix
from repro_torch.core.hashing import I32
from repro_torch.core.scatter import drop_set


def alloc(used, want):
    """Allocate one slot per ``want`` lane from the lowest free indices.
    Returns (used', slot [n] int32 — cap on failure, ok [n]).  ok=False
    means the shard is full: the caller must not record the write.

    The JAX version reads the rank-th entry of a stable argsort of
    ``used`` (free slots first, in index order).  For rank < #free that
    entry is the rank-th free index, which a prefix count places
    directly; the other lanes fail either way."""
    cap = used.shape[0]
    dev = used.device
    free = ~used
    nfree = free.sum()
    free_rank = torch.cumsum(free.to(I32), 0, dtype=I32) - 1
    nth_free = torch.full((cap + 1,), cap, dtype=I32, device=dev)
    nth_free[torch.where(free, free_rank, cap).long()] = torch.arange(
        cap, dtype=I32, device=dev)
    rank = torch.cumsum(want.to(I32), 0, dtype=I32) - 1
    ok = want & (rank < nfree)
    slot = torch.where(ok, nth_free[torch.clamp(rank, 0, cap - 1).long()],
                       cap)
    return drop_set(used, slot, True), slot, ok


def free_slots(used, slots, mask):
    """Clear the allocator bits of ``slots`` where ``mask``."""
    cap = used.shape[0]
    return drop_set(used, torch.where(mask, slots, cap), False)


def winner_mask(keys, valid):
    """Last-occurrence-per-key dedupe over a batch: exactly one slot is
    allocated (and one old slot freed) per key per batch."""
    return hix.dedupe_last_valid(keys, valid)


def spread_winner_addr(rk, valid, winner, addr_lane):
    """Give every valid lane the largest address among the valid winner
    lanes of its key that got one (-1 when none did), so superseded
    lanes ack and log the same (key, addr) the index keeps.

    The JAX version takes that maximum over an [n, n] equality mask; at
    n = 16384 that is about 1.3 GB of temporaries per PUT.  Here the
    lanes are grouped by a sort on the key and the maximum is a segment
    maximum, with the same result."""
    n = rk.shape[0]
    dev = rk.device
    k_s, order = torch.sort(rk)
    first = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                       k_s[1:] != k_s[:-1]])
    gid = torch.empty((n,), dtype=torch.int64, device=dev)
    gid[order] = torch.cumsum(first.to(torch.int64), 0) - 1
    cand = torch.where(valid & winner & (addr_lane >= 0), addr_lane, -1)
    gmax = torch.full((n,), -1, dtype=I32, device=dev).scatter_reduce_(
        0, gid, cand.to(I32), "amax", include_self=True)
    return torch.where(valid, gmax[gid], -1).to(I32)
