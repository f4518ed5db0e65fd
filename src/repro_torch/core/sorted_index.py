"""Sorted index: the paper's skiplist as an implicit hierarchical
directory over a packed sorted array (port of
``repro/core/sorted_index.py``).

Level l of the directory is the stride-fanout^l view of the keys array;
one hop loads a fanout-wide node and counts keys <= q, a skiplist level
descent.  ``n_accesses`` = number of levels touched.  Updates are
batched merges (the asynchronous log apply of §3.2.2): newest wins per
key, DELETE entries compact away.

These are the plain PyTorch versions of the CUDA kernels in
``kernels/csrc/sorted_search.cu`` and ``kernels/csrc/merge.cu``: the
CPU path and the reference the kernels are held against.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.hashing import I32, key_dtype, key_inf
from repro_torch.core.scatter import drop_set

OP_PUT = 1
OP_DEL = 2


class SortedIndex(NamedTuple):
    keys: torch.Tensor    # int32 [cap], ascending, empty = key_inf
    addrs: torch.Tensor   # int32 [cap]
    size: torch.Tensor    # int32 scalar


def create(capacity: int, device, dtype=None) -> SortedIndex:
    dtype = dtype or key_dtype()
    return SortedIndex(
        keys=torch.full((capacity,), key_inf(dtype), dtype=dtype,
                        device=device),
        addrs=torch.full((capacity,), -1, dtype=I32, device=device),
        size=torch.zeros((), dtype=I32, device=device),
    )


def bulk_load(idx: SortedIndex, keys, addrs) -> SortedIndex:
    """Load (unsorted, distinct) pairs into an empty index."""
    order = torch.argsort(keys, stable=True)
    n = keys.shape[0]
    new_keys = idx.keys.clone()
    new_addrs = idx.addrs.clone()
    new_keys[:n] = keys[order]
    new_addrs[:n] = addrs[order]
    return SortedIndex(new_keys, new_addrs,
                       torch.tensor(n, dtype=I32, device=idx.keys.device))


def merge(idx: SortedIndex, keys, addrs, ops) -> SortedIndex:
    """Apply a batch of log entries (PUT/DEL).  Newest-wins per key;
    DELETEs compact away.  Invalid entries are marked op=0 (ignored).

    The JAX version orders by ``lexsort((prio, keys))`` with prio 0 for
    the existing entries and 1..m for the batch in arrival order; prio
    never decreases along the concatenation, so one stable sort by key
    gives the identical order."""
    cap = idx.keys.shape[0]
    m = keys.shape[0]
    dev = idx.keys.device
    INF = key_inf(idx.keys.dtype)
    all_keys = torch.cat(
        [idx.keys, torch.where(ops > 0, keys.to(idx.keys.dtype), INF)])
    all_addrs = torch.cat([idx.addrs, addrs.to(I32)])
    all_del = torch.cat([torch.zeros((cap,), dtype=torch.bool, device=dev),
                         ops == OP_DEL])
    k, order = torch.sort(all_keys, stable=True)
    a = all_addrs[order]
    d = all_del[order]
    # keep the last entry of each equal-key run; drop if it's a DELETE or INF
    is_last = torch.cat([k[1:] != k[:-1],
                         torch.ones((1,), dtype=torch.bool, device=dev)])
    keep = is_last & ~d & (k != INF)
    dest = torch.cumsum(keep.to(I32), 0, dtype=I32) - 1
    dest = torch.where(keep, dest, cap + m)           # dropped -> out of range
    new_keys = drop_set(torch.full((cap,), INF, dtype=idx.keys.dtype,
                                   device=dev), dest, k)
    new_addrs = drop_set(torch.full((cap,), -1, dtype=I32, device=dev),
                         dest, a)
    return SortedIndex(new_keys, new_addrs, keep.sum(dtype=I32))


def directory_levels(cap: int, fanout: int) -> int:
    lv = 1
    span = fanout
    while span < cap:
        span *= fanout
        lv += 1
    return lv


def _descent(keys, queries, fanout: int):
    """The directory descent: the position of the last key <= q (0 when
    none is).  At level l (stride fanout^l) it gathers the fanout-wide
    node at the current position and counts entries <= q."""
    cap = keys.shape[0]
    levels = directory_levels(cap, fanout)
    INF = key_inf(keys.dtype)
    pos = torch.zeros(queries.shape, dtype=torch.int64, device=keys.device)
    offs = torch.arange(fanout, dtype=torch.int64, device=keys.device)
    for lv in range(levels - 1, -1, -1):
        stride = fanout ** lv
        gi = pos[:, None] + offs[None, :] * stride          # [Q, fanout]
        node = keys[torch.clamp(gi, 0, cap - 1)]
        node = torch.where(gi < cap, node, INF)
        cnt = (node <= queries[:, None]).sum(dim=1)
        pos = pos + torch.clamp(cnt - 1, min=0) * stride
    return pos, levels


def search(idx: SortedIndex, keys, fanout: int = 128):
    """Hierarchical lookup.  keys: [Q] -> (addr, found, n_accesses);
    n_accesses = levels = ceil(log_f cap)."""
    pos, levels = _descent(idx.keys, keys, fanout)
    # q = key_inf descends past the end; the read clamps, as JAX's does
    at = torch.clamp(pos, max=idx.keys.shape[0] - 1)
    found = idx.keys[at] == keys
    addr = torch.where(found, idx.addrs[at], -1)
    n_acc = torch.full(keys.shape, levels, dtype=I32, device=keys.device)
    return addr, found, n_acc


def range_from_start(idx: SortedIndex, start, hi, limit: int):
    """SCAN tail shared by the plain and kernel paths: take ``limit``
    entries from position ``start`` (the lower bound) and mask to keys
    <= hi.  Returns (keys [limit], addrs [limit], count)."""
    cap = idx.keys.shape[0]
    at = start.to(torch.int64) + torch.arange(limit, device=idx.keys.device)
    take = torch.clamp(at, 0, cap - 1)
    k = idx.keys[take]
    a = idx.addrs[take]
    INF = key_inf(idx.keys.dtype)
    valid = (at < cap) & (k <= hi) & (k != INF)
    k = torch.where(valid, k, INF)
    a = torch.where(valid, a, -1)
    return k, a, valid.sum(dtype=I32)


def range_query(idx: SortedIndex, lo, hi, limit: int):
    """SCAN [lo, hi]: up to ``limit`` ascending entries.
    lo, hi: 0-d tensors.  Returns (keys [limit], addrs [limit], count)."""
    lo = torch.as_tensor(lo, dtype=idx.keys.dtype, device=idx.keys.device)
    start = torch.searchsorted(idx.keys, lo.reshape(1))[0]
    return range_from_start(idx, start, hi, limit)


def items(idx: SortedIndex):
    """(keys, addrs, valid) of live entries (for rebuilds)."""
    valid = idx.keys != key_inf(idx.keys.dtype)
    return idx.keys, idx.addrs, valid
