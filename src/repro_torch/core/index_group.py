"""Index group: the unit of hybrid index (paper §3.2), healthy path
(port of ``repro/core/index_group.py``).

One group = one hash table (primary server) + ``n_backups`` sorted-index
replicas (backup servers), plus the primary's append-only log and one log
per backup.  The replicas and their logs are tuples of R separate
states; the JAX package stacks them along a leading [R] dimension and
``vmap``s over it, which here becomes a loop over R, so an apply round
copies no replica.

Write path (§3.2.2): record in the primary log -> replicate to every
backup log -> apply synchronously to the hash table -> (later) the
backups apply their logs to the sorted replicas in batches.  SCAN drains
the replica's log first (serializability).

Only the healthy path is ported: every server alive.  Degraded reads
(``primary_alive`` other than True), ``replica_probe``, ``fail`` and the
recoveries come with the next slice and raise NotImplementedError here.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import hash_index as hi
from repro_torch.core import log as lg
from repro_torch.core import sorted_index as si
from repro_torch.core.hashing import I32
from repro_torch.core.sorted_index import OP_DEL, OP_PUT
from repro_torch.kernels import ops as kops

_NEXT_SLICE = "degraded reads: next slice"


class IndexGroup(NamedTuple):
    hash: hi.HashIndex          # primary
    plog: lg.UpdateLog          # primary's log
    sorted: tuple               # R SortedIndex replicas
    blogs: tuple                # R UpdateLog backup logs
    alive: torch.Tensor         # bool [1 + R]: primary, backup_0..R-1


def create(capacity: int, cfg, device) -> IndexGroup:
    R = cfg.n_backups
    return IndexGroup(
        hash=hi.create(capacity, cfg, device),
        plog=lg.create(cfg.log_capacity, device),
        sorted=tuple(si.create(capacity, device) for _ in range(R)),
        blogs=tuple(lg.create(cfg.log_capacity, device) for _ in range(R)),
        alive=torch.ones((1 + R,), dtype=torch.bool, device=device),
    )


def pending_max(g: IndexGroup) -> int:
    """The most pending entries in any backup log (one host sync)."""
    return int(torch.stack([lg.pending_count(b) for b in g.blogs]).max())


def _healthy(primary_alive):
    if primary_alive is not True:
        raise NotImplementedError(_NEXT_SLICE)


# ---------------------------------------------------------------------------
# Writes
# ---------------------------------------------------------------------------
def _append_live_blogs(blogs, keys, addrs, ops, valid,
                       backups_alive: tuple | None):
    """Replicate a batch to the backup logs (all of them when
    ``backups_alive`` is None; dead backups are skipped).  Returns
    (blogs, ok_rep, nrep): nrep counts the logs that recorded each
    lane."""
    alive = (True,) * len(blogs) if backups_alive is None else backups_alive
    ok_rep = torch.ones_like(valid)
    nrep = torch.zeros(valid.shape, dtype=I32, device=valid.device)
    parts = []
    for one, live in zip(blogs, alive):
        if live:
            one, okr = lg.append(one, keys, addrs, ops, valid)
            ok_rep = ok_rep & okr
            nrep = nrep + (okr & valid).to(I32)
        parts.append(one)
    return tuple(parts), ok_rep, nrep


def put(g: IndexGroup, keys, addrs, cfg, valid=None,
        backups_alive: tuple | None = None, with_nrep: bool = False
        ) -> tuple:
    """PUT/UPDATE batch: primary log -> backup logs -> hash table.
    Returns (group, ok) — or (group, ok, nrep) with ``with_nrep``."""
    if valid is None:
        valid = torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    ops = torch.where(valid, OP_PUT, 0).to(torch.int8)
    plog, ok_log = lg.append(g.plog, keys, addrs, ops, valid)
    # the hash update below is synchronous: primary-log entries are
    # applied as soon as the batch commits
    plog = plog._replace(applied=plog.tail)
    blogs, ok_rep, nrep = _append_live_blogs(g.blogs, keys, addrs, ops,
                                             valid, backups_alive)
    new_hash, ok_hash = hi.insert(g.hash, keys, addrs, cfg, valid)
    # a write is complete only if logged everywhere and indexed
    ok = ok_log & ok_hash & ok_rep & valid
    g = g._replace(hash=new_hash, plog=plog, blogs=blogs)
    return (g, ok, nrep) if with_nrep else (g, ok)


def delete(g: IndexGroup, keys, cfg, valid=None,
           backups_alive: tuple | None = None,
           primary_alive: bool | None = True) -> tuple:
    """DELETE batch on the healthy path: found comes from the hash."""
    _healthy(primary_alive)
    if valid is None:
        valid = torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    ops = torch.where(valid, OP_DEL, 0).to(torch.int8)
    addrs = torch.full(keys.shape, -1, dtype=I32, device=keys.device)
    plog, ok_log = lg.append(g.plog, keys, addrs, ops, valid)
    plog = plog._replace(applied=plog.tail)  # hash delete is synchronous
    blogs, ok_rep, _ = _append_live_blogs(g.blogs, keys, addrs, ops, valid,
                                          backups_alive)
    new_hash, found = hi.delete(g.hash, keys, cfg, valid)
    return (g._replace(hash=new_hash, plog=plog, blogs=blogs),
            found & ok_log & ok_rep)


# ---------------------------------------------------------------------------
# Asynchronous apply (the backup "worker threads")
# ---------------------------------------------------------------------------
def apply_async(g: IndexGroup, cfg, batch: int | None = None) -> IndexGroup:
    """Apply up to ``batch`` pending log entries to every sorted replica."""
    batch = batch or cfg.async_apply_batch
    srts, logs = [], []
    for srt, blog in zip(g.sorted, g.blogs):
        keys, addrs, ops, blog = lg.take_pending(blog, batch)
        srts.append(kops.merge(cfg, srt, keys, addrs, ops))
        logs.append(blog)
    return g._replace(sorted=tuple(srts), blogs=tuple(logs))


def drain(g: IndexGroup, cfg, max_rounds: int | None = None) -> IndexGroup:
    """Apply ALL pending entries (used before SCAN for serializability).
    With max_rounds=None it stops as soon as every log is empty, reading
    the pending count on the host once per round."""
    if max_rounds is None:
        for _ in range(1 << 16):
            if pending_max(g) == 0:
                break
            g = apply_async(g, cfg)
        return g
    for _ in range(max_rounds):
        g = apply_async(g, cfg)
    return g


# ---------------------------------------------------------------------------
# Reads
# ---------------------------------------------------------------------------
def replica_probe(g: IndexGroup, keys, cfg):
    raise NotImplementedError(_NEXT_SLICE)


def owner_addr_probe(g: IndexGroup, keys, cfg, primary_alive=True):
    """Pre-batch (addr, found) of each key — the value slot a PUT
    overwrite or DELETE must free — from the hash."""
    _healthy(primary_alive)
    a_h, f_h, _ = kops.probe(cfg, g.hash, keys)
    return a_h, f_h


def get(g: IndexGroup, keys, cfg, *, primary_alive=True):
    """GET batch: one-sided hash probe.  Returns (addr, found,
    n_accesses)."""
    _healthy(primary_alive)
    return kops.probe(cfg, g.hash, keys)


def scan(g: IndexGroup, lo, hi_key, limit: int, cfg):
    """SCAN [lo, hi] from the first live sorted replica after draining
    the logs.  Returns ((keys [limit], addrs [limit], count), group)."""
    g = drain(g, cfg)
    rep = int(torch.argmax(g.alive[1:].to(torch.uint8)))
    return kops.range_query(cfg, g.sorted[rep], lo, hi_key, limit), g


# ---------------------------------------------------------------------------
# Failures & recovery (§4.3): the next slice
# ---------------------------------------------------------------------------
def fail(g: IndexGroup, server: int, wipe: bool = True) -> IndexGroup:
    raise NotImplementedError("index-server failure: next slice")


def recover_primary(g: IndexGroup, cfg, online: bool = True) -> IndexGroup:
    raise NotImplementedError("primary recovery: next slice")


def recover_backup(g: IndexGroup, which: int, cfg,
                   online: bool = True) -> IndexGroup:
    raise NotImplementedError("backup recovery: next slice")
