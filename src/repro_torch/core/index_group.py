"""Index group: the unit of hybrid index (paper §3.2), port of
``repro/core/index_group.py``.

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

Failure handling (§4.3): ``alive`` masks servers and ``fail`` wipes the
state a dead server held.  Primary down -> GETs are served from the
first live sorted replica after consulting its pending log (the backup
probe); backup down -> SCANs use another replica; recovery rebuilds the
hash table from a sorted replica, or a replica from a live one.  The
states are functional: no function here writes a state tensor in place,
so a recovered replica may share its source's tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import hash_index as hi
from repro_torch.core import log as lg
from repro_torch.core import sorted_index as si
from repro_torch.core.hashing import I32, key_inf
from repro_torch.core.sorted_index import OP_DEL, OP_PUT
from repro_torch.kernels import ops as kops


class IndexGroup(NamedTuple):
    hash: hi.HashIndex          # primary
    plog: lg.UpdateLog          # primary's log
    sorted: tuple               # R SortedIndex replicas
    blogs: tuple                # R UpdateLog backup logs
    alive: torch.Tensor         # bool [1 + R]: primary, backup_0..R-1


def create(capacity: int, cfg, device, key_dtype=None) -> IndexGroup:
    """A fresh group whose logs and sorted replicas hold ``key_dtype``
    keys (default int32, ``hashing.key_dtype``)."""
    R = cfg.n_backups
    return IndexGroup(
        hash=hi.create(capacity, cfg, device),
        plog=lg.create(cfg.log_capacity, device, key_dtype),
        sorted=tuple(si.create(capacity, device, key_dtype)
                     for _ in range(R)),
        blogs=tuple(lg.create(cfg.log_capacity, device, key_dtype)
                    for _ in range(R)),
        alive=torch.ones((1 + R,), dtype=torch.bool, device=device),
    )


def pending_max(g: IndexGroup) -> int:
    """The most pending entries in any backup log (one host sync)."""
    return int(torch.stack([lg.pending_count(b) for b in g.blogs]).max())


def _store_keys(g: IndexGroup, keys):
    """``keys`` at the width of the group's keys: the hash mixes a key by
    its width and the replicas compare it at theirs, so every entry that
    takes keys first casts them, on every device."""
    return keys.to(g.sorted[0].keys.dtype)


def _first_live_backup(alive):
    """Index of the first live backup as a 0-d device tensor (0 when none
    is live), JAX's ``argmax`` over the bool mask."""
    return torch.argmax(alive[1:].to(torch.uint8))


def _set_alive(alive, server: int, value: bool):
    alive = alive.clone()
    alive[server] = value
    return alive


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
    keys = _store_keys(g, keys)
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
           primary_alive: bool | None = None) -> tuple:
    """DELETE batch.  ``primary_alive`` is the routing hint GET takes:
    True answers found from the hash alone; False/None also run the
    replica probe, before this batch's tombstones land, so found stays
    honest while the primary is down (None selects by ``alive[0]``)."""
    keys = _store_keys(g, keys)
    if valid is None:
        valid = torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    ops = torch.where(valid, OP_DEL, 0).to(torch.int8)
    addrs = torch.full(keys.shape, -1, dtype=I32, device=keys.device)
    if primary_alive is not True:
        _, found_d, _ = replica_probe(g, keys, cfg)
    plog, ok_log = lg.append(g.plog, keys, addrs, ops, valid)
    plog = plog._replace(applied=plog.tail)  # hash delete is synchronous
    blogs, ok_rep, _ = _append_live_blogs(g.blogs, keys, addrs, ops, valid,
                                          backups_alive)
    new_hash, found_h = hi.delete(g.hash, keys, cfg, valid)
    if primary_alive is True:
        found = found_h
    elif primary_alive is False:
        found = found_d & valid
    else:
        found = torch.where(g.alive[0], found_h, found_d & valid)
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
    """Degraded lookup via the first live sorted replica: its pending log
    first (newest wins), then the sorted index.  Returns (addr, found,
    n_accesses)."""
    keys = _store_keys(g, keys)
    R = len(g.sorted)
    rep = _first_live_backup(g.alive)
    rep_sel = (torch.arange(R, device=keys.device) == rep).to(I32)
    return kops.backup_probe(cfg, g.sorted, g.blogs, keys,
                             rep_sel.expand(keys.shape[0], R))


def owner_addr_probe(g: IndexGroup, keys, cfg,
                     primary_alive: bool | None = None):
    """Pre-batch (addr, found) of each key — the value slot a PUT
    overwrite or DELETE must free.  ``primary_alive=True`` asks the hash
    alone; otherwise the hash answer is combined with the replica probe,
    so the old slot is still found while the primary's table is wiped
    (writes issued after the failure land in the hash, earlier ones only
    in the replicas: the hash wins when it knows the key)."""
    keys = _store_keys(g, keys)
    a_h, f_h, _ = kops.probe(cfg, g.hash, keys)
    if primary_alive is True:
        return a_h, f_h
    a_d, f_d, _ = replica_probe(g, keys, cfg)
    return torch.where(f_h, a_h, a_d), f_h | f_d


def get(g: IndexGroup, keys, cfg, *, primary_alive: bool | None = None):
    """GET batch.  Primary alive: one-sided hash probe.  Primary down:
    the replica probe.  ``primary_alive`` is the client's routing hint:
    True runs the hash probe alone, False the replica probe alone, None
    runs both and selects by ``alive[0]``.  Returns (addr, found,
    n_accesses)."""
    keys = _store_keys(g, keys)
    if primary_alive is True:
        return kops.probe(cfg, g.hash, keys)
    addr_h, found_h, acc_h = kops.probe(cfg, g.hash, keys)
    addr_d, found_d, acc_d = replica_probe(g, keys, cfg)
    if primary_alive is False:
        return addr_d, found_d, acc_d
    ok = g.alive[0]
    return (torch.where(ok, addr_h, addr_d), torch.where(ok, found_h, found_d),
            torch.where(ok, acc_h, acc_d))


def scan(g: IndexGroup, lo, hi_key, limit: int, cfg):
    """SCAN [lo, hi] from the first live sorted replica after draining
    the logs.  Returns ((keys [limit], addrs [limit], count), group)."""
    g = drain(g, cfg)
    rep = int(torch.argmax(g.alive[1:].to(torch.uint8)))
    return kops.range_query(cfg, g.sorted[rep], lo, hi_key, limit), g


# ---------------------------------------------------------------------------
# Failures & recovery (§4.3)
# ---------------------------------------------------------------------------
def fail(g: IndexGroup, server: int, wipe: bool = True) -> IndexGroup:
    """Mask a server dead.  ``wipe`` (default) also destroys the index
    state it held — hash + primary log for server 0, the sorted replica +
    backup log for server 1+r — so recovery must rebuild from surviving
    copies rather than revive masked state."""
    g = g._replace(alive=_set_alive(g.alive, server, False))
    if not wipe:
        return g
    if server == 0:
        h = g.hash
        return g._replace(
            hash=hi.HashIndex(sig=torch.zeros_like(h.sig),
                              fp=torch.zeros_like(h.fp),
                              addr=torch.full_like(h.addr, -1),
                              fill=torch.zeros_like(h.fill)),
            plog=lg.clear(g.plog))
    r = server - 1
    s = g.sorted[r]
    wiped = si.SortedIndex(keys=torch.full_like(s.keys, key_inf(s.keys.dtype)),
                           addrs=torch.full_like(s.addrs, -1),
                           size=torch.zeros_like(s.size))
    return g._replace(sorted=_put_at(g.sorted, r, wiped),
                      blogs=_put_at(g.blogs, r, lg.clear(g.blogs[r])))


def _put_at(states: tuple, r: int, one) -> tuple:
    return states[:r] + (one,) + states[r + 1:]


def recover_primary(g: IndexGroup, cfg, online: bool = True) -> IndexGroup:
    """Rebuild the hash table from the first live sorted replica.

    ``online`` (default) rebuilds from the undrained snapshot, then
    replays the replica's pending-log window into the hash (the hash is
    synchronous by contract); the replica catches up through the
    ordinary applies.  ``online=False`` drains first (stop the world)."""
    if not online:
        g = drain(g, cfg)
    rep = int(_first_live_backup(g.alive))
    srt = g.sorted[rep]
    keys, addrs, valid = si.items(srt)
    fresh = hi.create(srt.keys.shape[0], cfg, srt.keys.device)
    new_hash = hi.rebuild(fresh, keys, addrs, cfg, valid)
    if online:
        new_hash = hi.replay_pending(new_hash, g.blogs[rep], cfg)
    return g._replace(hash=new_hash, alive=_set_alive(g.alive, 0, True))


def recover_backup(g: IndexGroup, which: int, cfg,
                   online: bool = True) -> IndexGroup:
    """Rebuild sorted replica ``which`` as a copy of the first other live
    replica — online as the undrained snapshot WITH its pending log (both
    then apply the same catch-up through the ordinary applies), else
    drained first.  The copy shares the source's tensors: every later
    write makes new ones."""
    if not online:
        g = drain(g, cfg)
    others = g.alive[1:] & (torch.arange(len(g.sorted),
                                         device=g.alive.device) != which)
    src = int(torch.argmax(others.to(torch.uint8)))
    return g._replace(sorted=_put_at(g.sorted, which, g.sorted[src]),
                      blogs=_put_at(g.blogs, which, g.blogs[src]),
                      alive=_set_alive(g.alive, 1 + which, True))
