"""Data-server subsystem: the value plane of the store (port of the
healthy parts of ``repro/core/data_plane.py``).

  * **Slot allocator + GC** — every data shard tracks its slots with a
    ``used`` bitmap.  PUT allocates the lowest free slots; DELETE and
    overwrite free the old slot (the paper's data-server GC), so a
    long-running store reuses capacity.  Frees that target another
    device's shard ride a per-device free queue (an ``UpdateLog`` ring)
    until the routed ``gc`` op flushes them home.
  * **Value replication** — each shard is mirrored on the next
    ``cfg.n_value_replicas`` devices (shifted layout, like the index
    backup logs: ``mirror[r, p]`` holds the copy of shard
    ``(p - r - 1) mod G``).
  * **Audits** — the host-side drain barrier (``drain_all_logs``) and
    ``value_slot_audit``: every live address allocated, nothing orphaned
    or referenced twice, no free-queue spill.

The data-server fail / sever / recover passes, ``sweep``,
``migrate_values`` and ``group_items_from_data`` belong to slice 2b.
This module never imports ``kvstore``: it touches only the store's
fields, so the dependency points one way.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import hash_index as hix
from repro_torch.core import log as lg
from repro_torch.core import sorted_index as six
from repro_torch.core import tree
from repro_torch.core.hashing import I32, key_dtype
from repro_torch.core.scatter import drop_set
from repro_torch.kernels import ops as kops


class RecoveryError(RuntimeError):
    """No live copy to rebuild from: ``group`` names the lost structure,
    ``searched`` the copies that were checked, ``blockers`` what would
    have to be recovered first."""

    def __init__(self, group: int, searched: list, blockers: list):
        self.group = group
        self.searched = list(searched)
        self.blockers = list(blockers)
        msg = (f"group {group}: no live copy to rebuild from "
               f"(searched {', '.join(map(str, searched))})")
        if blockers:
            msg += f"; recover {', '.join(map(str, blockers))} first"
        super().__init__(msg)


class DataPlane(NamedTuple):
    vals: torch.Tensor     # [G, dcap, W] int32   primary copy of each shard
    used: torch.Tensor     # [G, dcap] bool       slot allocator bitmap
    mirror: torch.Tensor   # [Rv, G, dcap, W]     mirror[r, p] holds the
    #                        copy of shard (p - r - 1) mod G
    freeq: lg.UpdateLog    # leaves [G, fq]       pending remote frees
    alive: torch.Tensor    # [G] bool             data-server liveness
    keys: torch.Tensor     # [G, dcap]            key stored with each slot
    kmirror: torch.Tensor  # [Rv, G, dcap]        key copies, like mirror
    fq_spill: torch.Tensor  # [G] int32           frees a full queue rejected
    hb: torch.Tensor       # [G] int32            data-server heartbeats
    sever: torch.Tensor    # [G] bool             crashed, not yet detected


def create(G: int, dcap: int, cfg, device) -> DataPlane:
    W, Rv = cfg.value_words, cfg.n_value_replicas
    return DataPlane(
        vals=torch.zeros((G, dcap, W), dtype=I32, device=device),
        used=torch.zeros((G, dcap), dtype=torch.bool, device=device),
        mirror=torch.zeros((Rv, G, dcap, W), dtype=I32, device=device),
        freeq=tree.replicate(lg.create(cfg.log_capacity, device), G),
        alive=torch.ones((G,), dtype=torch.bool, device=device),
        keys=torch.zeros((G, dcap), dtype=key_dtype(), device=device),
        kmirror=torch.zeros((Rv, G, dcap), dtype=key_dtype(),
                            device=device),
        fq_spill=torch.zeros((G,), dtype=I32, device=device),
        hb=torch.zeros((G,), dtype=I32, device=device),
        sever=torch.zeros((G,), dtype=torch.bool, device=device),
    )


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
    """Clear the allocator bits of ``slots`` where ``mask`` (local
    free)."""
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


# ---------------------------------------------------------------------------
# Host-side control plane (eager)
# ---------------------------------------------------------------------------
def effective_alive(data) -> np.ndarray:
    """True data-server liveness: a severed server is dead whatever the
    client's routing view says."""
    return data.alive.cpu().numpy() & ~data.sever.cpu().numpy()


def device_counters(data: DataPlane) -> dict:
    """The value plane's device counters as host ints (snapshot time
    only): live data servers, heartbeat total, frees rejected by a full
    free queue (``fq_spill``) and the free queues' pending entries."""
    return {
        "live_data_servers": int(data.alive.sum()),
        "data_heartbeats": int(data.hb.sum()),
        "fq_spill": int(data.fq_spill.sum()),
        "freeq_pending": int(lg.pending_count(data.freeq).sum()),
    }


def drain_pair(srt, blog, cfg):
    """Apply ALL pending entries of one (sorted, log) pair: the drain
    primitive every control-plane pass shares."""
    while int(lg.pending_count(blog)) > 0:
        keys, addrs, ops, blog = lg.take_pending(blog, cfg.async_apply_batch)
        srt = kops.merge(cfg, srt, keys, addrs, ops)
    return srt, blog


def drain_all_logs(store, cfg, apply_fn=None):
    """Apply every pending backup-log entry of every replica: the
    serializability barrier in front of every control-plane pass.
    ``apply_fn`` (store -> store), when given, is the store's
    incremental apply op, run in rounds until the logs are empty;
    otherwise each (replica, holder) pair is drained on its own."""
    if int(lg.pending_count(store.blog).max()) == 0:
        return store        # already drained: one sync
    if apply_fn is not None:
        rounds = max(1, -(-cfg.log_capacity // cfg.async_apply_batch))
        for _ in range(rounds):
            store = apply_fn(store)
            if int(lg.pending_count(store.blog).max()) == 0:
                break
        return store
    R, G = store.blog.tail.shape
    pairs = [[drain_pair(tree.at(store.bsorted, r, h),
                         tree.at(store.blog, r, h), cfg)
              for h in range(G)] for r in range(R)]
    return store._replace(
        bsorted=tree.stack([[p[0] for p in row] for row in pairs]),
        blog=tree.stack([[p[1] for p in row] for row in pairs]))


def _group_items(store, cfg, g: int):
    """Live (keys, addrs) of group ``g`` as numpy, from its authority:
    the hash table when g's index server is alive, else the first live
    (drained) sorted replica.  Call on a drained store.  Liveness here
    is true liveness (alive minus severed)."""
    R, G = store.blog.tail.shape
    alive = store.alive.cpu().numpy() & ~store.sever.cpu().numpy()
    srt0 = None
    for r in range(R):
        h = (g + r + 1) % G
        if alive[h] or G == 1:
            srt0 = tree.at(store.bsorted, r, h)
            break
    if alive[g]:
        hs = tree.at(store.hash, g)
        if srt0 is not None:
            keys, _, valid = six.items(srt0)
            a_h, f_h, _ = kops.probe(cfg, hs, keys)
            # replica keys + hash addrs, when the two agree on the items
            if (int(hix.n_items(hs)) == int(valid.sum())
                    and bool((f_h | ~valid).all())):
                return keys[valid].cpu().numpy(), a_h[valid].cpu().numpy()
        # replicas lost or out of sync: the raw hash slots (addresses
        # only, no keys recoverable)
        return None, hs.addr[hix.valid_mask(hs)].cpu().numpy()
    if srt0 is None:
        return np.zeros((0,), np.int64), np.zeros((0,), np.int32)
    keys, addrs, valid = six.items(srt0)
    return keys[valid].cpu().numpy(), addrs[valid].cpu().numpy()


def _pending_free_addrs(freeq) -> np.ndarray:
    """All addresses sitting in the per-device free queues (host view)."""
    addrs = freeq.addrs.cpu().numpy()
    tail = freeq.tail.cpu().numpy()
    applied = freeq.applied.cpu().numpy()
    cap = addrs.shape[1]
    out = [addrs[d][(int(applied[d]) + np.arange(int(tail[d] - applied[d])))
                    % cap] for d in range(addrs.shape[0])]
    return np.concatenate(out) if out else np.zeros((0,), np.int32)


def keys_for_addrs(store, addrs: np.ndarray) -> np.ndarray:
    """The key stored with each address, from the live shard's key
    column, else a surviving key mirror: the paper's rebuild of the
    index from the data items.  Raises RecoveryError when an address's
    every data holder is dead."""
    G = int(store.alive.shape[0])
    dcap = int(store.data.vals.shape[1])
    Rv = int(store.data.kmirror.shape[0])
    dalive = effective_alive(store.data)
    dkeys = store.data.keys.cpu().numpy()
    kmir = store.data.kmirror.cpu().numpy()
    a = np.asarray(addrs, np.int64)
    s, j = a // dcap, a % dcap
    out = np.zeros((len(a),), dkeys.dtype)
    done = dalive[s]
    out[done] = dkeys[s[done], j[done]]
    for r in range(Rv):
        h = (s + r + 1) % G
        take = ~done & (h != s) & dalive[h]
        out[take] = kmir[r, h[take], j[take]]
        done |= take
    if not done.all():
        raise RecoveryError(
            group=-1, searched=[f"data shard {int(s[~done][0])}",
                                "key mirrors"],
            blockers=[f"data server {int(s[~done][0])}"])
    return out


def value_slot_audit(store, cfg, apply_fn=None) -> dict:
    """Value-slot accounting audit (eager):

      * every live index address maps to an allocated slot on its shard
        (``missing``; shards that are data-dead are skipped);
      * no address is referenced by two live index entries (``double``);
      * no allocated slot is orphaned: unreferenced and not pending in a
        free queue (``orphaned``);
      * no free was ever rejected by a full free queue (``fq_spill``).

    The JAX package counts orphans with a Python loop over the slots;
    here the referenced and pending slots are marked in bitmaps, which
    counts the same slots."""
    st = drain_all_logs(store, cfg, apply_fn)
    G = int(st.alive.shape[0])
    dcap = int(st.data.vals.shape[1])
    dalive = effective_alive(st.data)
    used = st.data.used.cpu().numpy()
    refs = np.concatenate([np.asarray(_group_items(st, cfg, g)[1], np.int64)
                           for g in range(G)])
    refs = refs[refs >= 0]
    uniq, counts = np.unique(refs, return_counts=True)
    double = int((counts > 1).sum())
    shard, slot = uniq // dcap, uniq % dcap
    live_shard = dalive[shard]
    missing = int((~used[shard[live_shard], slot[live_shard]]).sum())
    pending = np.unique(_pending_free_addrs(st.data.freeq).astype(np.int64))
    marked = np.zeros(G * dcap, bool)
    for a in (uniq, pending):
        marked[a[(a >= 0) & (a < G * dcap)]] = True
    marked = marked.reshape(G, dcap)
    orphaned = int((used & ~marked)[dalive].sum())
    spill = int(st.data.fq_spill.sum())
    return {"group": -1, "replica": -1, "holder": -1, "kind": "value_slots",
            "live": int(len(uniq)), "pending_free": int(len(pending)),
            "double": double, "missing": missing, "orphaned": orphaned,
            "fq_spill": spill,
            "agree": double == 0 and missing == 0 and orphaned == 0
            and spill == 0}
