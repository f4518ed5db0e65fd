"""Data-server subsystem: the value plane of the store (port of
``repro/core/data_plane.py``).

  * **Slot allocator + GC** — every data shard tracks its slots with a
    ``used`` bitmap.  PUT allocates the lowest free slots; DELETE and
    overwrite free the old slot (the paper's data-server GC), so a
    long-running store reuses capacity.  Frees that target another
    device's shard ride a per-device free queue (an ``UpdateLog`` ring)
    until the routed ``gc`` op flushes them home.
  * **Value replication** — each shard is mirrored on the next
    ``cfg.n_value_replicas`` devices (shifted layout, like the index
    backup logs: ``mirror[r, p]`` holds the copy of shard
    ``(p - r - 1) mod G``).  ``fail_data_server`` wipes a device's shard
    and the mirrors it hosts; ``recover_data_server`` rebuilds from a
    surviving mirror and mark-sweeps the allocator (``sweep``) against
    the live index.
  * **Value migration** — ``migrate_values`` moves values written off
    their home shard during degraded writes back home and patches the
    index addresses (hash + every sorted replica), so GETs are one-RTT
    again (``GetResult.hops`` back to 1).
  * **Audits** — the host-side drain barrier (``drain_all_logs``),
    ``value_slot_audit`` and the last-resort rebuild authority
    ``group_items_from_data`` (the keys stored with the data items).

The control-plane passes are eager and host-coordinated, as the JAX
package's are; where JAX loops in Python over addresses or slots, the
port runs the same step as tensor operations on the store's device.
Over W ranks a rank holds the shards of its L groups ([L] leaves;
``alive`` and ``sever`` replicated [G]); the audits read gathered state
through the store's ``Comm``, the migration homes each group's strays
on its owner, a failure wipes on the failed server's owner, the sweep
sends each live address to its shard's owner, and a recovery moves the
shard's copies from their holders' owners to its own.
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
from repro_torch.core.comm import Comm
from repro_torch.core.hashing import I32
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
    # L shards a rank (L = G on one process); alive and sever replicated
    vals: torch.Tensor     # [L, dcap, W] int32   primary copy of each shard
    used: torch.Tensor     # [L, dcap] bool       slot allocator bitmap
    mirror: torch.Tensor   # [Rv, L, dcap, W]     mirror[r, p] holds the
    #                        copy of shard (p - r - 1) mod G
    freeq: lg.UpdateLog    # leaves [L, fq]       pending remote frees
    alive: torch.Tensor    # [G] bool             data-server liveness
    keys: torch.Tensor     # [L, dcap]            key stored with each slot
    kmirror: torch.Tensor  # [Rv, L, dcap]        key copies, like mirror
    fq_spill: torch.Tensor  # [L] int32           frees a full queue rejected
    hb: torch.Tensor       # [L] int32            data-server heartbeats
    sever: torch.Tensor    # [G] bool             crashed, not yet detected


# the group axis of each leaf (None: replicated [G])
GROUP_AXES = DataPlane(vals=0, used=0, mirror=1, freeq=0, alive=None,
                       keys=0, kmirror=1, fq_spill=0, hb=0, sever=None)


def create(G: int, dcap: int, cfg, device, L=None,
           key_dtype=I32) -> DataPlane:
    """The value plane of G groups, the L (default G) of one rank; the
    slots' keys, their mirrors and the free queues at ``key_dtype``, the
    store's key width, as JAX's ``create(..., key_dt)``."""
    W, Rv = cfg.value_words, cfg.n_value_replicas
    L = G if L is None else L
    return DataPlane(
        vals=torch.zeros((L, dcap, W), dtype=I32, device=device),
        used=torch.zeros((L, dcap), dtype=torch.bool, device=device),
        mirror=torch.zeros((Rv, L, dcap, W), dtype=I32, device=device),
        freeq=tree.replicate(lg.create(cfg.log_capacity, device, key_dtype),
                             L),
        alive=torch.ones((G,), dtype=torch.bool, device=device),
        keys=torch.zeros((L, dcap), dtype=key_dtype, device=device),
        kmirror=torch.zeros((Rv, L, dcap), dtype=key_dtype, device=device),
        fq_spill=torch.zeros((L,), dtype=I32, device=device),
        hb=torch.zeros((L,), dtype=I32, device=device),
        sever=torch.zeros((G,), dtype=torch.bool, device=device),
    )


def store_comm(store, comm=None):
    """``comm``, else the one-process comm of a store whose sharded
    leaves hold every group; a store sharded over ranks must come with
    its comm."""
    if comm is not None:
        return comm
    d = store.data
    G, L = int(d.alive.shape[0]), int(d.hb.shape[0])
    if L != G:
        raise ValueError(f"a store sharded {L} of {G} groups a rank needs "
                         "its comm")
    return Comm.single(G)


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


def device_counters(data: DataPlane, comm=None) -> dict:
    """The value plane's device counters as host ints (snapshot time
    only): live data servers, heartbeat total, frees rejected by a full
    free queue (``fq_spill``) and the free queues' pending entries, the
    totals summed over ``comm``'s ranks."""
    cm = comm if comm is not None else Comm.single(int(data.alive.shape[0]))
    return {
        "live_data_servers": int(data.alive.sum()),
        "data_heartbeats": int(cm.agree(data.hb.sum(), "sum")),
        "fq_spill": int(cm.agree(data.fq_spill.sum(), "sum")),
        "freeq_pending": int(cm.agree(lg.pending_count(data.freeq).sum(),
                                      "sum")),
    }


def drain_pair(srt, blog, cfg):
    """Apply ALL pending entries of one (sorted, log) pair: the drain
    primitive every control-plane pass shares."""
    while int(lg.pending_count(blog)) > 0:
        keys, addrs, ops, blog = lg.take_pending(blog, cfg.async_apply_batch)
        srt = kops.merge(cfg, srt, keys, addrs, ops)
    return srt, blog


def drain_all_logs(store, cfg, apply_fn=None, comm=None):
    """Apply every pending backup-log entry of every replica: the
    serializability barrier in front of every control-plane pass.
    ``apply_fn`` (store -> store), when given, is the store's
    incremental apply op, run in rounds until the logs are empty;
    otherwise each (replica, holder) pair is drained on its own.  Over
    ranks each rank drains its own holders, for as many apply rounds as
    the ranks agree on (every round bumps the heartbeats, as on one
    process)."""
    cm = store_comm(store, comm)

    def pending():
        return int(cm.agree(lg.pending_count(store.blog).max(), "max"))

    if pending() == 0:
        return store        # already drained: one sync
    if apply_fn is not None:
        rounds = max(1, -(-cfg.log_capacity // cfg.async_apply_batch))
        for _ in range(rounds):
            store = apply_fn(store)
            if pending() == 0:
                break
        return store
    R, L = store.blog.tail.shape
    pairs = [[drain_pair(tree.at(store.bsorted, r, h),
                         tree.at(store.blog, r, h), cfg)
              for h in range(L)] for r in range(R)]
    return store._replace(
        bsorted=tree.stack([[p[0] for p in row] for row in pairs]),
        blog=tree.stack([[p[1] for p in row] for row in pairs]))


def _items_from(cfg, hs, srt0, dev):
    """Live (keys, addrs) of one group from its authority: its hash
    table ``hs`` (None: its index server is dead) checked against its
    first live drained sorted replica ``srt0`` (None: no live holder),
    else that replica.  ``keys`` is None when only the raw hash slots
    answer."""
    if hs is not None:
        if srt0 is not None:
            keys, _, valid = six.items(srt0)
            a_h, f_h, _ = kops.probe(cfg, hs, keys)
            # replica keys + hash addrs, when the two agree on the items
            if (int(hix.n_items(hs)) == int(valid.sum())
                    and bool((f_h | ~valid).all())):
                return keys[valid], a_h[valid]
        # replicas lost or out of sync: the raw hash slots (addresses
        # only, no keys recoverable)
        return None, hs.addr[hix.valid_mask(hs)]
    if srt0 is None:
        return (torch.zeros((0,), dtype=torch.int64, device=dev),
                torch.zeros((0,), dtype=I32, device=dev))
    keys, addrs, valid = six.items(srt0)
    return keys[valid], addrs[valid]


def _first_live_replica(g: int, alive, R: int, G: int):
    """The first replica r whose holder g + r + 1 is alive (None: none)."""
    return next((r for r in range(R) if alive[(g + r + 1) % G] or G == 1),
                None)


def _group_items(store, cfg, g: int, comm=None):
    """Live (keys, addrs) of group ``g`` as tensors on the store's
    device, from its authority (``_items_from``): the hash table when
    g's index server is alive, else the first live (drained) sorted
    replica.  Call on a drained store.  Liveness here is true liveness
    (alive minus severed).  Over ranks every rank reads the group from
    its owners."""
    cm = store_comm(store, comm)
    R, G = store.blog.tail.shape[0], cm.G
    alive = store.alive.cpu().numpy() & ~store.sever.cpu().numpy()
    r = _first_live_replica(g, alive, R, G)
    srt0 = (None if r is None else
            cm.group_leaves(tree.at(store.bsorted, r), (g + r + 1) % G))
    hs = cm.group_leaves(store.hash, g) if alive[g] else None
    return _items_from(cfg, hs, srt0, store.alive.device)


def _own_group_items(store, cfg, cm):
    """``_group_items`` of each of this rank's L groups, read where they
    live: the hash rows are local, and each group's first live replica
    comes home from its holder g + r + 1 by a shift of -(r + 1) (one
    shift per replica index in use)."""
    R, G = store.blog.tail.shape[0], cm.G
    alive = store.alive.cpu().numpy() & ~store.sever.cpu().numpy()
    first = [_first_live_replica(g, alive, R, G) for g in range(G)]
    home = {r: type(store.bsorted)(*[cm.shift(x, -(r + 1)) for x in
                                     tree.at(store.bsorted, r)])
            for r in sorted(set(first) - {None})}
    out = []
    for i in range(cm.L):
        g = cm.g0 + i
        r = first[g]
        out.append(_items_from(
            cfg, tree.at(store.hash, i) if alive[g] else None,
            None if r is None else tree.at(home[r], i), store.alive.device))
    return out


def _pending_free_addrs(freeq) -> np.ndarray:
    """All addresses sitting in the per-device free queues (host view)."""
    addrs = freeq.addrs.cpu().numpy()
    tail = freeq.tail.cpu().numpy()
    applied = freeq.applied.cpu().numpy()
    cap = addrs.shape[1]
    out = [addrs[d][(int(applied[d]) + np.arange(int(tail[d] - applied[d])))
                    % cap] for d in range(addrs.shape[0])]
    return np.concatenate(out) if out else np.zeros((0,), np.int32)


def keys_for_addrs(store, addrs: np.ndarray, comm=None) -> np.ndarray:
    """The key stored with each address, from the live shard's key
    column, else a surviving key mirror: the paper's rebuild of the
    index from the data items.  Raises RecoveryError when an address's
    every data holder is dead.  Over ranks it reads the gathered key
    columns."""
    cm = store_comm(store, comm)
    G = int(store.alive.shape[0])
    dcap = int(store.data.vals.shape[1])
    Rv = int(store.data.kmirror.shape[0])
    dalive = effective_alive(store.data)
    dkeys = cm.all_gather(store.data.keys).cpu().numpy()
    kmir = cm.all_gather(store.data.kmirror, 1).cpu().numpy()
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


def value_slot_audit(store, cfg, apply_fn=None, comm=None) -> dict:
    """Value-slot accounting audit (eager):

      * every live index address maps to an allocated slot on its shard
        (``missing``; shards that are data-dead are skipped);
      * no address is referenced by two live index entries (``double``);
      * no allocated slot is orphaned: unreferenced and not pending in a
        free queue (``orphaned``);
      * no free was ever rejected by a full free queue (``fq_spill``).

    The JAX package counts orphans with a Python loop over the slots;
    here the referenced and pending slots are marked in bitmaps, which
    counts the same slots.  Over ranks it reads gathered state and every
    rank returns the same entry."""
    cm = store_comm(store, comm)
    st = drain_all_logs(store, cfg, apply_fn, cm)
    G = int(st.alive.shape[0])
    dcap = int(st.data.vals.shape[1])
    dalive = effective_alive(st.data)
    used = cm.all_gather(st.data.used).cpu().numpy()
    refs = np.concatenate([_group_items(st, cfg, g, cm)[1].cpu().numpy()
                           .astype(np.int64) for g in range(G)])
    refs = refs[refs >= 0]
    uniq, counts = np.unique(refs, return_counts=True)
    double = int((counts > 1).sum())
    shard, slot = uniq // dcap, uniq % dcap
    live_shard = dalive[shard]
    missing = int((~used[shard[live_shard], slot[live_shard]]).sum())
    pending = np.unique(_pending_free_addrs(
        cm.gather_tree(st.data.freeq)).astype(np.int64))
    marked = np.zeros(G * dcap, bool)
    for a in (uniq, pending):
        marked[a[(a >= 0) & (a < G * dcap)]] = True
    marked = marked.reshape(G, dcap)
    orphaned = int((used & ~marked)[dalive].sum())
    spill = int(cm.agree(st.data.fq_spill.sum(), "sum"))
    return {"group": -1, "replica": -1, "holder": -1, "kind": "value_slots",
            "live": int(len(uniq)), "pending_free": int(len(pending)),
            "double": double, "missing": missing, "orphaned": orphaned,
            "fq_spill": spill,
            "agree": double == 0 and missing == 0 and orphaned == 0
            and spill == 0}


def group_items_from_data(store, cfg, g: int, owner_group_fn, comm=None):
    """Last-resort rebuild authority: every allocated slot on every live
    data shard with its stored key, kept where the key is owned by group
    ``g`` (``owner_group_fn`` is the routing hash, injected to keep this
    module independent of kvstore), as numpy (keys, addrs) in address
    order.  Slots whose free is still pending in a queue are logically
    dead and excluded.  Raises RecoveryError when a dead data shard
    could be hiding slots.  The JAX package walks the slots in a Python
    loop; here one mask over the [G * dcap] slots gives the same pairs
    in the same order.  Over ranks it reads the gathered shards."""
    cm = store_comm(store, comm)
    G = int(store.alive.shape[0])
    dcap = int(store.data.vals.shape[1])
    dalive = effective_alive(store.data)
    dead_shards = [int(s) for s in range(G) if not dalive[s]]
    if dead_shards:
        raise RecoveryError(
            group=g,
            searched=["sorted replicas", "hash", "data-plane slots"],
            blockers=[f"data server {s}" for s in dead_shards])
    dev = store.data.used.device
    live = cm.all_gather(store.data.used).reshape(-1).clone()
    dkeys = cm.all_gather(store.data.keys)
    pend = torch.as_tensor(
        _pending_free_addrs(cm.gather_tree(store.data.freeq))
        .astype(np.int64), device=dev)
    live[pend[(pend >= 0) & (pend < G * dcap)]] = False
    ads = torch.nonzero(live).flatten()
    ks = dkeys.reshape(-1)[ads]
    sel = owner_group_fn(ks, G) == g
    return ks[sel].cpu().numpy(), ads[sel].to(I32).cpu().numpy()


def _wipe_data_state(data: DataPlane, dev: int, cm) -> DataPlane:
    """Destroy the data-plane state device ``dev`` held: its shard, every
    mirror it hosts, and its pending free queue (the crash's data loss).
    A new state: the old one is unchanged.  Only ``dev``'s owner rank
    holds it."""
    if not cm.owns(dev):
        return data
    every = slice(None)
    return data._replace(
        vals=tree.put_leaf(data.vals, 0, dev, comm=cm),
        used=tree.put_leaf(data.used, False, dev, comm=cm),
        mirror=tree.put_leaf(data.mirror, 0, every, dev, comm=cm),
        keys=tree.put_leaf(data.keys, 0, dev, comm=cm),
        kmirror=tree.put_leaf(data.kmirror, 0, every, dev, comm=cm),
        freeq=tree.put(data.freeq, lg.clear(tree.at(data.freeq, dev,
                                                    comm=cm)),
                       dev, comm=cm))


def fail_data_server(store, dev: int, wipe: bool = True, comm=None):
    """Oracle kill switch for the value plane: mask device ``dev``'s DATA
    server dead with the client told at once, a failure domain separate
    from the index server (paper §2).  ``wipe`` (default) destroys the
    shard, the mirrors it hosts and its pending free queue, so recovery
    must rebuild from surviving mirrors; leaked frees are reclaimed by
    the recovery's mark-sweep.  Over ranks the replicated ``alive``
    flips on every rank and ``dev``'s owner wipes its rows."""
    data = store.data._replace(
        alive=tree.put_leaf(store.data.alive, False, dev))
    if wipe:
        data = _wipe_data_state(data, dev, store_comm(store, comm))
    return store._replace(data=data)


def sever_data_server(store, dev: int, wipe: bool = True, comm=None):
    """Crash device ``dev``'s DATA server without telling the client: its
    shard state is destroyed (``wipe``) and its heartbeats stop, but
    ``data.alive``, the client's routing view, still says up.  Local
    value writes there are rejected, reads fail over to the mirrors per
    op, and the lease detector demotes the device once its data
    heartbeat stalls.  Over ranks as ``fail_data_server``."""
    data = store.data._replace(
        sever=tree.put_leaf(store.data.sever, True, dev))
    if wipe:
        data = _wipe_data_state(data, dev, store_comm(store, comm))
    return store._replace(data=data)


def sweep(store, cfg, apply_fn=None, comm=None):
    """Mark-sweep GC reconciliation: on every live data shard ``used``
    becomes exactly the slot set referenced by live index entries; the
    free queues are superseded and cleared (fixes slot leaks from free
    queues lost in a data-server crash).

    Each rank reads its own groups' items (``_own_group_items``); their
    addresses point into any shard, so each goes to its shard's owner
    (``Comm.to_owners``: 4 bytes a live item, where an all-reduce of the
    [G, dcap] bitmap would move the whole capacity), which marks and
    writes its own live shards."""
    cm = store_comm(store, comm)
    st = drain_all_logs(store, cfg, apply_fn, cm)
    L, dcap = cm.L, int(st.data.vals.shape[1])
    dev = st.data.used.device
    addrs = torch.cat([a.to(I32) for _, a in _own_group_items(st, cfg, cm)])
    addrs = addrs[addrs >= 0]
    addrs = cm.to_owners(addrs, torch.div(addrs, dcap,
                                          rounding_mode="floor"))
    marked = torch.zeros((L * dcap,), dtype=torch.bool, device=dev)
    marked[addrs.long() - cm.g0 * dcap] = True
    dalive = torch.as_tensor(cm.loc(effective_alive(st.data)), device=dev)
    used = torch.where(dalive[:, None], marked.view(L, dcap), st.data.used)
    return st._replace(data=st.data._replace(
        used=used, freeq=lg.clear(st.data.freeq)))


def recover_data_server(store, dev: int, cfg, apply_fn=None, comm=None):
    """Recover device ``dev``'s data server (host-side control plane):

      1. restore the shard from the first surviving mirror copy;
      2. re-clone every mirror ``dev`` hosts from the live shard (or a
         surviving mirror) of the same group;
      3. mark-sweep the allocator bitmaps against the live index (also
         reclaims frees leaked when the crash dropped ``dev``'s queue);
      4. flip ``data.alive[dev]`` and clear a severed heartbeat, so the
         recovered server leases normally again.

    Every source is chosen from the replicated liveness, so each rank
    takes the same plan, and RecoveryError (no live mirror) is raised on
    every rank before anything is written.  Over ranks each copy travels
    from its holder's owner to ``dev``'s owner (``Comm.move``: the
    shard and a mirror a value replica, with their key columns), which
    writes them."""
    cm = store_comm(store, comm)
    G = cm.G
    Rv = int(store.data.mirror.shape[0])
    dalive = effective_alive(store.data)
    if bool(dalive[dev]):
        return store
    # the recovered server heartbeats again; the rebuild below reads
    # true liveness, so a severed-but-undetected sibling is never a source
    store = store._replace(data=store.data._replace(
        sever=tree.put_leaf(store.data.sever, False, dev)))
    dalive = dalive.copy()
    dalive[dev] = False
    data = store.data
    if G > 1:
        def holder(s):
            """The first live holder (r, h) of a mirror of shard s,
            ``dev`` aside (None: none)."""
            return next(((r, (s + r + 1) % G) for r in range(Rv)
                         if (s + r + 1) % G != dev
                         and dalive[(s + r + 1) % G]), None)

        def mirror_of(r, h):          # (values, keys) of mirror r on h
            if not cm.owns(h):
                return None
            return data.mirror[r, cm.local(h)], data.kmirror[r, cm.local(h)]

        src = holder(dev)
        if src is None:
            raise RecoveryError(group=dev,
                                searched=[f"mirror {r} on device "
                                          f"{(dev + r + 1) % G}"
                                          for r in range(Rv)],
                                blockers=[])
        # (source group, the copy there, where it goes: None the shard,
        # else the mirror slot r that dev hosts)
        moves = [(src[1], mirror_of(*src), None)]
        for r in range(Rv):
            s = (dev - r - 1) % G
            if s == dev:
                continue
            if dalive[s]:
                moves.append((s, (data.vals[cm.local(s)],
                                  data.keys[cm.local(s)])
                              if cm.owns(s) else None, r))
            elif (h2 := holder(s)) is not None:
                moves.append((h2[1], mirror_of(*h2), r))
        got = cm.move([(a, dev, t) for a, t, _ in moves],
                      (data.vals[0], data.keys[0]))
        if cm.owns(dev):
            i = cm.local(dev)
            vals, keys = data.vals.clone(), data.keys.clone()
            mirror, kmirror = data.mirror.clone(), data.kmirror.clone()
            for (_, _, r), (v, k) in zip(moves, got):
                if r is None:
                    vals[i], keys[i] = v, k
                else:
                    mirror[r, i], kmirror[r, i] = v, k
            data = data._replace(vals=vals, keys=keys, mirror=mirror,
                                 kmirror=kmirror)
    data = data._replace(alive=tree.put_leaf(data.alive, True, dev))
    return sweep(store._replace(data=data), cfg, apply_fn, cm)


def migrate_values(store, cfg, owner_group_fn, apply_fn=None, comm=None):
    """Background value migration (second-hop fetch elision): move values
    that live off their owner group's shard, stranded there by degraded
    writes, back home, free the old slots, and patch the index
    addresses (hash + every sorted replica).  GETs after it are one-RTT
    again (``GetResult.hops == 1``).

    ``owner_group_fn(keys, G)`` is the routing hash; ``apply_fn`` the
    store's apply op (the barrier then runs as incremental apply
    rounds).  Returns (store, n_moved).  The groups go one after the
    other, as in the JAX package (a group's homing frees slots a later
    group may take); within a group the JAX package loops over the
    stranded addresses in Python, here one tensor step takes them all:
    the lowest free home slots in ascending order, a partial migration
    when the home shard is full, the frees of dead shards kept in order
    for device 0's free queue.

    Over W ranks each group is homed by its owner.  Every rank learns
    every group's stranded addresses (an all_gather of a few addresses a
    group) and replays the groups' order on the host: how many each
    group takes (its shard's free slots, plus those that earlier groups
    freed there) and which slots each frees.  That count needs each
    stranded slot allocated and referenced once, which the value-slot
    audit checks (no address missing or double).  The values come from
    the rank that holds each (a ``psum``), the new slots from each
    group's owner (an all_gather), and every rank writes only its own
    rows: shards, mirrors, hash tables and sorted replicas."""
    cm = store_comm(store, comm)
    st = drain_all_logs(store, cfg, apply_fn, cm)
    G, L, g0 = cm.G, cm.L, cm.g0
    R = int(st.blog.tail.shape[0])
    dcap = int(st.data.vals.shape[1])
    Rv = int(st.data.mirror.shape[0])
    dalive = effective_alive(st.data)
    data = st.data
    dev = data.used.device
    mine = (np.arange(G) >= g0) & (np.arange(G) < g0 + L)
    # flush pending frees first so their slots are reusable for homing
    used = data.used.clone()
    pend = _pending_free_addrs(cm.gather_tree(data.freeq)).astype(np.int64)
    ps = (pend // dcap) % G
    here = dalive[ps]
    flush = here & mine[ps]
    used[torch.as_tensor(ps[flush] - g0, device=dev),
         torch.as_tensor(pend[flush] % dcap, device=dev)] = False
    kept_frees = [pend[~here]]
    freeq = lg.clear(data.freeq)
    # the first live mirror holder of each shard (-1: none)
    first_mirror = np.full((G,), -1, np.int64)
    for sh in range(G):
        for r in range(Rv):
            if dalive[(sh + r + 1) % G]:
                first_mirror[sh] = r
                break
    # each own group's strays that have a live copy, in index order
    strays = []
    for i, (keys, addrs) in enumerate(_own_group_items(st, cfg, cm)):
        g = g0 + i
        if not dalive[g] or keys is None or len(keys) == 0:
            strays.append(None)           # home shard down, or no keys
            continue
        addrs = addrs.to(torch.int64)
        stale = ((addrs >= 0) & (addrs // dcap != g)
                 & (owner_group_fn(keys, G) == g))
        mk, ma = keys[stale], addrs[stale]
        sh = (ma // dcap).cpu().numpy()
        live = torch.as_tensor(dalive[sh] | (first_mirror[sh] >= 0),
                               device=dev)
        strays.append((mk[live], ma[live]))
    cnt = cm.all_gather(torch.tensor(
        [0 if x is None else int(x[1].shape[0]) for x in strays],
        dtype=torch.int64, device=dev)).cpu().numpy()
    width = int(cnt.max())
    kdt = st.bsorted.keys.dtype
    n = np.zeros((G,), np.int64)
    if width:
        K = torch.zeros((L, width), dtype=kdt, device=dev)
        A = torch.zeros((L, width), dtype=torch.int64, device=dev)
        for i, x in enumerate(strays):
            if x is not None:
                K[i, :x[0].shape[0]], A[i, :x[1].shape[0]] = x
        K, A = cm.all_gather(K), cm.all_gather(A)
        A_np = A.cpu().numpy()
        # the groups' order, replayed: a group takes the lowest free
        # slots of its shard (the stranded slots that earlier groups freed
        # there among them) and frees its strays' slots on live shards
        nfree = cm.all_gather((~used).sum(1)).cpu().numpy()
        freed = [[] for _ in range(G)]          # slots freed on each shard
        before = [np.zeros((0,), np.int64)] * G  # ... before its group ran
        for g in range(G):
            before[g] = np.asarray(freed[g], np.int64)
            n[g] = min(int(cnt[g]), int(nfree[g]) + len(freed[g]))
            a = A_np[g, :n[g]]
            back = dalive[a // dcap]
            for sh, j in zip(a[back] // dcap, a[back] % dcap):
                freed[sh].append(j)
            kept_frees.append(a[~back])
    moved = int(n.sum())
    if moved:
        # the values, from the rank that holds each (its shard, else its
        # first live mirror)
        tg = np.repeat(np.arange(G), n)
        tk = np.concatenate([np.arange(k) for k in n])
        ta = A_np[tg, tk]
        sh, j = ta // dcap, ta % dcap
        on = dalive[sh]
        rm = np.where(on, 0, first_mirror[sh])
        hg = np.where(on, sh, (sh + rm + 1) % G)
        vv = torch.zeros((len(ta), data.vals.shape[2]), dtype=data.vals.dtype,
                         device=dev)
        for src, pick in ((data.vals[None], on), (data.mirror, ~on)):
            sel = np.nonzero(pick & mine[hg])[0]
            vv[torch.as_tensor(sel, device=dev)] = src[
                torch.as_tensor(rm[sel], device=dev),
                torch.as_tensor(hg[sel] - g0, device=dev),
                torch.as_tensor(j[sel], device=dev)]
        vv = cm.psum(vv)
        start = np.concatenate([[0], np.cumsum(n)])
        # each own group's new home slots, the lowest free
        NS = torch.zeros((L, width), dtype=torch.int64, device=dev)
        for i in range(L):
            g = g0 + i
            if n[g]:
                fh = ~used[i]
                fh[torch.as_tensor(before[g], device=dev)] = True
                NS[i, :n[g]] = torch.nonzero(fh).flatten()[:n[g]]
        NS = cm.all_gather(NS)
        # the strays' old slots freed on own live shards
        for sh_ in np.nonzero(mine)[0]:
            if freed[sh_]:
                used[sh_ - g0, torch.as_tensor(np.asarray(freed[sh_]),
                                               device=dev)] = False
        vals, mirror = data.vals.clone(), data.mirror.clone()
        dkeys, kmir = data.keys.clone(), data.kmirror.clone()
        # the index leaves are copied once and patched in place below
        hash_t = type(st.hash)(*[a.clone() for a in st.hash])
        baddrs = st.bsorted.addrs.clone()
        alive_idx = st.alive.cpu().numpy()
        for g in np.nonzero(n)[0]:
            ns, mk = NS[g, :n[g]], K[g, :n[g]]
            v = vv[start[g]:start[g + 1]]
            new_addrs = (int(g) * dcap + ns).to(I32)
            if mine[g]:
                i = g - g0
                vals[i, ns], dkeys[i, ns], used[i, ns] = v, mk, True
                if bool(alive_idx[g]):
                    hs, _ = hix.insert(tree.at(hash_t, i), mk, new_addrs,
                                       cfg)
                    for leaf, x in zip(hash_t, hs):
                        leaf[i] = x
            for r in range(Rv):
                h = (g + r + 1) % G
                if dalive[h] and mine[h]:
                    mirror[r, h - g0, ns], kmir[r, h - g0, ns] = v, mk
            for r in range(R):
                h = (g + r + 1) % G
                if not mine[h]:
                    continue
                skeys = st.bsorted.keys[r, h - g0]
                cap = skeys.shape[0]
                pos = torch.searchsorted(skeys, mk)             # left side
                hit = skeys[torch.clamp(pos, 0, cap - 1)] == mk
                baddrs[r, h - g0] = drop_set(
                    baddrs[r, h - g0], torch.where(hit, pos, cap), new_addrs)
        st = st._replace(hash=hash_t, bsorted=st.bsorted._replace(
            addrs=baddrs))
        data = data._replace(vals=vals, mirror=mirror, keys=dkeys,
                             kmirror=kmir)
    kept = np.concatenate(kept_frees)
    if len(kept) and mine[0]:
        ka = torch.as_tensor(kept.astype(np.int32), device=dev)
        fq0, _ = lg.append(tree.at(freeq, 0),
                           torch.zeros_like(ka, dtype=freeq.keys.dtype), ka,
                           torch.ones_like(ka, dtype=torch.int8))
        freeq = tree.put(freeq, fq0, 0)
    return st._replace(data=data._replace(used=used, freeq=freeq)), moved
