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
    """Live (keys, addrs) of group ``g`` as tensors on the store's
    device, from its authority: the hash table when g's index server is
    alive, else the first live (drained) sorted replica.  Call on a
    drained store.  Liveness here is true liveness (alive minus
    severed).  ``keys`` is None when only the raw hash slots answer."""
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
                return keys[valid], a_h[valid]
        # replicas lost or out of sync: the raw hash slots (addresses
        # only, no keys recoverable)
        return None, hs.addr[hix.valid_mask(hs)]
    dev = store.alive.device
    if srt0 is None:
        return (torch.zeros((0,), dtype=torch.int64, device=dev),
                torch.zeros((0,), dtype=I32, device=dev))
    keys, addrs, valid = six.items(srt0)
    return keys[valid], addrs[valid]


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
    refs = np.concatenate([_group_items(st, cfg, g)[1].cpu().numpy()
                           .astype(np.int64) for g in range(G)])
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


def group_items_from_data(store, cfg, g: int, owner_group_fn):
    """Last-resort rebuild authority: every allocated slot on every live
    data shard with its stored key, kept where the key is owned by group
    ``g`` (``owner_group_fn`` is the routing hash, injected to keep this
    module independent of kvstore), as numpy (keys, addrs) in address
    order.  Slots whose free is still pending in a queue are logically
    dead and excluded.  Raises RecoveryError when a dead data shard
    could be hiding slots.  The JAX package walks the slots in a Python
    loop; here one mask over the [G * dcap] slots gives the same pairs
    in the same order."""
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
    live = store.data.used.reshape(-1).clone()
    pend = torch.as_tensor(
        _pending_free_addrs(store.data.freeq).astype(np.int64), device=dev)
    live[pend[(pend >= 0) & (pend < G * dcap)]] = False
    ads = torch.nonzero(live).flatten()
    ks = store.data.keys.reshape(-1)[ads]
    sel = owner_group_fn(ks, G) == g
    return ks[sel].cpu().numpy(), ads[sel].to(I32).cpu().numpy()


def _wipe_data_state(data: DataPlane, dev: int) -> DataPlane:
    """Destroy the data-plane state device ``dev`` held: its shard, every
    mirror it hosts, and its pending free queue (the crash's data loss).
    A new state: the old one is unchanged."""
    every = slice(None)
    return data._replace(
        vals=tree.put_leaf(data.vals, 0, dev),
        used=tree.put_leaf(data.used, False, dev),
        mirror=tree.put_leaf(data.mirror, 0, every, dev),
        keys=tree.put_leaf(data.keys, 0, dev),
        kmirror=tree.put_leaf(data.kmirror, 0, every, dev),
        freeq=tree.put(data.freeq, lg.clear(tree.at(data.freeq, dev)), dev))


def fail_data_server(store, dev: int, wipe: bool = True):
    """Oracle kill switch for the value plane: mask device ``dev``'s DATA
    server dead with the client told at once, a failure domain separate
    from the index server (paper §2).  ``wipe`` (default) destroys the
    shard, the mirrors it hosts and its pending free queue, so recovery
    must rebuild from surviving mirrors; leaked frees are reclaimed by
    the recovery's mark-sweep."""
    data = store.data._replace(
        alive=tree.put_leaf(store.data.alive, False, dev))
    if wipe:
        data = _wipe_data_state(data, dev)
    return store._replace(data=data)


def sever_data_server(store, dev: int, wipe: bool = True):
    """Crash device ``dev``'s DATA server without telling the client: its
    shard state is destroyed (``wipe``) and its heartbeats stop, but
    ``data.alive``, the client's routing view, still says up.  Local
    value writes there are rejected, reads fail over to the mirrors per
    op, and the lease detector demotes the device once its data
    heartbeat stalls."""
    data = store.data._replace(
        sever=tree.put_leaf(store.data.sever, True, dev))
    if wipe:
        data = _wipe_data_state(data, dev)
    return store._replace(data=data)


def sweep(store, cfg, apply_fn=None):
    """Mark-sweep GC reconciliation: on every live data shard ``used``
    becomes exactly the slot set referenced by live index entries; the
    free queues are superseded and cleared (fixes slot leaks from free
    queues lost in a data-server crash)."""
    st = drain_all_logs(store, cfg, apply_fn)
    G = int(st.alive.shape[0])
    dcap = int(st.data.vals.shape[1])
    dev = st.data.used.device
    marked = torch.zeros((G * dcap,), dtype=torch.bool, device=dev)
    for g in range(G):
        _, addrs = _group_items(st, cfg, g)
        addrs = addrs.to(torch.int64)
        marked[addrs[addrs >= 0]] = True
    dalive = torch.as_tensor(effective_alive(st.data), device=dev)
    used = torch.where(dalive[:, None], marked.view(G, dcap), st.data.used)
    return st._replace(data=st.data._replace(
        used=used, freeq=lg.clear(st.data.freeq)))


def recover_data_server(store, dev: int, cfg, apply_fn=None):
    """Recover device ``dev``'s data server (host-side control plane):

      1. restore the shard from the first surviving mirror copy;
      2. re-clone every mirror ``dev`` hosts from the live shard (or a
         surviving mirror) of the same group;
      3. mark-sweep the allocator bitmaps against the live index (also
         reclaims frees leaked when the crash dropped ``dev``'s queue);
      4. flip ``data.alive[dev]`` and clear a severed heartbeat, so the
         recovered server leases normally again.
    """
    G = int(store.alive.shape[0])
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
        src = None
        for r in range(Rv):
            h = (dev + r + 1) % G
            if h != dev and dalive[h]:
                src = (r, h)
                break
        if src is None:
            raise RecoveryError(group=dev,
                                searched=[f"mirror {r} on device "
                                          f"{(dev + r + 1) % G}"
                                          for r in range(Rv)],
                                blockers=[])
        data = data._replace(
            vals=tree.put_leaf(data.vals, data.mirror[src], dev),
            keys=tree.put_leaf(data.keys, data.kmirror[src], dev))
        for r in range(Rv):
            s = (dev - r - 1) % G
            if s == dev:
                continue
            if dalive[s]:
                data = data._replace(
                    mirror=tree.put_leaf(data.mirror, data.vals[s], r, dev),
                    kmirror=tree.put_leaf(data.kmirror, data.keys[s], r,
                                          dev))
            else:
                for r2 in range(Rv):
                    h2 = (s + r2 + 1) % G
                    if h2 != dev and dalive[h2]:
                        data = data._replace(
                            mirror=tree.put_leaf(data.mirror,
                                                 data.mirror[r2, h2], r, dev),
                            kmirror=tree.put_leaf(data.kmirror,
                                                  data.kmirror[r2, h2], r,
                                                  dev))
                        break
    data = data._replace(alive=tree.put_leaf(data.alive, True, dev))
    return sweep(store._replace(data=data), cfg, apply_fn)


def migrate_values(store, cfg, owner_group_fn, apply_fn=None):
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
    for device 0's free queue."""
    st = drain_all_logs(store, cfg, apply_fn)
    G = int(st.alive.shape[0])
    R = int(st.blog.tail.shape[0])
    dcap = int(st.data.vals.shape[1])
    Rv = int(st.data.mirror.shape[0])
    dalive = effective_alive(st.data)
    data = st.data
    dev = data.used.device
    # flush pending frees first so their slots are reusable for homing
    used = data.used.clone()
    pend = _pending_free_addrs(data.freeq).astype(np.int64)
    ps = pend // dcap
    here = dalive[ps % G]
    used[torch.as_tensor(ps[here] % G, device=dev),
         torch.as_tensor(pend[here] % dcap, device=dev)] = False
    kept_frees = [pend[~here]]
    freeq = lg.clear(data.freeq)
    vals, mirror = data.vals.clone(), data.mirror.clone()
    dkeys, kmir = data.keys.clone(), data.kmirror.clone()
    # the index leaves are copied once and patched in place below
    hash_t = type(st.hash)(*[a.clone() for a in st.hash])
    baddrs = st.bsorted.addrs.clone()
    alive_idx = st.alive.cpu().numpy()
    # the first live mirror holder of each shard (-1: none)
    first_mirror = np.full((G,), -1, np.int64)
    for s in range(G):
        for r in range(Rv):
            if dalive[(s + r + 1) % G]:
                first_mirror[s] = r
                break
    moved = 0
    for g in range(G):
        if not dalive[g]:
            continue                     # home shard down: nothing to do yet
        keys, addrs = _group_items(st, cfg, g)
        if keys is None or len(keys) == 0:
            continue
        addrs = addrs.to(torch.int64)
        own = owner_group_fn(keys, G)
        stale = (addrs >= 0) & (addrs // dcap != g) & (own == g)
        mk, ma = keys[stale], addrs[stale]
        if not len(ma):
            continue
        # read each stranded value: the shard's copy, else the first
        # surviving mirror; a value with no live copy stays in place
        s_np = (ma // dcap).cpu().numpy()
        s, j = ma // dcap, ma % dcap
        on_shard = torch.as_tensor(dalive[s_np], device=dev)
        r_m = torch.as_tensor(first_mirror[s_np], device=dev)
        okv = on_shard | (r_m >= 0)
        r_c = torch.clamp(r_m, min=0)
        vv = torch.where(on_shard[:, None], vals[s, j],
                         mirror[r_c, (s + r_c + 1) % G, j])
        free_home = torch.nonzero(~used[g]).flatten()
        take = torch.nonzero(okv).flatten()
        n = min(int(take.shape[0]), int(free_home.shape[0]))
        if n == 0:
            continue
        take = take[:n]                  # partial migration if home is full
        new_slots = free_home[:n]
        mk, ma, vv = mk[take], ma[take], vv[take]
        vals[g, new_slots] = vv
        dkeys[g, new_slots] = mk
        used[g, new_slots] = True
        for r in range(Rv):
            h = (g + r + 1) % G
            if dalive[h]:
                mirror[r, h, new_slots] = vv
                kmir[r, h, new_slots] = mk
        ms = (ma // dcap).cpu().numpy()
        back = dalive[ms]
        used[ma[torch.as_tensor(back, device=dev)] // dcap,
             ma[torch.as_tensor(back, device=dev)] % dcap] = False
        kept_frees.append(ma.cpu().numpy()[~back])
        new_addrs = (g * dcap + new_slots).to(I32)
        if bool(alive_idx[g]):
            hs, _ = hix.insert(tree.at(hash_t, g), mk, new_addrs, cfg)
            for leaf, v in zip(hash_t, hs):
                leaf[g] = v
        for r in range(R):
            h = (g + r + 1) % G
            skeys = st.bsorted.keys[r, h]
            cap = skeys.shape[0]
            pos = torch.searchsorted(skeys, mk)             # left side
            hit = skeys[torch.clamp(pos, 0, cap - 1)] == mk
            baddrs[r, h] = drop_set(baddrs[r, h],
                                    torch.where(hit, pos, cap), new_addrs)
        moved += n
    kept = np.concatenate(kept_frees)
    if len(kept):
        ka = torch.as_tensor(kept.astype(np.int32), device=dev)
        fq0, _ = lg.append(tree.at(freeq, 0),
                           torch.zeros_like(ka, dtype=freeq.keys.dtype), ka,
                           torch.ones_like(ka, dtype=torch.int8))
        freeq = tree.put(freeq, fq0, 0)
    data = data._replace(vals=vals, used=used, mirror=mirror, freeq=freeq,
                         keys=dkeys, kmirror=kmir)
    return (st._replace(hash=hash_t, bsorted=st.bsorted._replace(
        addrs=baddrs), data=data), moved)
