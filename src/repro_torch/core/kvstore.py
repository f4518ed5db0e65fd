"""HiStore: the distributed key-value store over G index groups (port of
``repro/core/kvstore.py``).

Topology: group g's primary server holds its hash table, its primary log
and its data shard; the backup servers of groups g-1 and g-2 sit beside
it (the SHIFTED layout: slice [r, p] of a backup array holds replica r
of group (p - r - 1) mod G, so log replication is a shift by r + 1).

The JAX package runs one group per device under ``shard_map``.  Here a
``Comm`` (``comm.py``) places the groups: over W ranks of a process
group (one process a card) rank r holds the L = G / W groups [g0, g0 +
L), every sharded leaf stacked along a leading [L] axis ([R, L] for the
backups; ``alive`` and ``sever`` replicated [G]); on one process
(``Comm.single``, the default) L = G and all groups share one card.
Each op body is written out across that axis.  Between collectives it
runs the per-server work group by group on views of the stacked leaves
(the index ops take contiguous [g] views, so the kernels are the
single-group ones); the collectives are the Comm's: ``all_to_all`` its
exchange (one process: a transpose), ``ppermute`` its shift (a roll),
``all_gather`` its all_gather (the stacked tensor itself) and
``axis_index`` g0 plus the loop's index.  State is functional, as in
JAX: an op returns a new store.

Ops (``make_ops``): routed two-sided PUT and DELETE with log replication
to the live backups, and their degraded variants (the old-slot replica
probe at a temporary primary, one stacked group-probe call for the G
servers, and the one-hop value displacement off a dead data shard);
one-sided GET through the fused group probe with a second-hop
``fetch``; the all-gathered SCAN after a full drain; the async
``apply``, the free-queue ``gc`` and the heartbeat ``tick``.

The host-side control plane: ``fail_server`` wipes a server's index
state with the client told at once, ``sever_server`` wipes it and stops
its heartbeats (the client's lease detector must notice);
``recover_server`` rebuilds the hash and re-clones the replicas from
the survivors, online (the pending window streams in through the
ordinary apply rounds) or stop-the-world, falling back to the primary's
hash + the keys stored with the data items, then to a data-plane slot
scan, and raising RecoveryError only when no copy exists;
``re_replicate`` verifies every live holder against its group's
authority and rebuilds divergent copies.  Over ranks the control plane
reads a survivor through ``Comm.group_leaves`` (a broadcast from its
owner) and writes on the owner rank only.  The value plane's
``fail_data_server`` / ``sever_data_server`` / ``recover_data_server``
and ``migrate_values`` are ``data_plane.py``'s, over ranks too: a
failure wipes on the failed server's owner, a recovery moves the
shard's copies to its owner and sweeps the allocator there, and the
migration homes each group's strays on its owner.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import data_plane as dp
from repro_torch.core import hash_index as hix
from repro_torch.core import log as lg
from repro_torch.core import sorted_index as six
from repro_torch.core import tree
from repro_torch.core.comm import Comm
from repro_torch.core.hashing import I32, key_inf, owner_group
from repro_torch.core.scatter import drop_set, drop_set_rows
from repro_torch.core.verbs import route_build, route_return
from repro_torch.kernels import ops as kops

RecoveryError = dp.RecoveryError
store_comm = dp.store_comm


class KVStore(NamedTuple):
    hash: hix.HashIndex       # leaves [L, ...] (L = G on one process)
    plog: lg.UpdateLog        # leaves [L, ...]
    bsorted: six.SortedIndex  # leaves [R, L, ...] (shifted layout)
    blog: lg.UpdateLog        # leaves [R, L, ...]
    data: dp.DataPlane        # value plane (shard + allocator + mirrors)
    alive: torch.Tensor       # [G] bool, replicated: the client's routing
    #                           view of index-server liveness
    sever: torch.Tensor       # [G] bool, replicated: crashed, not yet
    #                           detected
    hb: torch.Tensor          # [L] int32 heartbeat counters


# the group axis of each leaf (None: replicated [G])
GROUP_AXES = KVStore(hash=0, plog=0, bsorted=1, blog=1, data=dp.GROUP_AXES,
                     alive=None, sever=None, hb=0)


def create(G: int, capacity_per_group: int, cfg, device, comm=None,
           key_dtype=I32) -> KVStore:
    """An empty store of G groups: all of them (one process), or the
    L = G / W of ``comm``'s rank.  ``key_dtype`` is the width of its
    keys in every state (logs, sorted replicas, the slots' keys): int32,
    or int64 as JAX's ``create(..., key_dt)`` under ``jax_enable_x64``."""
    cm = comm if comm is not None else Comm.single(G)
    if cm.G != G:
        raise ValueError(f"a store of {G} groups over a comm of {cm.G}")
    R, L, kd = cfg.n_backups, cm.L, key_dtype
    return KVStore(
        hash=tree.replicate(hix.create(capacity_per_group, cfg, device), L),
        plog=tree.replicate(lg.create(cfg.log_capacity, device, kd), L),
        bsorted=tree.replicate(tree.replicate(
            six.create(capacity_per_group, device, kd), L), R),
        blog=tree.replicate(tree.replicate(
            lg.create(cfg.log_capacity, device, kd), L), R),
        data=dp.create(G, capacity_per_group, cfg, device, L, kd),
        alive=torch.ones((G,), dtype=torch.bool, device=device),
        sever=torch.zeros((G,), dtype=torch.bool, device=device),
        hb=torch.zeros((L,), dtype=I32, device=device),
    )


def _map_groups(x, axis, fn):
    """``fn(leaf, axis)`` on every sharded leaf of a state (``axis`` its
    group axis, a tree of axes like GROUP_AXES); replicated leaves
    as they are."""
    if axis is None:
        return x
    if hasattr(x, "_fields"):
        axes = axis if isinstance(axis, tuple) else (axis,) * len(x)
        return type(x)(*[_map_groups(v, a, fn) for v, a in zip(x, axes)])
    return fn(x, axis)


def gathered(store: KVStore, comm) -> KVStore:
    """The whole store, every sharded leaf all-gathered: the one-process
    layout of the G groups, on every rank."""
    return _map_groups(store, GROUP_AXES, comm.all_gather)


def _first_alive_holder(g, alive):
    """Server to contact for group g (elementwise): the primary g, else
    the backup holders g + 1, g + 2, the first alive in that order."""
    G = alive.shape[0]
    cand = torch.stack([g % G, (g + 1) % G, (g + 2) % G], dim=-1).long()
    pick = torch.argmax(alive[cand].to(torch.uint8), dim=-1, keepdim=True)
    return cand.gather(-1, pick)[..., 0].to(I32)


def _first_alive_data_holder(s, dalive, Rv: int):
    """Data server to contact for shard s (elementwise): the shard
    itself, else the devices hosting its mirrors.  Returns (holder,
    any_alive)."""
    G = dalive.shape[0]
    cand = torch.stack([s % G] + [(s + r + 1) % G for r in range(Rv)],
                       dim=-1).long()
    ok = dalive[cand]
    pick = torch.argmax(ok.to(torch.uint8), dim=-1, keepdim=True)
    return cand.gather(-1, pick)[..., 0].to(I32), ok.any(dim=-1)


# ---------------------------------------------------------------------------
# op bodies: lanes are stacked [L, n], one row per server of the rank
# ---------------------------------------------------------------------------
def _me(cm, device):
    """Each stacked server's group, [L, 1] (JAX's ``axis_index``)."""
    return (cm.g0 + torch.arange(cm.L, device=device))[:, None]


def _route_to_owner(store, keys, valid, G, capacity, extra=None):
    """The routing prologue of the mutating ops: invalid (padding) lanes
    get an out-of-range destination, so they take no exchange capacity
    and arrive nowhere."""
    dest_g = owner_group(keys, G)
    dest = torch.where(valid, _first_alive_holder(dest_g, store.alive), G)
    payloads = {"k": (keys, 0), "g": (torch.where(valid, dest_g, -1), -1)}
    if extra:
        payloads.update(extra)
    return route_build(dest, payloads, G, capacity)


def _queue_remote_frees(freeq, rk, old_addr, mask):
    """Frees of slots on another device's shard ride each device's free
    queue (stacked [L]) until the gc op routes them home.  The op bodies
    gate on queue room first, so ``ok`` False lands in ``fq_spill``."""
    return lg.append_rows(freeq, torch.zeros_like(rk), old_addr,
                          torch.where(mask, 1, 0).to(torch.int8), mask)


def _fq_pregate(fq, may_queue):
    """Queue-full push-back of one device: lanes that may queue a remote
    free are admitted while its free queue has room (cumulative rank in
    the batch).  Returns the per-lane admit mask."""
    room = fq.keys.shape[0] - (fq.tail - fq.applied)
    qrank = torch.cumsum(may_queue.to(I32), 0, dtype=I32) - 1
    return ~may_queue | (qrank < room)


def _bump_hb(store, cm):
    """Every server advances its index and data heartbeat counters in
    each routed op, unless its heartbeats are severed."""
    d = store.data
    return store._replace(
        hb=store.hb + torch.where(cm.loc(store.sever), 0, 1).to(I32),
        data=d._replace(hb=d.hb + torch.where(cm.loc(d.sever), 0,
                                              1).to(I32)))


def _key_group_any(rk, valid, flag):
    """Per valid lane: does a valid lane with the same key have ``flag``?
    (JAX: ``(same & flag[None, :]).any(axis=1)`` over an [n, n] key
    equality mask; here a segment maximum over the lanes sorted by key,
    as ``spread_winner_addr`` takes it.)"""
    zero = torch.zeros_like(rk, dtype=I32)
    return dp.spread_winner_addr(rk, valid, flag, zero) >= 0


def _put_body(cfg, cm, capacity, store: KVStore, keys, vals, valid,
              degraded: bool):
    """Routed PUT.  ``degraded`` is the liveness hint the backend picks
    from its host-side view: the healthy variant assumes every index and
    data server is up, so it skips the replica probe (the old-slot
    lookup at a temporary primary) and the one-hop value displacement."""
    dev = keys.device
    G, L, g0 = cm.G, cm.L, cm.g0
    me = _me(cm, dev)
    bufs, slot, ok_route = _route_to_owner(
        store, keys, valid, G, capacity, {"v": (vals, 0)})
    recv = cm.exchange(bufs)
    rk, rv, rg = recv["k"], recv["v"], recv["g"]
    # a severed server answers nothing: its lanes are dropped un-acked
    valid = (rg >= 0) & ~cm.loc(store.sever)[:, None]
    am_primary = rg == me
    data = store.data
    dcap = data.vals.shape[1]
    dalive = data.alive & ~data.sever
    # pre-batch address of the overwritten key: the hash at the true
    # primary, the replica + pending log at a temporary primary (one
    # stacked group probe for the L servers)
    if degraded:
        a_p, f_p, _, a_b, f_b, _, _ = kops.group_probe_stacked(
            cfg, store.hash, store.bsorted, store.blog, rk, G, g0)
        probed = (torch.where(am_primary, a_p, a_b),
                  torch.where(am_primary, f_p, f_b))
    # --- owner side: place the value, group by group ----------------------
    cols = {k: [] for k in ("winner", "old_a", "old_f", "inplace", "slot_d",
                            "aok", "wslot", "wmask", "addr_lane", "allocw")}
    used, dvals, dkeys = [], [], []
    for i in range(L):
        g = g0 + i
        rk_g, ok_g = rk[i], valid[i]
        winner = dp.winner_mask(rk_g, ok_g)
        if degraded:
            old_a, old_f = probed[0][i], probed[1][i]
        else:
            old_a, old_f, _ = kops.probe(cfg, tree.at(store.hash, i), rk_g)
        # overwrite whose old slot is on my live shard: in place
        inplace = winner & old_f & (old_a // dcap == g) & dalive[g]
        allocw = winner & ~inplace
        # free-queue push-back before anything commits: a lane that may
        # queue a remote free (a moved overwrite; a displaced write whose
        # rollback would queue) is admitted while the queue has room
        may_queue = allocw & old_f & (old_a >= 0) & (old_a // dcap != g)
        if degraded:
            may_queue = may_queue | (allocw & ~dalive[g])
        allocw = allocw & _fq_pregate(tree.at(data.freeq, i), may_queue)
        u, slot_d, aok = dp.alloc(data.used[i], allocw & dalive[g])
        wslot = torch.where(inplace, old_a % dcap,
                            torch.where(aok, slot_d, dcap))
        wmask = inplace | aok
        wtgt = torch.where(wmask, wslot, dcap)
        used.append(u)
        dvals.append(drop_set_rows(data.vals[i], wtgt, rv[i]))
        dkeys.append(drop_set(data.keys[i], wtgt, rk_g))
        addr_lane = torch.where(
            inplace, old_a, torch.where(aok, g * dcap + slot_d, -1)).to(I32)
        for k, v in (("winner", winner), ("old_a", old_a), ("old_f", old_f),
                     ("inplace", inplace), ("slot_d", slot_d), ("aok", aok),
                     ("wslot", wslot), ("wmask", wmask),
                     ("addr_lane", addr_lane), ("allocw", allocw)):
            cols[k].append(v)
    c = {k: torch.stack(v) for k, v in cols.items()}
    writes = [(c["wslot"], rv, rk, c["wmask"])]
    disp = torch.zeros_like(valid)
    if degraded:
        # my own data shard is dead: displace the value one hop (the
        # neighbour's shard holds it until migrate_values brings it
        # home).  As on each JAX device, the neighbour allocates for the
        # forwarded lanes after its own allocation, on the same bitmap.
        need_fwd = c["allocw"] & ~cm.loc(dalive)[:, None]
        f = cm.shift({"v": rv, "k": rk, "need": need_fwd}, 1)
        fslot, faok = [], []
        for i in range(L):
            used[i], fs, fa = dp.alloc(used[i], f["need"][i] & dalive[g0 + i])
            ftgt = torch.where(fa, fs, dcap)
            dvals[i] = drop_set_rows(dvals[i], ftgt, f["v"][i])
            dkeys[i] = drop_set(dkeys[i], ftgt, f["k"][i])
            fslot.append(fs)
            faok.append(fa)
        fslot, faok = torch.stack(fslot), torch.stack(faok)
        back = cm.shift({"slot": fslot, "aok": faok}, G - 1)
        disp = need_fwd & back["aok"]
        c["addr_lane"] = torch.where(
            disp, ((me + 1) % G) * dcap + back["slot"],
            c["addr_lane"]).to(I32)
        writes.append((fslot, f["v"], f["k"], faok))
    # --- mirror the writes on the next Rv devices, in order ---------------
    mirror, kmirror = data.mirror, data.kmirror
    if mirror.shape[0]:
        mir, kmir = [], []
        for r in range(mirror.shape[0]):
            m_r, k_r = list(mirror[r]), list(kmirror[r])
            for ms, mv, mk, mm in writes:
                out = cm.shift({"s": ms, "v": mv, "k": mk, "m": mm}, r + 1)
                tgt = torch.where(out["m"] & cm.loc(dalive)[:, None],
                                  out["s"], dcap)
                for i in range(L):
                    m_r[i] = drop_set_rows(m_r[i], tgt[i], out["v"][i])
                    k_r[i] = drop_set(k_r[i], tgt[i], out["k"][i])
            mir.append(torch.stack(m_r))
            kmir.append(torch.stack(k_r))
            del m_r, k_r        # the per-group copies, before the next stack
        mirror, kmirror = torch.stack(mir), torch.stack(kmir)
    # superseded duplicate lanes share their winner's address; a failed
    # allocation (-1) un-acks the whole duplicate group for a retry
    addr = torch.stack([dp.spread_winner_addr(rk[i], valid[i],
                                              c["winner"][i],
                                              c["addr_lane"][i])
                        for i in range(L)])
    landed = valid & (addr >= 0)
    # --- primary log -> backup logs -> hash, commit-gated -----------------
    ops = torch.where(landed & am_primary, six.OP_PUT, 0).to(torch.int8)
    plog, ok_p = lg.append_rows(store.plog, rk, addr, ops,
                                landed & am_primary)
    # the hash update is synchronous: the primary log's entries are
    # applied the moment the batch commits
    plog = plog._replace(applied=plog.tail)
    blog, ok_rep, nrep, _ = _replicate_logs(
        store.blog, store.alive & ~store.sever, rk, addr, ops, landed, rg,
        cm, six.OP_PUT)
    ok_commit = landed & ok_rep & ((am_primary & ok_p) | ~am_primary)
    hashes, ok_h = [], []
    for i in range(L):
        h, ok = hix.insert(tree.at(store.hash, i), rk[i], addr[i], cfg,
                           ok_commit[i] & am_primary[i])
        hashes.append(h)
        ok_h.append(ok)
    ok_req = ok_commit & (torch.stack(ok_h) | ~am_primary)
    # --- data-server GC, commit-gated -------------------------------------
    # a committed move frees the old slot; an un-acked lane rolls its
    # fresh allocation back only when no log recorded its entry
    old_a = c["old_a"]
    moved = (c["winner"] & c["old_f"] & ~c["inplace"] & ok_req
             & (old_a >= 0))
    free_local = moved & (old_a // dcap == me) & cm.loc(dalive)[:, None]
    undo = ~ok_req & (nrep == 0)
    used = torch.stack([
        dp.free_slots(dp.free_slots(used[i], old_a[i] % dcap,
                                    free_local[i]),
                      c["slot_d"][i], c["aok"][i] & undo[i])
        for i in range(L)])
    # a displaced slot lives on the neighbour: its rollback is queued
    undo_remote = disp & undo
    qmask = (moved & ~free_local) | undo_remote
    qaddr = torch.where(undo_remote, addr, old_a)
    freeq, fq_acc = _queue_remote_frees(data.freeq, rk, qaddr, qmask)
    fq_spill = data.fq_spill + (qmask & ~fq_acc).sum(1, dtype=I32)
    ret = route_return({"ok": ok_req.to(I32), "addr": addr, "rep": nrep},
                       slot, cm)
    new_data = data._replace(
        vals=torch.stack(dvals), used=used, keys=torch.stack(dkeys),
        mirror=mirror, kmirror=kmirror, freeq=freeq, fq_spill=fq_spill)
    new_store = _bump_hb(store._replace(
        hash=tree.stack(hashes), plog=plog, blog=blog, data=new_data), cm)
    return (new_store, ret["ok"].bool() & ok_route, ret["addr"],
            ret["rep"])


def _replicate_logs(blog, alive, rk, addr, ops, valid, rg, cm, opcode):
    """Push the owners' batches of log entries to the backup logs
    (``alive`` the replicated [G] liveness).  Returns (blog, ok, nrep,
    ok_local), each lane array [L, n]:

      ok[i]       False when a live backup rejected owner-lane i's append
                  (ring full), shifted back to the owner for its ack;
      nrep[i]     how many replica logs recorded the entry (dead backups
                  are skipped: the honest report of reduced replication);
      ok_local[i] False when MY OWN backup-log append for a
                  temporary-primary lane was rejected.

    Healthy path: the primary's entries (``ops``) go to the r+1-hop
    backup holders.  Degraded path: a request routed to me as a backup
    holder (its primary dead) is appended to my backup log for that
    group, and replica-0 entries travel one hop on to the replica-1
    holder.  Without such a lane (one host read, agreed over the ranks,
    decides) those appends would change nothing and are skipped."""
    R = blog.tail.shape[0]
    G = cm.G
    dev = rk.device
    me = _me(cm, dev)
    ok = torch.ones(rk.shape, dtype=torch.bool, device=dev)
    ok_local = torch.ones(rk.shape, dtype=torch.bool, device=dev)
    nrep = torch.zeros(rk.shape, dtype=I32, device=dev)
    alive_me = cm.loc(alive)[:, None]
    logs = [tree.at(blog, r) for r in range(R)]
    for r in range(R):
        back = (G - (r + 1)) % G
        pk, pa, po = (cm.shift(x, r + 1) for x in (rk, addr, ops))
        should = (po > 0) & alive_me       # dead holders skip the append
        logs[r], okr = lg.append_rows(logs[r], pk, pa, po, should)
        ok = ok & cm.shift(okr, back)
        nrep = nrep + cm.shift((should & okr).to(I32), back)
    temp = valid & (rg != me)
    if bool(cm.agree(temp.any())):
        for r in range(R):
            mine_as_backup = temp & (rg == (me - r - 1) % G)
            opsb = torch.where(mine_as_backup, opcode, 0).to(torch.int8)
            logs[r], okb = lg.append_rows(logs[r], rk, addr, opsb,
                                          mine_as_backup)
            ok = ok & okb
            ok_local = ok_local & okb
            nrep = nrep + (mine_as_backup & okb).to(I32)
        if R >= 2:
            ops0 = torch.where(temp & (rg == (me - 1) % G), opcode,
                               0).to(torch.int8)
            fk, fa, fo = (cm.shift(x, 1) for x in (rk, addr, ops0))
            fshould = (fo > 0) & alive_me
            logs[1], okf = lg.append_rows(logs[1], fk, fa, fo, fshould)
            ok = ok & cm.shift(okf, (G - 1) % G)
            nrep = nrep + cm.shift((fshould & okf).to(I32), (G - 1) % G)
    return tree.stack(logs), ok, nrep, ok_local


def _delete_body(cfg, cm, capacity, store: KVStore, keys, valid,
                 degraded: bool):
    """Routed DELETE: a tombstone through the primary log -> backup logs
    -> hash delete; the value slot is freed at once (queued for the gc
    op when it lives on another shard).  The tombstones compact out of
    the sorted replicas at apply time.  ``degraded`` as in _put_body:
    with every server alive all requests land on true primaries, so the
    healthy variant skips the replica probe."""
    dev = keys.device
    G, L, g0 = cm.G, cm.L, cm.g0
    me = _me(cm, dev)
    bufs, slot, ok_route = _route_to_owner(store, keys, valid, G, capacity)
    recv = cm.exchange(bufs)
    rk, rg = recv["k"], recv["g"]
    valid = (rg >= 0) & ~cm.loc(store.sever)[:, None]
    addr = torch.full(rk.shape, -1, dtype=I32, device=dev)
    am_primary = rg == me
    data = store.data
    dcap = data.vals.shape[1]
    deff = data.alive & ~data.sever
    if degraded:
        # existence check before this batch's tombstones land: a
        # temporary primary consults its replica + pending log, so
        # DELETE reports found honestly while the true primary is down
        a_p, f_p, _, a_b, found_b, _, _ = kops.group_probe_stacked(
            cfg, store.hash, store.bsorted, store.blog, rk, G, g0)
        old_a = torch.where(am_primary, a_p, a_b)
        old_f = torch.where(am_primary, f_p, found_b)
    else:
        probed = [kops.probe(cfg, tree.at(store.hash, i), rk[i])
                  for i in range(L)]
        old_a = torch.stack([p[0] for p in probed])
        old_f = torch.stack([p[1] for p in probed])
        found_b = torch.zeros_like(valid)       # no degraded lanes exist
    valids = []
    for i in range(L):
        g = g0 + i
        # free-queue push-back before the tombstone lands; a nacked
        # winner takes its whole duplicate-key group with it
        winner0 = dp.winner_mask(rk[i], valid[i])
        may_queue = (winner0 & old_f[i] & (old_a[i] >= 0)
                     & ~((old_a[i] // dcap == g) & deff[g]))
        bad = may_queue & ~_fq_pregate(tree.at(data.freeq, i), may_queue)
        valids.append(valid[i] & ~_key_group_any(rk[i], valid[i], bad))
    valid = torch.stack(valids)
    ops = torch.where(valid & am_primary, six.OP_DEL, 0).to(torch.int8)
    plog, ok_p = lg.append_rows(store.plog, rk, addr, ops,
                                valid & am_primary)
    plog = plog._replace(applied=plog.tail)
    hashes, found = [], []
    for i in range(L):
        h, f = hix.delete(tree.at(store.hash, i), rk[i], cfg,
                          valid[i] & am_primary[i])
        hashes.append(h)
        found.append(f)
    found = torch.stack(found)
    blog, ok_rep, nrep, ok_loc = _replicate_logs(
        store.blog, store.alive & ~store.sever, rk, addr, ops, valid, rg,
        cm, six.OP_DEL)
    # data-server GC, commit-gated and winner-deduped: a primary lane
    # frees once the hash tombstoned the entry; a temporary-primary lane
    # once my pending log recorded the tombstone
    gate = torch.where(am_primary, found, ok_loc & old_f)
    winner = torch.stack([dp.winner_mask(rk[i], valid[i])
                          for i in range(L)])
    freed = winner & gate & (old_a >= 0)
    free_local = freed & (old_a // dcap == me) & cm.loc(deff)[:, None]
    used = torch.stack([dp.free_slots(data.used[i], old_a[i] % dcap,
                                      free_local[i]) for i in range(L)])
    qmask = freed & ~free_local
    freeq, fq_acc = _queue_remote_frees(data.freeq, rk, old_a, qmask)
    fq_spill = data.fq_spill + (qmask & ~fq_acc).sum(1, dtype=I32)
    ok_req = valid & ok_rep & ((am_primary & ok_p) | ~am_primary)
    found_req = torch.where(am_primary, found, found_b & valid)
    ret = route_return({"ok": ok_req.to(I32), "found": found_req.to(I32),
                        "rep": nrep}, slot, cm)
    new_store = _bump_hb(store._replace(
        hash=tree.stack(hashes), plog=plog, blog=blog,
        data=data._replace(used=used, freeq=freeq, fq_spill=fq_spill)), cm)
    return (new_store, ret["ok"].bool() & ok_route, ret["found"].bool(),
            ret["rep"])


def _gather_rows(shards, slot, ok):
    """``shards[g, slot[g]]`` where ``ok``, zero rows elsewhere, for the L
    stacked shards [L, n, W] and slot [L, Q]: JAX's gather from each
    device's shard with one zero row appended (a masked lane reads that
    row), without copying the shards."""
    idx = torch.where(ok, slot, 0).long()
    rows = shards[torch.arange(shards.shape[0],
                               device=shards.device)[:, None], idx]
    return torch.where(ok[..., None], rows, 0)


def get_exchange(store: KVStore, keys, valid, G, capacity, comm=None):
    """A GET's route to the first live holder of each key's owner group:
    the keys each server receives, rk [L, G * capacity] (key_inf in
    unused slots), with each lane's slot and routed flag."""
    cm = comm if comm is not None else Comm.single(G)
    dest_g = owner_group(keys, G)
    dest = torch.where(valid, _first_alive_holder(dest_g, store.alive), G)
    bufs, slot, ok_route = route_build(
        dest, {"k": (keys, key_inf(keys.dtype))}, G, capacity)
    return cm.exchange(bufs)["k"], slot, ok_route


def _get_body(cfg, cm, capacity, store: KVStore, keys, valid):
    """One-sided GET: route to the first live holder of the owner group,
    the fused probe there (hash for the primary's lanes, pending log +
    sorted replica for a backup's; one stacked call for the L servers),
    the value gather from the local data shard, and the reverse route.  A
    value on another shard, or on a dead data server, is flagged for the
    second-hop fetch."""
    rk, slot, ok_route = get_exchange(store, keys, valid, cm.G, capacity, cm)
    data = store.data
    dcap = data.vals.shape[1]
    me = _me(cm, rk.device)
    a_p, f_p, c_p, a_b, f_b, c_b, og = kops.group_probe_stacked(
        cfg, store.hash, store.bsorted, store.blog, rk, cm.G, cm.g0)
    am_primary = og == me
    addr = torch.where(am_primary, a_p, a_b)
    found = torch.where(am_primary, f_p, f_b)
    acc = torch.where(am_primary, c_p, c_b)
    val_ok = (found & (addr // dcap == me)
              & cm.loc(data.alive & ~data.sever)[:, None])
    vals = _gather_rows(data.vals, addr % dcap, val_ok)
    srv = torch.where(cm.loc(store.sever), 0,
                      1).to(I32)[:, None].expand(rk.shape)
    back = route_return({"addr": addr, "found": found.to(I32), "acc": acc,
                         "val": vals, "vok": val_ok.to(I32), "srv": srv},
                        slot, cm)
    # an unrouted lane (queue full) is a push-back the client retries
    routed = ok_route & back["srv"].bool()
    return (back["addr"], back["found"].bool() & routed, back["acc"],
            back["val"], routed, back["vok"].bool())


def _fetch_body(cm, capacity, store: KVStore, addrs, valid):
    """Second-hop value read: route each address to the first live data
    holder of its shard (the shard, else a mirror) and gather the value.
    Returns (store with the answering round's heartbeats, vals,
    routed)."""
    G = cm.G
    data = store.data
    dcap = data.vals.shape[1]
    Rv = data.mirror.shape[0]
    deff = data.alive & ~data.sever
    shard = torch.where(addrs >= 0, addrs // dcap, 0)
    dest, servable = _first_alive_data_holder(shard, deff, Rv)
    dest = torch.where(valid & (addrs >= 0) & servable, dest, G)
    bufs, slot, ok_route = route_build(dest, {"a": (addrs, -1)}, G,
                                       capacity)
    ra = cm.exchange(bufs)["a"]
    rs = torch.where(ra >= 0, ra // dcap, G)
    lslot, has = ra % dcap, ra >= 0
    me = _me(cm, ra.device)
    vals = _gather_rows(data.vals, lslot, has)
    taken = rs == me
    for r in range(Rv):
        sel = (rs == (me - r - 1) % G) & ~taken
        mv = _gather_rows(data.mirror[r], lslot, has)
        vals = torch.where(sel[..., None], mv, vals)
        taken = taken | sel
    back = route_return({"val": vals}, slot, cm)
    return (_bump_hb(store, cm), back["val"],
            ok_route & (servable | ~valid | (addrs < 0)))


def _gc_body(cm, capacity, store: KVStore):
    """One flush round of the free queues: each queued address travels
    to the data shard that owns it, which clears the allocator bit.
    Frees for a dead shard, or that overflow the exchange, are
    re-queued."""
    G, L = cm.G, cm.L
    data = store.data
    dcap = data.vals.shape[1]
    B = min(data.freeq.keys.shape[1], G * capacity)
    taken = [lg.take_pending(tree.at(data.freeq, i), B) for i in range(L)]
    k = torch.stack([t[0] for t in taken])
    a = torch.stack([t[1] for t in taken])
    o = torch.stack([t[2] for t in taken])
    freeq = tree.stack([t[3] for t in taken])
    pend = o > 0
    dest_s = torch.where(pend & (a >= 0), a // dcap, G)
    deff = data.alive & ~data.sever    # a severed shard's bitmap is gone
    deliver = pend & (dest_s < G) & deff[torch.clamp(dest_s, 0, G - 1)
                                         .long()]
    dest = torch.where(deliver, dest_s, G)
    bufs, _, okq = route_build(dest, {"a": (a, -1)}, G, capacity)
    ra = cm.exchange(bufs)["a"]
    used = torch.stack([
        dp.free_slots(data.used[i], torch.where(ra[i] >= 0, ra[i] % dcap,
                                                dcap), ra[i] >= 0)
        for i in range(L)])
    requeue = pend & ~(deliver & okq)
    freeq, okr = lg.append_rows(freeq, k, a,
                                torch.where(requeue, 1, 0).to(torch.int8),
                                requeue)
    fq_spill = data.fq_spill + (requeue & ~okr).sum(1, dtype=I32)
    return _bump_hb(store._replace(data=data._replace(
        used=used, freeq=freeq, fq_spill=fq_spill)), cm)


def _apply_body(cfg, batch, store: KVStore, cm, servers=None):
    """One log->sorted merge round of every backup replica on the stack's
    ``servers`` (all by default); only those servers' heartbeats
    advance.  No collective: each rank merges its own replicas."""
    R, L = store.blog.tail.shape
    servers = range(L) if servers is None else servers
    srt = [[tree.at(store.bsorted, r, i) for i in range(L)]
           for r in range(R)]
    logs = [[tree.at(store.blog, r, i) for i in range(L)] for r in range(R)]
    for i in servers:
        for r in range(R):
            keys, addrs, ops, logs[r][i] = lg.take_pending(logs[r][i], batch)
            srt[r][i] = kops.merge(cfg, srt[r][i], keys, addrs, ops)
    bumped = _bump_hb(store, cm)
    on = torch.zeros((L,), dtype=torch.bool, device=store.hb.device)
    on[list(servers)] = True
    return store._replace(
        bsorted=tree.stack(srt), blog=tree.stack(logs),
        hb=torch.where(on, bumped.hb, store.hb),
        data=store.data._replace(hb=torch.where(on, bumped.data.hb,
                                                store.data.hb)))


def _tick_body(store: KVStore, cm):
    """Heartbeat-only round."""
    return _bump_hb(store, cm)


@functools.lru_cache(maxsize=None)
def _scan_ladder(G: int, R: int, device):
    """The index tensors of the SCAN's duty rule: prev [G, R, R], the
    server (g - r + rp) mod G that holds replica rp of the group whose
    replica r server g holds (group (g - r - 1) mod G), masked to rp < r
    by below [R, R]; holders [G, R], the server (g + r + 1) mod G that
    holds replica r of group g."""
    g = torch.arange(G, device=device)[:, None, None]
    r = torch.arange(R, device=device)[None, :, None]
    rp = torch.arange(R, device=device)[None, None, :]
    return ((g - r + rp) % G, (rp < r)[0],
            (g[:, :, 0] + r[0, :, 0][None] + 1) % G)


def _scan_duty(eff, G: int, R: int):
    """(serve [G, R], holders [G, R]): server g serves replica r of its
    group iff it is live and every lower-replica holder of that group is
    dead, so exactly one live holder serves."""
    prev, below, holders = _scan_ladder(G, R, eff.device)
    return eff[:, None] & ~(eff[prev] & below).any(-1), holders


def _scan_body(cfg, cm, limit, store: KVStore, lo, hi):
    """Backup-side SCAN: every server drains its replicas (each one its
    own number of merge rounds, as JAX's per-device ``while_loop`` runs
    them: here a host loop over the rank's servers, no collective),
    range-queries the replicas it holds (lo, hi [L]), and the
    all-gathered [G, R, limit] results, masked to the replicas each
    server should serve, are merged.  Returns (keys [limit], addrs
    [limit], covered [G], store)."""
    R = store.blog.tail.shape[0]
    G, L = cm.G, cm.L
    rounds = max(1, -(-cfg.log_capacity // cfg.async_apply_batch))
    st = store
    for _ in range(rounds):
        pending = (st.blog.tail - st.blog.applied).amax(0).cpu()
        servers = [i for i in range(L) if int(pending[i]) > 0]
        if not servers:
            break
        st = _apply_body(cfg, cfg.async_apply_batch, st, cm, servers)
    # effective liveness: a severed holder cannot serve, and duty falls
    # through to the next replica
    eff = store.alive & ~store.sever
    INF = key_inf(st.bsorted.keys.dtype)
    # every server's range query of every replica it holds: one call,
    # then the all_gather of the [L, R, limit] results in group order
    k, a, _ = kops.range_query_stacked(cfg, st.bsorted, lo, hi, limit)
    k, a = cm.all_gather(k), cm.all_gather(a)
    serve, holders = _scan_duty(eff, G, R)
    allk = torch.where(serve[..., None], k, INF).reshape(-1)  # all_gather
    alla = torch.where(serve[..., None], a, -1).reshape(-1)
    order = torch.argsort(allk, stable=True)
    # group g is covered iff at least one of its R holders is live
    covered = eff[holders].any(1)
    return (allk[order][:limit], alla[order][:limit], covered,
            _bump_hb(st, cm))


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------
def make_ops(cfg, G: int, capacity_q: int = 64, scan_limit: int = 128,
             comm=None):
    """The distributed ops over G groups (the port's counterpart of the
    JAX package's jitted shard_map ops; same names and signatures,
    global [B] lane arrays, B a multiple of G).  Over the W ranks of
    ``comm`` (SPMD: every rank makes the same call with the same global
    inputs) each rank takes its groups' lanes and every output lane
    array is all-gathered, so each rank gets the whole answer; stores
    are each rank's own part:

    put(st, keys, vals, valid)  -> (st, ok, addrs, nrep)
    put_degraded(...)           -> as put, plus the old-slot replica probe
                                   at temporary primaries and the one-hop
                                   value displacement off dead data shards
                                   (use while any server is masked dead)
    get(st, keys, valid)        -> (addrs, found, accesses, vals, routed,
                                    val_ok)
    fetch(st, addrs, valid)     -> (st, vals, routed)  second-hop read
    delete(st, keys, valid)     -> (st, ok, found, nrep)
    delete_degraded(...)        -> as delete, plus the replica probe that
                                   answers found at a temporary primary
    apply(st)                   -> st
    gc(st)                      -> st   one free-queue flush round
    scan(st, lo, hi)            -> (keys, addrs, covered, st); lo, hi [B]
                                   (group d reads lo[d B / G], as JAX's
                                   devices read their shard's first)
    tick(st)                    -> st   heartbeat-only round"""
    cm = comm if comm is not None else Comm.single(G)
    if cm.G != G:
        raise ValueError(f"ops over {G} groups with a comm of {cm.G}")
    rows, lanes = cm.rows, cm.lanes

    def put(degraded):
        def op(st, keys, vals, valid):
            st, ok, addrs, nrep = _put_body(
                cfg, cm, capacity_q, st, rows(keys), rows(vals), rows(valid),
                degraded)
            return st, lanes(ok), lanes(addrs), lanes(nrep)
        return op

    def get(st, keys, valid):
        return tuple(lanes(x) for x in _get_body(
            cfg, cm, capacity_q, st, rows(keys), rows(valid)))

    def fetch(st, addrs, valid):
        st, vals, routed = _fetch_body(cm, capacity_q, st, rows(addrs),
                                       rows(valid))
        return st, lanes(vals), lanes(routed)

    def delete(degraded):
        def op(st, keys, valid):
            st, ok, found, nrep = _delete_body(
                cfg, cm, capacity_q, st, rows(keys), rows(valid), degraded)
            return st, lanes(ok), lanes(found), lanes(nrep)
        return op

    return {"put": put(False), "put_degraded": put(True), "get": get,
            "fetch": fetch, "delete": delete(False),
            "delete_degraded": delete(True),
            "apply": lambda st: _apply_body(cfg, cfg.async_apply_batch, st,
                                            cm),
            "gc": lambda st: _gc_body(cm, capacity_q, st),
            "scan": lambda st, lo, hi: _scan_body(
                cfg, cm, scan_limit, st, rows(lo)[:, 0], rows(hi)[:, 0]),
            "tick": lambda st: _tick_body(st, cm)}


def device_counters(store: KVStore, comm=None) -> dict:
    """The store's device counters as host ints (snapshot time only):
    live servers per plane, heartbeat totals, the worst backup log's
    pending depth, and the value plane's counters (summed or maxed over
    the ranks)."""
    cm = store_comm(store, comm)
    pend = (store.blog.tail - store.blog.applied).max()
    out = {
        "live_index_servers": int(store.alive.sum()),
        "index_heartbeats": int(cm.agree(store.hb.sum(), "sum")),
        "pending_log_ops": int(cm.agree(pend, "max")),
    }
    out.update(dp.device_counters(store.data, cm))
    return out


def parity_report(store: KVStore, cfg, apply_fn=None, comm=None) -> list:
    """Hash/sorted parity + value-slot audit (eager).  For every group g
    and replica r: drain a COPY of the replica, then check its live item
    count equals the hash table's, every replica key is found in the
    hash, and the addresses agree.  A final ``value_slots`` entry audits
    the data plane's slot accounting.  Entries carry true liveness
    (``primary_alive`` / ``holder_alive``).  Over ranks every rank reads
    each group from its owner and returns the same report."""
    cm = store_comm(store, comm)
    R, G = store.blog.tail.shape[0], cm.G
    alive = store.alive.cpu().numpy() & ~store.sever.cpu().numpy()
    out = []
    for g in range(G):
        hs = cm.group_leaves(store.hash, g)
        n_hash = int(hix.n_items(hs))
        for r in range(R):
            h = (g + r + 1) % G
            srt, _ = dp.drain_pair(
                cm.group_leaves(tree.at(store.bsorted, r), h),
                cm.group_leaves(tree.at(store.blog, r), h), cfg)
            keys, addrs, valid = six.items(srt)
            a_h, f_h, _ = kops.probe(cfg, hs, keys)
            out.append({"group": g, "replica": r, "holder": h,
                        "primary_alive": bool(alive[g]),
                        "holder_alive": bool(alive[h]),
                        "n_hash": n_hash, "n_sorted": int(valid.sum()),
                        "agree": (n_hash == int(valid.sum()))
                        and bool((f_h | ~valid).all())
                        and bool(((a_h == addrs) | ~valid).all())})
    out.append(dp.value_slot_audit(store, cfg, apply_fn, cm))
    return out


# ---------------------------------------------------------------------------
# Failure & recovery protocol (paper §4.3, host-side control plane)
# ---------------------------------------------------------------------------
def _wipe_index_state(store: KVStore, dev: int, cm) -> KVStore:
    """Destroy the index state device ``dev`` held: the hash table and
    primary log of group ``dev`` and every sorted replica + backup log
    hosted on ``dev`` (the crash's data loss; the data shard survives:
    data servers are a separate failure domain, paper §2).  A new store:
    the old one is unchanged.  Only ``dev``'s owner rank holds it."""
    if not cm.owns(dev):
        return store
    every = slice(None)
    h, s = store.hash, store.bsorted
    INF = key_inf(s.keys.dtype)
    return store._replace(
        hash=tree.put(h, hix.HashIndex(0, 0, -1, 0), dev, comm=cm),
        plog=tree.put(store.plog, lg.clear(tree.at(store.plog, dev,
                                                   comm=cm)), dev, comm=cm),
        bsorted=tree.put(s, six.SortedIndex(INF, -1, 0), every, dev,
                         comm=cm),
        blog=tree.put(store.blog, lg.clear(tree.at(store.blog, every, dev,
                                                   comm=cm)),
                      every, dev, comm=cm))


def fail_server(store: KVStore, dev: int, wipe: bool = True,
                comm=None) -> KVStore:
    """Oracle kill switch: mask device ``dev``'s INDEX server dead with
    the client told at once.  ``wipe`` (default) also destroys the index
    state it held, so recovery must rebuild from surviving copies.  For
    failures the client must discover through its leases, use
    ``sever_server``."""
    store = store._replace(alive=tree.put_leaf(store.alive, False, dev))
    return (_wipe_index_state(store, dev, store_comm(store, comm)) if wipe
            else store)


def sever_server(store: KVStore, dev: int, wipe: bool = True,
                 comm=None) -> KVStore:
    """Crash device ``dev``'s index server without telling the client:
    its index state is destroyed (``wipe``) and its heartbeats stop, but
    ``alive``, the client's routing view, still says up.  Requests
    delivered there are dropped un-acked until the lease detector
    notices the stalled heartbeat counter and demotes the device."""
    store = store._replace(sever=tree.put_leaf(store.sever, True, dev))
    return (_wipe_index_state(store, dev, store_comm(store, comm)) if wipe
            else store)


def fail_data_server(store: KVStore, dev: int, wipe: bool = True,
                     comm=None) -> KVStore:
    """Mask device ``dev``'s DATA server dead (see data_plane.py)."""
    return dp.fail_data_server(store, dev, wipe, comm)


def sever_data_server(store: KVStore, dev: int, wipe: bool = True,
                      comm=None) -> KVStore:
    """Crash device ``dev``'s DATA server without telling the client, the
    value plane's lease-detection kill switch (see data_plane.py)."""
    return dp.sever_data_server(store, dev, wipe, comm)


def recover_data_server(store: KVStore, dev: int, cfg,
                        apply_fn=None, comm=None) -> KVStore:
    """Rebuild device ``dev``'s data shard from its mirrors and mark-sweep
    the allocator (see data_plane.py); ``apply_fn`` runs the sweep's log
    barrier as incremental apply rounds."""
    return dp.recover_data_server(store, dev, cfg, apply_fn, comm)


def migrate_values(store: KVStore, cfg, apply_fn=None, comm=None):
    """Background value migration: move degraded-write strays back to
    their owner group's shard and patch the index addresses, restoring
    one-RTT GETs (see data_plane.py; over ranks each group's owner homes
    its strays).  Returns (store, n_moved)."""
    return dp.migrate_values(store, cfg, owner_group, apply_fn,
                             store_comm(store, comm))


def _fresh_hash_like(hs) -> hix.HashIndex:
    return hix.HashIndex(sig=torch.zeros_like(hs.sig),
                         fp=torch.zeros_like(hs.fp),
                         addr=torch.full_like(hs.addr, -1),
                         fill=torch.zeros_like(hs.fill))


def _hash_from_items(hs_like, keys, addrs, cfg):
    """Fresh hash table holding exactly the given (distinct) items, in
    the slots JAX's one padded batch gives them (``hix.rebuild``)."""
    dev = hs_like.sig.device
    k = torch.as_tensor(np.asarray(keys), device=dev)
    a = torch.as_tensor(np.asarray(addrs, np.int32), device=dev)
    return hix.rebuild(_fresh_hash_like(hs_like), k, a, cfg,
                       torch.ones(k.shape, dtype=torch.bool, device=dev))


def _sorted_from_items(srt_like, keys, addrs):
    """Fresh sorted replica holding exactly the given items (a stable
    sort on the key, as JAX's numpy argsort)."""
    dev = srt_like.keys.device
    cap = srt_like.keys.shape[0]
    kd = srt_like.keys.dtype
    k = torch.as_tensor(np.asarray(keys), device=dev).to(kd)
    a = torch.as_tensor(np.asarray(addrs, np.int32), device=dev)
    n = k.shape[0]
    ks, order = torch.sort(k, stable=True)
    out_k = torch.full((cap,), key_inf(kd), dtype=kd, device=dev)
    out_a = torch.full((cap,), -1, dtype=I32, device=dev)
    out_k[:n] = ks
    out_a[:n] = a[order]
    return six.SortedIndex(keys=out_k, addrs=out_a,
                           size=torch.tensor(n, dtype=I32, device=dev))


def _live_items(srt):
    """(keys, addrs) of a sorted replica's live entries, as numpy."""
    keys, addrs, valid = six.items(srt)
    return keys[valid].cpu().numpy(), addrs[valid].cpu().numpy()


def _replica_pair(store: KVStore, cm, r: int, h: int):
    """(sorted, log) of replica slot r on server h, on every rank."""
    return (cm.group_leaves(tree.at(store.bsorted, r), h),
            cm.group_leaves(tree.at(store.blog, r), h))


def _group_authority_items(store: KVStore, cfg, g: int, eff, cm):
    """Host-side (keys, addrs) of group ``g`` from its best surviving
    authority: the primary's hash (keys fetched from the data items, the
    paper's rebuild from the data), else a live drained sorted replica,
    else the data-plane slot scan.  Raises RecoveryError when none of
    the three can answer."""
    R, G = store.blog.tail.shape[0], cm.G
    if eff[g]:
        hs = cm.group_leaves(store.hash, g)
        addrs = hs.addr[hix.valid_mask(hs)].cpu().numpy()
        try:
            keys = dp.keys_for_addrs(store, addrs, cm)
        except dp.RecoveryError as e:
            raise dp.RecoveryError(
                g, ["hash + data-plane keys"] + e.searched, e.blockers)
        return keys, addrs.astype(np.int32)
    for r in range(R):
        h = (g + r + 1) % G
        if not eff[h]:
            continue
        srt, _ = dp.drain_pair(*_replica_pair(store, cm, r, h), cfg)
        return _live_items(srt)
    return dp.group_items_from_data(store, cfg, g, owner_group, cm)


def recover_server(store: KVStore, dev: int, cfg,
                   online: bool = True, comm=None) -> KVStore:
    """Recover device ``dev``'s index server from surviving copies
    (host-side control plane, eager):

      1. rebuild group ``dev``'s hash table from the first live sorted
         replica of that group, the paper's hash-from-skiplist rebuild;
      2. re-clone every sorted replica + backup log ``dev`` hosts from a
         surviving copy of the same group;
      3. clear a severed heartbeat and mark ``dev`` alive again.

    ``online`` (default) clones snapshots: the source replica is not
    drained first; its pending log is cloned alongside and streams into
    the rebuilt replicas through the ordinary ``apply`` op while
    foreground traffic continues, and the hash is the snapshot plus a
    replay of the cloned pending window.  ``online=False`` drains, then
    clones (stop the world).

    Multi-failure fallback: a group with no live sorted replica rebuilds
    from its primary's hash + the keys stored with the data items, else
    from a full data-plane slot scan; RecoveryError (with the searched
    sources and the blockers) is raised only when truly no copy
    exists.  Over ranks every rank reads the survivors (from their
    owners) and only ``dev``'s owner builds and writes."""
    cm = store_comm(store, comm)
    R, G = store.blog.tail.shape[0], cm.G
    alive = store.alive.cpu().numpy()
    sever = store.sever.cpu().numpy()
    if bool(alive[dev]) and not bool(sever[dev]):
        return store
    # the recovered server heartbeats again; it stays routed-dead until
    # the rebuild below completes
    store = store._replace(sever=tree.put_leaf(store.sever, False, dev),
                           alive=tree.put_leaf(store.alive, False, dev))
    if G == 1:
        # single-server store: nothing was wiped (no surviving copy could
        # exist), recovery is just the liveness flip
        return store._replace(alive=tree.put_leaf(store.alive, True, dev))
    eff = alive & ~sever
    eff[dev] = False
    mine = cm.owns(dev)

    def first_live_holder(group, exclude):
        for r in range(R):
            h = (group + r + 1) % G
            if h != exclude and eff[h]:
                return r, h
        return None

    def drained(r, h):
        """The (sorted, log) pair at (r, h), drained in the store when
        recovering offline."""
        nonlocal store
        srt, blog = _replica_pair(store, cm, r, h)
        if not online:
            srt, blog = dp.drain_pair(srt, blog, cfg)
            if cm.owns(h):
                store = store._replace(
                    bsorted=tree.put(store.bsorted, srt, r, h, comm=cm),
                    blog=tree.put(store.blog, blog, r, h, comm=cm))
        return srt, blog

    # -- 1. hash rebuild for group ``dev`` --------------------------------
    src = first_live_holder(dev, dev)
    if src is not None:
        srt, blog = drained(*src)
        if mine:
            keys, addrs, valid = six.items(srt)
            # the valid mask keeps empty sorted-array slots out of the table
            new_hash = hix.rebuild(
                _fresh_hash_like(tree.at(store.hash, dev, comm=cm)), keys,
                addrs, cfg, valid)
            if online:
                new_hash = hix.replay_pending(new_hash, blog, cfg)
    else:
        # every replica holder dead: the keys stored with the values
        # reconstruct (key, addr) for any group (RecoveryError with the
        # blockers when they can't)
        items = dp.group_items_from_data(store, cfg, dev, owner_group, cm)
        if mine:
            new_hash = _hash_from_items(tree.at(store.hash, dev, comm=cm),
                                        *items, cfg)
    lcap = store.plog.keys.shape[1]
    kd = store.plog.keys.dtype
    empty_log = lg.create(lcap, store.plog.keys.device, kd)
    if mine:
        store = store._replace(
            hash=tree.put(store.hash, new_hash, dev, comm=cm),
            plog=tree.put(store.plog, empty_log, dev, comm=cm))
    # -- 2. sorted-replica rebuild for each group hosted on ``dev`` -------
    for r2 in range(R):
        g = (dev - r2 - 1) % G
        src2 = first_live_holder(g, dev)
        if src2 is not None:
            # online: the clone carries the source's pending window; the
            # ordinary apply op streams it into both copies identically
            s_srt, s_blog = drained(*src2)
        else:
            # no live replica of group g anywhere else: rebuild this copy
            # from the group's surviving authority
            k_np, a_np = _group_authority_items(store, cfg, g, eff, cm)
            if mine:
                s_srt = _sorted_from_items(
                    tree.at(store.bsorted, r2, dev, comm=cm), k_np, a_np)
                s_blog = empty_log
        if mine:
            store = store._replace(
                bsorted=tree.put(store.bsorted, s_srt, r2, dev, comm=cm),
                blog=tree.put(store.blog, s_blog, r2, dev, comm=cm))
    return store._replace(alive=tree.put_leaf(store.alive, True, dev))


def re_replicate(store: KVStore, cfg, comm=None) -> tuple:
    """Post-recovery re-replication pass (closes the multi-failure
    window): for every group, verify each live holder's sorted replica
    against the group's authority (the primary's hash when alive, else
    the first live replica) and rebuild any copy that diverged, so R
    valid copies exist again before the next failure.  Verification
    drains copies (like parity_report), so replicas with pending
    catch-up debt compare clean and the online catch-up goes on.  Over
    ranks every rank verifies (reading from the owners) and the holder's
    owner rebuilds.  Returns (store, n_rebuilt)."""
    cm = store_comm(store, comm)
    R, G = store.blog.tail.shape[0], cm.G
    eff = store.alive.cpu().numpy() & ~store.sever.cpu().numpy()
    lcap = store.plog.keys.shape[1]
    empty_log = lg.create(lcap, store.plog.keys.device,
                          store.plog.keys.dtype)
    rebuilt = 0
    for g in range(G):
        auth = None      # (keys, addrs) fetched lazily on first mismatch
        src = None
        if eff[g]:
            hs = cm.group_leaves(store.hash, g)
            n_auth = int(hix.n_items(hs))
        else:
            for r in range(R):
                h = (g + r + 1) % G
                if eff[h]:
                    src = (r, h)
                    break
            if src is None:
                continue       # nothing to verify against (recover first)
            srt, _ = dp.drain_pair(*_replica_pair(store, cm, *src), cfg)
            auth = _live_items(srt)
            n_auth = len(auth[0])
        for r in range(R):
            h = (g + r + 1) % G
            if not eff[h] or (not eff[g] and src == (r, h)):
                continue
            srt, blog = _replica_pair(store, cm, r, h)
            dsrt, _ = dp.drain_pair(srt, blog, cfg)
            keys, addrs, valid = six.items(dsrt)
            n_rep = int(valid.sum())
            if eff[g]:
                a_h, f_h, _ = kops.probe(cfg, hs, keys)
                okk = (n_rep == n_auth and bool((f_h | ~valid).all())
                       and bool(((a_h == addrs) | ~valid).all()))
            else:
                rk, ra = keys[valid].cpu().numpy(), addrs[valid].cpu().numpy()
                okk = (n_rep == n_auth
                       and bool(np.array_equal(rk, auth[0]))
                       and bool(np.array_equal(ra, auth[1])))
            if okk:
                continue
            if auth is None:
                try:
                    auth = _group_authority_items(store, cfg, g, eff, cm)
                except dp.RecoveryError:
                    break      # unverifiable right now (data shard dead)
            if cm.owns(h):
                store = store._replace(
                    bsorted=tree.put(store.bsorted,
                                     _sorted_from_items(srt, *auth), r, h,
                                     comm=cm),
                    blog=tree.put(store.blog, empty_log, r, h, comm=cm))
            rebuilt += 1
    return store, rebuilt
