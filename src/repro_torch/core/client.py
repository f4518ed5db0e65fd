"""HiStoreClient: one typed front door over the hybrid index (port of
``repro/core/client.py``).

    client = HiStoreClient(LocalBackend(4096, cfg))        # on cuda
    client = HiStoreClient(LocalBackend(4096, cfg, device="cpu"))
    client = HiStoreClient(DistributedBackend(8, cfg, 4096))  # 8 groups

    res = client.put(keys, values)       # PutResult(ok, addrs, retries)
    res = client.get(keys)               # GetResult(addrs, found, acc, vals)
    res = client.delete(keys)            # DeleteResult(ok, found, retries)
    res = client.scan(lo, hi, limit)     # ScanResult(keys, addrs, count)

    client.fail_server(0)                # primary down: degraded reads
    client.recover_server(0)             # hash rebuilt, online

The client pads requests to power-of-two batch sizes and splits oversize
ones into ``max_batch`` chunks, turns capacity push-back into a bounded
retry loop with async-apply drains in between, runs the backups'
log->sorted merges every ``apply_every_n_ops`` mutating ops, and runs
the value migration after every recovery (``migrate_on_recover``).  The
port runs eagerly: ``jax.jit`` has no counterpart here.

``DistributedBackend`` runs the healthy distributed store: G index
groups stacked on one device (``kvstore.py``).  Left for slice 2b: its
lease detector and ticker, server failures and recovery, heartbeat
severing, data-server failures and value migration; those calls raise
NotImplementedError naming the slice.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import data_plane as dpl
from repro_torch.core import index_group as ig
from repro_torch.core import kvstore as kv
from repro_torch.core import log as lg
from repro_torch.core import telemetry as tm
from repro_torch.core.backend import Backend  # noqa: F401  (re-export)
from repro_torch.core.hashing import I32, key_dtype, key_inf, next_pow2
from repro_torch.core.results import (DeleteResult, GetResult, PutResult,
                                      ScanResult)
from repro_torch.core.scatter import drop_set_rows

SLICE_2 = "the distributed store (slice 2)"
SLICE_2B = "the distributed store's failure handling (slice 2b)"


def _resolve_device(device, who: str = "LocalBackend") -> torch.device:
    """The card unless the caller names another device; no silent CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who} runs on the card by default and CUDA is not "
            "available; pass device='cpu' for the plain PyTorch path")
    return dev


# ---------------------------------------------------------------------------
# Local backend: one index group + the node's data shard
# ---------------------------------------------------------------------------
def _local_put(cfg, g, vals, used, keys, vs, valid, backups_alive,
               primary_alive):
    dcap = vals.shape[0]
    # one slot per key per batch (last writer wins, like the hash insert);
    # overwrites update their old slot in place (the data-server GC)
    winner = dpl.winner_mask(keys, valid)
    old_a, old_f = ig.owner_addr_probe(g, keys, cfg, primary_alive)
    inplace = winner & old_f & (old_a >= 0) & (old_a < dcap)
    used, slot, aok = dpl.alloc(used, winner & ~inplace)
    wslot = torch.where(inplace, old_a, torch.where(aok, slot, dcap))
    wmask = inplace | aok
    vals = drop_set_rows(vals, torch.where(wmask, wslot, dcap), vs)
    addr_lane = torch.where(wmask, wslot, -1).to(I32)
    addrs = dpl.spread_winner_addr(keys, valid, winner, addr_lane)
    landed = valid & (addrs >= 0)   # shard full -> un-acked, client retries
    g, ok, nrep = ig.put(g, keys, addrs, cfg, landed,
                         backups_alive=backups_alive, with_nrep=True)
    # un-acked fresh allocations roll back only when no backup log
    # recorded the entry
    used = dpl.free_slots(used, slot, aok & ~ok & (nrep == 0))
    return g, vals, used, ok & landed, addrs, nrep


def _local_get(cfg, g, dvals, keys, valid, primary_alive):
    addr, found, acc = ig.get(g, keys, cfg, primary_alive=primary_alive)
    found = found & valid
    dcap = dvals.shape[0]
    slot = torch.where(found & (addr >= 0) & (addr < dcap), addr, dcap)
    padded = torch.cat([dvals, dvals.new_zeros((1,) + dvals.shape[1:])])
    vals = padded[torch.clamp(slot, 0, dcap).long()]
    return (torch.where(found, addr, -1).to(I32), found,
            torch.where(valid, acc, 0), vals, valid,
            valid.to(I32))      # single shard: every read is one hop


def _local_delete(cfg, g, used, keys, valid, backups_alive, primary_alive):
    # data-server GC: a committed DELETE frees its value slot (winner-
    # deduped so a double-delete within one batch frees exactly once)
    winner = dpl.winner_mask(keys, valid)
    old_a, old_f = ig.owner_addr_probe(g, keys, cfg, primary_alive)
    dcap = used.shape[0]
    g, found = ig.delete(g, keys, cfg, valid, backups_alive=backups_alive,
                         primary_alive=primary_alive)
    freed = winner & found & old_f & (old_a >= 0) & (old_a < dcap)
    used = dpl.free_slots(used, old_a, freed)
    return g, used, found & valid


class LocalBackend:
    """One index group (1 hash + n_backups sorted replicas + logs) plus
    the value shard a single-node deployment owns, slot-allocated and
    GC'd by the data plane's bitmap.  All state lives on ``device``: the
    card unless the caller passes another (``device="cpu"`` takes the
    plain PyTorch path, as the tests do).  Server liveness is tracked on
    the host (the paper's client knows which servers are up): a healthy
    primary's GETs run the hash probe alone, a dead one's also the
    replica probe."""

    def __init__(self, capacity: int, cfg, value_words: Optional[int] = None,
                 *, device=None):
        self.device = _resolve_device(device)
        self.cfg = cfg
        self.telemetry = tm.Telemetry(getattr(cfg, "telemetry",
                                              "counters"))
        self.capacity = capacity
        self.group = ig.create(capacity, cfg, self.device)
        self.value_words = value_words or cfg.value_words
        self.vals = torch.zeros((capacity, self.value_words), dtype=I32,
                                device=self.device)
        self.used = torch.zeros((capacity,), dtype=torch.bool,
                                device=self.device)
        self.batch_multiple = 1
        self.max_mutation_batch = cfg.log_capacity
        self._primary_alive = True
        self._backups_alive = [True] * cfg.n_backups
        self._pending_bound = 0   # host-side upper bound on log pending

    def _ensure_log_room(self, n: int):
        """Drain up front when the batch might not fit the backup logs
        (the host-side bound only over-estimates, so at worst we drain
        early; it avoids a device sync per mutation)."""
        if self._pending_bound + n > self.cfg.log_capacity:
            self.drain()

    def _hint(self):
        """The primary_alive routing hint: True while the primary lives,
        None (run both probes, select by ``alive[0]``) otherwise."""
        return True if self._primary_alive else None

    def put(self, keys, vals, valid):
        n = int(valid.sum())
        self._ensure_log_room(n)
        self._pending_bound += n
        self.group, self.vals, self.used, ok, addrs, nrep = _local_put(
            self.cfg, self.group, self.vals, self.used, keys, vals, valid,
            tuple(self._backups_alive), self._hint())
        return ok, addrs, nrep

    def get(self, keys, valid):
        return _local_get(self.cfg, self.group, self.vals, keys, valid,
                          self._hint())

    def delete(self, keys, valid):
        n = int(valid.sum())
        self._ensure_log_room(n)
        self._pending_bound += n
        ba = tuple(self._backups_alive)
        self.group, self.used, found = _local_delete(
            self.cfg, self.group, self.used, keys, valid, ba, self._hint())
        # room is guaranteed above, so every valid lane is acked
        return valid, found, valid.to(I32) * sum(ba)

    def scan(self, lo, hi, limit: int):
        (k, a, n), self.group = ig.scan(self.group, lo, hi, limit, self.cfg)
        self._pending_bound = 0          # scan drained the logs
        return k, a, n, torch.ones((1,), dtype=torch.bool)

    def apply_async(self):
        self.group = ig.apply_async(self.group, self.cfg)
        self._pending_bound = max(
            0, self._pending_bound - self.cfg.async_apply_batch)

    def drain(self):
        self.group = ig.drain(self.group, self.cfg)
        self._pending_bound = 0

    def pending_ops(self) -> int:
        return ig.pending_max(self.group)

    def telemetry_gauges(self) -> dict:
        return {
            "live_index_servers": (int(self._primary_alive)
                                   + sum(map(int, self._backups_alive))),
            "live_data_servers": 1,
            "pending_log_ops": self.pending_ops(),
            "freeq_pending": 0,
            "fq_spill": 0,
        }

    def lease_stalled(self) -> bool:
        return False   # liveness is host-side: no leases to stall

    def migrate_values(self) -> int:
        return 0   # one shard: every value is already home

    def fail_server(self, server: int = 0):
        """Index server ``server`` dies (0 the primary, 1 + r backup r)
        and its index state is wiped."""
        self.group = ig.fail(self.group, server)
        if server == 0:
            self._primary_alive = False
        else:
            self._backups_alive[server - 1] = False
        self.telemetry.count("index_demotions")
        self.telemetry.span({"event": "demote", "plane": "index",
                             "server": server, "detected": False})

    def recover_server(self, server: int = 0, online: bool = True):
        """Rebuild index server ``server`` from the survivors and re-admit
        it (``online=False`` drains the logs first)."""
        if server == 0:
            self.group = ig.recover_primary(self.group, self.cfg,
                                            online=online)
            self._primary_alive = True
        else:
            self.group = ig.recover_backup(self.group, server - 1,
                                           self.cfg, online=online)
            self._backups_alive[server - 1] = True
        self.telemetry.count("index_recoveries")
        self.telemetry.span({"event": "recover", "plane": "index",
                             "server": server, "online": online})

    def sever_server(self, server: int = 0):
        raise NotImplementedError(
            f"heartbeat severing needs the lease detector of {SLICE_2}")

    def sever_data_server(self, server: int = 0):
        raise NotImplementedError(
            f"data-server heartbeat severing needs the lease detector of "
            f"{SLICE_2}")

    def fail_data_server(self, server: int = 0):
        raise NotImplementedError(
            f"LocalBackend owns a single unreplicated value shard; "
            f"data-server failures are modelled by {SLICE_2}")

    recover_data_server = fail_data_server


# ---------------------------------------------------------------------------
# Distributed backend: G index groups on one device
# ---------------------------------------------------------------------------
class DistributedBackend:
    """The kvstore ops over ``groups`` index groups stacked on one device
    (the JAX package's takes a mesh of G devices; one card has none):
    routed two-sided PUT/DELETE with log replication, one-sided GET with
    the second-hop fetch, the all-gathered SCAN, and the value plane's
    GC flush.  All state lives on ``device``: the card unless the caller
    passes another.  Healthy path only: lease detection must be off
    (``cfg.lease_misses = 0``); failures, recovery, severing, migration
    and the ticker raise NotImplementedError naming slice 2b."""

    def __init__(self, groups: int, cfg, capacity_per_group: int = 4096, *,
                 capacity_q: int = 64, scan_limit: int = 128, device=None):
        if int(getattr(cfg, "lease_misses", 0) or 0) > 0:
            raise NotImplementedError(
                f"lease-based failure detection (cfg.lease_misses > 0) is "
                f"{SLICE_2B}; pass lease_misses=0")
        self.device = _resolve_device(device, "DistributedBackend")
        self.cfg = cfg
        self.telemetry = tm.Telemetry(getattr(cfg, "telemetry",
                                              "counters"))
        self.G = groups
        self.store = kv.create(groups, capacity_per_group, cfg, self.device)
        self.capacity_q = capacity_q
        self.scan_limit = scan_limit
        self.ops = kv.make_ops(cfg, groups, capacity_q, scan_limit)
        self.batch_multiple = groups
        self.value_words = cfg.value_words
        self.max_mutation_batch = cfg.log_capacity
        self._pending_bound = 0        # host-side upper bound, no dev sync

    def _ensure_log_room(self, n: int):
        # drain up front when a batch might not fit the worst backup log
        if self._pending_bound + n > self.cfg.log_capacity:
            self.drain()

    def put(self, keys, vals, valid):
        n = int(valid.sum())
        self._ensure_log_room(n)
        self._pending_bound += n
        self.store, ok, addrs, nrep = self.ops["put"](self.store, keys,
                                                      vals, valid)
        return ok, addrs, nrep

    def get(self, keys, valid):
        addrs, found, acc, vals, routed, val_ok = self.ops["get"](
            self.store, keys, valid)
        found = found & valid
        hops = valid.to(I32)
        # second hop: a value homed on another shard (or a dead data
        # server) is fetched by address
        need = found & ~val_ok
        if bool(need.any()):
            self.store, fvals, fok = self.ops["fetch"](self.store, addrs,
                                                       need)
            vals = torch.where(need[:, None], fvals, vals)
            routed = routed & (~need | fok)
            hops = hops + need.to(I32)
        return addrs, found, acc, vals, routed & valid, hops

    def delete(self, keys, valid):
        n = int(valid.sum())
        self._ensure_log_room(n)
        self._pending_bound += n
        self.store, ok, found, nrep = self.ops["delete"](self.store, keys,
                                                         valid)
        return ok, found & valid, nrep

    def scan(self, lo, hi, limit: int):
        loa = lo.reshape(1).expand(self.G)
        hia = hi.reshape(1).expand(self.G)
        # the result width is static: one scan op per distinct limit
        scan_op = (self.ops if limit == self.scan_limit else kv.make_ops(
            self.cfg, self.G, self.capacity_q, limit))["scan"]
        k, a, covered, self.store = scan_op(self.store, loa, hia)
        n = (k != key_inf(k.dtype)).sum(dtype=I32)
        self._pending_bound = 0          # scan drained the logs
        return k, a, n, covered

    def apply_async(self):
        self.store = self.ops["apply"](self.store)
        self._pending_bound = max(
            0, self._pending_bound - self.cfg.async_apply_batch)

    def gc_round(self):
        """One routed flush of the pending free queues."""
        self.store = self.ops["gc"](self.store)

    def pending_frees(self) -> int:
        return int(lg.pending_count(self.store.data.freeq).sum())

    def drain(self):
        while self.pending_ops() > 0:
            self.apply_async()
        self._pending_bound = 0
        # flush the free queues until empty or stuck
        prev = -1
        while True:
            cur = self.pending_frees()
            if cur == 0 or cur == prev:
                break
            prev = cur
            self.gc_round()

    def pending_ops(self) -> int:
        return int((self.store.blog.tail - self.store.blog.applied).max())

    def telemetry_gauges(self) -> dict:
        return kv.device_counters(self.store)

    def lease_stalled(self) -> bool:
        return False    # detection is off (lease_misses == 0)

    def migrate_values(self) -> int:
        raise NotImplementedError(f"value migration: {SLICE_2B}")

    def fail_server(self, server: int):
        raise NotImplementedError(f"index-server failure: {SLICE_2B}")

    def sever_server(self, server: int):
        raise NotImplementedError(f"heartbeat severing: {SLICE_2B}")

    def recover_server(self, server: int, **kw):
        raise NotImplementedError(f"index-server recovery: {SLICE_2B}")

    def fail_data_server(self, server: int):
        raise NotImplementedError(f"data-server failure: {SLICE_2B}")

    def sever_data_server(self, server: int):
        raise NotImplementedError(f"data-server severing: {SLICE_2B}")

    def recover_data_server(self, server: int):
        raise NotImplementedError(f"data-server recovery: {SLICE_2B}")

    def start_ticker(self) -> bool:
        return False    # no lease to tick (lease_misses == 0), as in JAX

    def stop_ticker(self) -> None:
        return None     # no ticker was started


# ---------------------------------------------------------------------------
# The client
# ---------------------------------------------------------------------------
class HiStoreClient:
    """Typed GET/PUT/DELETE/SCAN over a pluggable backend (see module
    docstring).  All state lives in the backend; the client only holds
    policy."""

    def __init__(self, backend: Backend, *, batch_quantum: int = 64,
                 max_batch: int = 16384, max_retries: int = 8,
                 apply_every_n_ops: Optional[int] = None,
                 migrate_on_recover: bool = True):
        self.backend = backend
        self.device = getattr(backend, "device", torch.device("cpu"))
        m = max(getattr(backend, "batch_multiple", 1), 1)
        self._multiple = m
        # padded sizes: power-of-two, rounded up to a multiple of the
        # backend's batch multiple
        q0 = next_pow2(max(batch_quantum, 1))
        self.batch_quantum = -(-q0 // m) * m
        self.max_batch = (-(-max(max_batch, self.batch_quantum)
                            // self.batch_quantum) * self.batch_quantum)
        # mutation chunks must fit the backup-log ring after a drain
        cap = getattr(backend, "max_mutation_batch", None)
        if cap:
            cap = max(self.batch_quantum,
                      cap // self.batch_quantum * self.batch_quantum)
            self.max_batch = min(self.max_batch, cap)
        self.max_retries = max_retries
        self.apply_every_n_ops = apply_every_n_ops
        self.migrate_on_recover = migrate_on_recover
        self._mutations_since_apply = 0
        self.stats = {"puts": 0, "gets": 0, "deletes": 0, "scans": 0,
                      "retries": 0, "applies": 0, "migrated": 0}
        self.telemetry = (getattr(backend, "telemetry", None)
                          or tm.Telemetry("off"))

    # -- public ops --------------------------------------------------------
    def put(self, keys, values=None) -> PutResult:
        keys = self._as_keys(keys)
        q = keys.shape[0]
        if q == 0:
            return PutResult(self._empty(torch.bool), self._empty(I32), 0,
                             self._empty(I32))
        vals = self._as_values(values, q)
        t0 = time.perf_counter()
        oks, addrs, reps, retries = [], [], [], 0
        for s in range(0, q, self.max_batch):
            o, a, rep, r = self._put_chunk(keys[s:s + self.max_batch],
                                           vals[s:s + self.max_batch])
            oks.append(o)
            addrs.append(a)
            reps.append(rep)
            retries = max(retries, r)
        self.stats["puts"] += q
        tel = self.telemetry
        if tel.enabled:
            tel.count("put_ops", q)
            tel.observe("put", time.perf_counter() - t0)
        self._note_mutations(q)
        return PutResult(torch.cat(oks), torch.cat(addrs), retries,
                         torch.cat(reps))

    def get(self, keys) -> GetResult:
        keys = self._as_keys(keys)
        q = keys.shape[0]
        if q == 0:
            W = getattr(self.backend, "value_words", 1)
            return GetResult(self._empty(I32), self._empty(torch.bool),
                             self._empty(I32),
                             torch.zeros((0, W), dtype=I32,
                                         device=self.device),
                             self._empty(torch.bool), self._empty(I32))
        t0 = time.perf_counter()
        outs = [self._get_chunk(keys[s:s + self.max_batch])
                for s in range(0, q, self.max_batch)]
        self.stats["gets"] += q
        res = GetResult(*[torch.cat(p) for p in zip(*outs)])
        tel = self.telemetry
        if tel.enabled:
            tel.count("get_ops", q)
            tel.observe("get", time.perf_counter() - t0)
            # hops == 2: reads served by a second-hop value fetch
            tel.count("hops2_gets", int((res.hops == 2).sum()))
        return res

    def delete(self, keys) -> DeleteResult:
        keys = self._as_keys(keys)
        q = keys.shape[0]
        if q == 0:
            return DeleteResult(self._empty(torch.bool),
                                self._empty(torch.bool), 0,
                                self._empty(I32))
        t0 = time.perf_counter()
        oks, founds, reps, retries = [], [], [], 0
        for s in range(0, q, self.max_batch):
            o, f, rep, r = self._delete_chunk(keys[s:s + self.max_batch])
            oks.append(o)
            founds.append(f)
            reps.append(rep)
            retries = max(retries, r)
        self.stats["deletes"] += q
        tel = self.telemetry
        if tel.enabled:
            tel.count("delete_ops", q)
            tel.observe("delete", time.perf_counter() - t0)
        self._note_mutations(q)
        return DeleteResult(torch.cat(oks), torch.cat(founds), retries,
                            torch.cat(reps))

    def scan(self, lo, hi, limit: Optional[int] = None) -> ScanResult:
        kd = key_dtype()
        if limit is None:
            limit = getattr(self.backend, "scan_limit", 128)
        if limit <= 0:
            return ScanResult(self._empty(kd), self._empty(I32),
                              torch.zeros((), dtype=I32, device=self.device),
                              True, ())
        t0 = time.perf_counter()
        k, a, n, covered = self.backend.scan(
            torch.as_tensor(lo, dtype=kd, device=self.device),
            torch.as_tensor(hi, dtype=kd, device=self.device), limit)
        self.stats["scans"] += 1
        cov = np.asarray(covered.cpu())
        missing = tuple(int(g) for g in np.nonzero(~cov)[0].tolist())
        tel = self.telemetry
        if tel.enabled:
            tel.count("scan_ops")
            tel.observe("scan", time.perf_counter() - t0)
            if missing:
                tel.count("incomplete_scans")
            tel.span({"op": "scan", "limit": limit, "retries": 0,
                      "seconds": time.perf_counter() - t0,
                      "missing_groups": list(missing)})
        lim = min(limit, k.shape[0])
        return ScanResult(k[:lim], a[:lim],
                          torch.clamp(n, max=lim).to(I32),
                          not missing, missing)

    def apply(self) -> None:
        """One asynchronous log->sorted merge round on every backup."""
        self.stats["applies"] += 1
        self.backend.apply_async()

    def drain(self) -> None:
        """Apply ALL pending log entries (SCAN serializability barrier)."""
        self.backend.drain()

    # -- failures, recovery and migration ------------------------------------
    def migrate(self) -> int:
        """Run the value migration now.  Returns the values moved (0 on
        LocalBackend: its one shard is every value's home)."""
        moved = self.backend.migrate_values()
        self.stats["migrated"] += moved
        return moved

    def fail_server(self, server: int):
        return self.backend.fail_server(server)

    def sever_server(self, server: int):
        return self.backend.sever_server(server)

    def recover_server(self, server: int, **kw):
        """Rebuild and re-admit a server; keyword knobs (``online``) go to
        the backend.  Migrates afterwards when ``migrate_on_recover``."""
        r = self.backend.recover_server(server, **kw)
        if self.migrate_on_recover:
            self.migrate()
        return r

    def fail_data_server(self, server: int):
        return self.backend.fail_data_server(server)

    def sever_data_server(self, server: int):
        return self.backend.sever_data_server(server)

    def recover_data_server(self, server: int):
        self.backend.recover_data_server(server)
        if self.migrate_on_recover:
            self.migrate()

    def start_ticker(self) -> bool:
        """Start the backend's background lease ticker.  True when one is
        running; False for backends without leases (LocalBackend tracks
        liveness on the host, the port's DistributedBackend runs with
        lease_misses=0)."""
        fn = getattr(self.backend, "start_ticker", None)
        return bool(fn()) if fn else False

    def stop_ticker(self) -> None:
        fn = getattr(self.backend, "stop_ticker", None)
        if fn:
            fn()

    # -- telemetry ---------------------------------------------------------
    def metrics(self) -> tm.MetricsSnapshot:
        """Typed point-in-time snapshot of the telemetry plane: op
        counters, per-op latency percentiles and the backend's gauges
        (the only device read telemetry makes)."""
        gauges = {}
        fn = getattr(self.backend, "telemetry_gauges", None)
        if fn is not None and self.telemetry.enabled:
            gauges = fn()
        return self.telemetry.snapshot(gauges=gauges)

    def metrics_text(self) -> str:
        """The snapshot in Prometheus text exposition format."""
        return tm.render_text(self.metrics())

    def dump_trace(self, path) -> None:
        """Write the op-trace ring (``cfg.telemetry="trace"``) as JSON."""
        self.telemetry.dump_trace(path)

    # -- batching / retry internals ---------------------------------------
    def _empty(self, dtype):
        return torch.zeros((0,), dtype=dtype, device=self.device)

    def _as_keys(self, keys):
        k = torch.as_tensor(np.asarray(keys) if not torch.is_tensor(keys)
                            else keys, device=self.device).to(key_dtype())
        return k[None] if k.dim() == 0 else k

    def _as_values(self, values, q):
        W = getattr(self.backend, "value_words", 1)
        if values is None:
            return torch.zeros((q, W), dtype=I32, device=self.device)
        v = torch.as_tensor(np.asarray(values) if not torch.is_tensor(values)
                            else values, device=self.device).to(I32)
        if v.dim() == 0:
            v = v[None]
        if v.dim() == 1:
            v = v[:, None].expand(-1, W)
        return v.contiguous()

    def _padded_len(self, q: int) -> int:
        p = max(self.batch_quantum, next_pow2(q))
        p = -(-p // self._multiple) * self._multiple
        return min(self.max_batch, p)

    def _pad(self, keys):
        q = keys.shape[0]
        p = self._padded_len(q)
        kp = torch.zeros((p,), dtype=keys.dtype, device=keys.device)
        kp[:q] = keys
        valid = torch.zeros((p,), dtype=torch.bool, device=keys.device)
        valid[:q] = True
        return kp, valid

    def _make_room(self):
        """Push-back response between retry rounds: one log->sorted merge
        (frees backup-log ring room) and, where the backend has free
        queues, one GC flush (frees value slots queued on a remote
        shard)."""
        self.backend.apply_async()
        gc = getattr(self.backend, "gc_round", None)
        if gc:
            gc()

    def _put_chunk(self, keys, vals):
        tel = self.telemetry
        tr = tel.tracing
        t0 = time.perf_counter()
        q = keys.shape[0]
        kp, pending = self._pad(keys)
        vp = torch.zeros((kp.shape[0], vals.shape[1]), dtype=vals.dtype,
                         device=vals.device)
        vp[:q] = vals
        ev = ([{"phase": "route", "seconds": time.perf_counter() - t0}]
              if tr else None)
        ok_all = torch.zeros_like(pending)
        addr_all = torch.full(kp.shape, -1, dtype=I32, device=kp.device)
        rep_all = torch.zeros(kp.shape, dtype=I32, device=kp.device)
        retries = 0
        while True:
            td = time.perf_counter()
            ok, addrs, nrep = self.backend.put(kp, vp, pending)
            newly = pending & ok
            ok_all = ok_all | newly
            addr_all = torch.where(newly, addrs, addr_all)
            rep_all = torch.where(newly, nrep, rep_all)
            pending = pending & ~ok
            if tr:
                ev.append({"phase": "dispatch", "try": retries,
                           "seconds": time.perf_counter() - td})
            if not bool(pending.any()) or retries >= self.max_retries:
                break
            retries += 1
            self.stats["retries"] += 1
            tel.count("retries")
            tel.count("pushbacks")   # capacity push-back on a mutation
            self._make_room()
        if tr:
            tel.span({"op": "put", "n": q, "retries": retries,
                      "seconds": time.perf_counter() - t0, "events": ev})
        return ok_all[:q], addr_all[:q], rep_all[:q], retries

    def _delete_chunk(self, keys):
        tel = self.telemetry
        tr = tel.tracing
        t0 = time.perf_counter()
        q = keys.shape[0]
        kp, pending = self._pad(keys)
        ev = ([{"phase": "route", "seconds": time.perf_counter() - t0}]
              if tr else None)
        acked = torch.zeros_like(pending)
        found_all = torch.zeros_like(pending)
        rep_all = torch.zeros(kp.shape, dtype=I32, device=kp.device)
        retries = 0
        while True:
            td = time.perf_counter()
            ack, found, nrep = self.backend.delete(kp, pending)
            newly = pending & ack
            acked = acked | newly
            found_all = found_all | (newly & found)
            rep_all = torch.where(newly, nrep, rep_all)
            pending = pending & ~ack
            if tr:
                ev.append({"phase": "dispatch", "try": retries,
                           "seconds": time.perf_counter() - td})
            if not bool(pending.any()) or retries >= self.max_retries:
                break
            retries += 1
            self.stats["retries"] += 1
            tel.count("retries")
            tel.count("pushbacks")
            self._make_room()
        if tr:
            tel.span({"op": "delete", "n": q, "retries": retries,
                      "seconds": time.perf_counter() - t0, "events": ev})
        return acked[:q], found_all[:q], rep_all[:q], retries

    def _get_chunk(self, keys):
        tel = self.telemetry
        tr = tel.tracing
        t0 = time.perf_counter()
        q = keys.shape[0]
        kp, pending = self._pad(keys)
        ev = ([{"phase": "route", "seconds": time.perf_counter() - t0}]
              if tr else None)
        addr_all = torch.full(kp.shape, -1, dtype=I32, device=kp.device)
        found_all = torch.zeros_like(pending)
        acc_all = torch.zeros(kp.shape, dtype=I32, device=kp.device)
        hops_all = torch.zeros(kp.shape, dtype=I32, device=kp.device)
        vals_all = None
        retries = 0
        while True:
            td = time.perf_counter()
            addrs, found, acc, vals, routed, hops = self.backend.get(
                kp, pending)
            if vals_all is None:
                vals_all = torch.zeros_like(vals)
            newly = pending & routed
            addr_all = torch.where(newly, addrs, addr_all)
            found_all = found_all | (newly & found)
            acc_all = torch.where(newly, acc, acc_all)
            hops_all = torch.where(newly, hops, hops_all)
            vals_all = torch.where(newly[:, None], vals, vals_all)
            pending = pending & ~routed
            if tr:
                ev.append({"phase": "dispatch", "try": retries,
                           "seconds": time.perf_counter() - td})
            if not bool(pending.any()) or retries >= self.max_retries:
                break
            retries += 1
            self.stats["retries"] += 1
            tel.count("retries")
        if tr:
            tel.span({"op": "get", "n": q, "retries": retries,
                      "seconds": time.perf_counter() - t0, "events": ev})
        # lanes still pending exhausted the retry budget: reported as
        # un-routed so push-back is distinguishable from a genuine miss
        return (addr_all[:q], found_all[:q], acc_all[:q], vals_all[:q],
                (~pending)[:q], hops_all[:q])

    def _note_mutations(self, n: int):
        if not self.apply_every_n_ops:
            return
        self._mutations_since_apply += n
        if self._mutations_since_apply >= self.apply_every_n_ops:
            self._mutations_since_apply = 0
            self.apply()
