"""HiStoreClient: one typed front door over the hybrid index (port of
``repro/core/client.py``).

    client = HiStoreClient(LocalBackend(4096, cfg))        # on cuda
    client = HiStoreClient(LocalBackend(4096, cfg, device="cpu"))
    client = HiStoreClient(DistributedBackend(8, cfg, 4096))  # 8 groups
    client = HiStoreClient(DistributedBackend(8, cfg, 4096, comm=comm))

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

``DistributedBackend`` runs the distributed store: G index groups
stacked on one device (``kvstore.py``), or over the W ranks of a
``Comm`` (``comm.py``; one process a card, each holding G / W groups),
with index- and data-server failures (oracle ``fail_*`` and
heartbeat-severing ``sever_*``), online recovery with re-replication,
value migration, and the lease detector with its background ticker
(wall-clock or rounds leases).  Over ranks the client is SPMD: every
rank makes the same calls with the same global inputs and gets the
whole answer, and the host-side liveness and lease tracking is the
same on every rank after every call.

The ticker over ranks.  A tick reads every rank's heartbeats and agrees
the expiries, so its collectives must take the same place in every
rank's stream of ops; a thread ticking at its own time would pair them
with another rank's foreground collectives.  Each rank's ticker thread
therefore runs rounds in lock step with the others', on a gloo group of
their own (``Comm.host``), never on the store's group.  A round opens
only where its rank is idle (no foreground op inside, none for a lease
interval), and while it is open a new foreground op waits.  The ranks
first all_gather (stop, the count of foreground ops so far or -1 where
not idle): only where every rank is idle after the same count (the
client is SPMD, so the count names the place in the op stream) does the
round tick, bumping each rank's heartbeats, all_gathering the counters and
agreeing the expiries over the host group, so each demotion lands
between the same two foreground ops on every rank.  Otherwise the round
does nothing and the foreground ops age the leases themselves.  A stop
on any rank ends every rank's ticker at the same round.
Under wall-clock leases the client paces its retries
(``_retry_pause``) so a retry loop spans a lease timeout, and a SCAN
that missed a group retries while a stalled heartbeat is being watched,
then reports the missing groups.
"""
from __future__ import annotations

import threading
import time
import warnings
import weakref
from typing import Optional

import numpy as np
import torch

from repro_torch.core import data_plane as dpl
from repro_torch.core import index_group as ig
from repro_torch.core import kvstore as kv
from repro_torch.core import log as lg
from repro_torch.core import telemetry as tm
from repro_torch.core import tree
from repro_torch.core.backend import Backend  # noqa: F401  (re-export)
from repro_torch.core.comm import Comm
from repro_torch.core.hashing import I32, key_dtype, key_inf, next_pow2
from repro_torch.core.results import (DeleteResult, FailResult, GetResult,
                                      PutResult, RecoverResult, ScanResult)
from repro_torch.core.scatter import drop_set_rows

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


def _check_key_dtype(key_dtype, backend: str):
    if key_dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{backend}: keys are torch.int32 or torch.int64, "
                         f"got {key_dtype}")


class LocalBackend:
    """One index group (1 hash + n_backups sorted replicas + logs) plus
    the value shard a single-node deployment owns, slot-allocated and
    GC'd by the data plane's bitmap.  All state lives on ``device``: the
    card unless the caller passes another (``device="cpu"`` takes the
    plain PyTorch path, as the tests do).  Server liveness is tracked on
    the host (the paper's client knows which servers are up): a healthy
    primary's GETs run the hash probe alone, a dead one's also the
    replica probe.  ``key_dtype`` is the width of the store's keys:
    int32 (the default, the JAX package's x32 mode) or int64 (its x64
    mode, ``jax_enable_x64``); the client casts keys to it."""

    def __init__(self, capacity: int, cfg, value_words: Optional[int] = None,
                 *, device=None, key_dtype=torch.int32):
        _check_key_dtype(key_dtype, "LocalBackend")
        self.device = _resolve_device(device)
        self.cfg = cfg
        self.telemetry = tm.Telemetry(getattr(cfg, "telemetry",
                                              "counters"))
        self.capacity = capacity
        self.key_dtype = key_dtype
        self.group = ig.create(capacity, cfg, self.device, key_dtype)
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
            "heartbeat severing needs the distributed backend's "
            "lease detector; LocalBackend liveness is host-side")

    def sever_data_server(self, server: int = 0):
        raise NotImplementedError(
            "data-server heartbeat severing needs the distributed "
            "backend's lease detector; LocalBackend owns a single "
            "unreplicated shard")

    def fail_data_server(self, server: int = 0):
        raise NotImplementedError(
            "LocalBackend owns a single unreplicated value shard — no "
            "surviving copy could exist; data-server failures are "
            "modelled by DistributedBackend (cfg.n_value_replicas)")

    recover_data_server = fail_data_server


# ---------------------------------------------------------------------------
# Distributed backend: G index groups on one device
# ---------------------------------------------------------------------------
class _OpLock:
    """The distributed backend's lock: reentrant, it serializes the
    foreground ops, counts them (``seq``, outermost entries only) and
    holds a new one back while a ticker round is open; a round opens
    only while no foreground op is inside (see the module docstring)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._cv = threading.Condition()
        self._depth = 0          # the foreground thread's nesting
        self._round = False      # a ticker round is open
        self.seq = 0

    def __enter__(self):
        self._lock.acquire()
        with self._cv:
            if self._depth == 0:
                while self._round:
                    self._cv.wait()
                self.seq += 1
            self._depth += 1
        return self

    def __exit__(self, *exc):
        with self._cv:
            self._depth -= 1
        self._lock.release()

    def open_round(self, ready) -> int:
        """Open a ticker round if no foreground op is inside and
        ``ready()``: the count of foreground ops so far, else -1."""
        with self._cv:
            if self._depth or not ready():
                return -1
            self._round = True
            return self.seq

    def close_round(self):
        with self._cv:
            self._round = False
            self._cv.notify_all()


def _lease_ticker_loop(ref, stop: threading.Event) -> None:
    """Background ticker body (module-level: the thread holds only a WEAK
    reference to the backend).  Runs a round (``_ticker_round``) at a
    fraction of the idle interval so a tick lands within one interval of
    the threshold being crossed; ``stop`` is this thread's own event, so
    a ticker orphaned by a timed-out stop_ticker() stays stopped after
    start_ticker() installs a replacement; a garbage-collected backend
    ends the loop at the next wake-up.

    On the card the tick is PyTorch work on the store's device, queued
    on ``torch.cuda.current_stream()``: in this thread, as in the main
    thread, that is the device's default stream (neither thread sets
    another), the stream every kernel wrapper launches on
    (``kernels/ops.py``).  So a tick is ordered with the main thread's
    kernels on the card, and the backend's lock orders them on the
    host."""
    fails = 0
    while True:
        be = ref()
        if be is None:
            return
        quantum = max(be.lease_interval_s / 5.0, 0.01)
        be = None                      # never hold the ref across a wait
        stopping = stop.wait(quantum)
        be = ref()
        if be is None:
            return
        try:
            ticked, ended = be._ticker_round(stopping)
            if ended:
                return
            if not ticked:
                continue
            be.telemetry.count("ticker_rounds")
            fails = 0
        except Exception as e:   # noqa: BLE001 — a daemon thread must not
            # die silently: idle detection would be off with no signal
            fails += 1
            be.telemetry.count("ticker_errors")
            warnings.warn(
                f"lease ticker tick failed ({e!r}); "
                f"{'giving up' if fails >= 3 else 'retrying'}",
                RuntimeWarning)
            if fails >= 3:
                # latch the give-up so start_ticker() stops claiming a
                # ticker runs, and the counters carry the signal
                be._ticker_gave_up = True
                be.telemetry.count("ticker_gave_up")
                return
        finally:
            be = None


class DistributedBackend:
    """The kvstore ops over ``groups`` index groups (the JAX package's
    takes a mesh of G devices): routed two-sided PUT/DELETE with log
    replication, one-sided GET with the second-hop fetch, the
    all-gathered SCAN, the value plane's GC flush and migration, index-
    and data-server failure and recovery, and lease-based failure
    detection with its background ticker.  Without ``comm`` the groups
    are stacked on one device; with one (``comm.py``), over its ranks,
    each holding G / W of them, every rank running the same calls.  All
    state lives on ``device``: the card (the comm's) unless the caller
    passes another.  ``key_dtype`` is the width of the store's keys, as
    ``LocalBackend``'s: int32 (the default) or int64 (JAX's x64
    deployment); the client casts keys to it."""

    def __init__(self, groups: int, cfg, capacity_per_group: int = 4096, *,
                 capacity_q: int = 64, scan_limit: int = 128, device=None,
                 comm=None, key_dtype=torch.int32):
        _check_key_dtype(key_dtype, "DistributedBackend")
        self.comm = comm if comm is not None else Comm.single(groups)
        if device is None:
            device = self.comm.device
        self.device = _resolve_device(device, "DistributedBackend")
        self.cfg = cfg
        self.telemetry = tm.Telemetry(getattr(cfg, "telemetry",
                                              "counters"))
        self.G = groups
        self.key_dtype = key_dtype
        self.store = kv.create(groups, capacity_per_group, cfg, self.device,
                               self.comm, key_dtype)
        self.capacity_q = capacity_q
        self.scan_limit = scan_limit
        self.ops = kv.make_ops(cfg, groups, capacity_q, scan_limit,
                               self.comm)
        self.batch_multiple = groups
        self.value_words = cfg.value_words
        self.max_mutation_batch = cfg.log_capacity
        self._dead: set[int] = set()        # index servers masked dead
        self._data_dead: set[int] = set()   # data servers masked dead
        self._pending_bound = 0        # host-side upper bound, no dev sync
        # --- lease-based failure detection (paper §5) --------------------
        # every routed op bumps per-server heartbeat counters for both
        # planes; the client ages them here and demotes a server to
        # degraded routing once its lease expires, with no oracle call.
        # Two clocks: "wall" (elapsed monotonic time since the counter
        # last advanced against cfg.lease_timeout_s) and "rounds" (the
        # deterministic test mode: cfg.lease_misses stalled observation
        # rounds).  lease_misses == 0 disables detection.
        self.lease_misses = int(getattr(cfg, "lease_misses", 0) or 0)
        self.lease_clock = str(getattr(cfg, "lease_clock", "rounds"))
        self.lease_timeout_s = float(getattr(cfg, "lease_timeout_s", 0.0))
        self.lease_interval_s = float(
            getattr(cfg, "lease_interval_s", 0.0) or 0.25)
        if self.lease_clock not in ("wall", "rounds"):
            raise ValueError(
                f"cfg.lease_clock must be 'wall' or 'rounds', got "
                f"{self.lease_clock!r}")
        if (self.lease_misses > 0 and self.lease_clock == "wall"
                and self.lease_timeout_s <= 0):
            raise ValueError(
                "wall-clock leases need cfg.lease_timeout_s > 0 "
                "(set lease_misses=0 to disable detection instead)")
        self._severed: set[int] = set()     # injector-crashed index srvs
        self._data_severed: set[int] = set()  # injector-crashed data srvs
        now = time.monotonic()
        self._last_hb = np.zeros((self.G,), np.int64)
        self._hb_misses = np.zeros((self.G,), np.int64)
        self._hb_t = np.full((self.G,), now, np.float64)   # last advance
        self._last_data_hb = np.zeros((self.G,), np.int64)
        self._data_hb_misses = np.zeros((self.G,), np.int64)
        self._data_hb_t = np.full((self.G,), now, np.float64)
        self.detected: list[int] = []       # index demotions the detector
        self.detected_data: list[int] = []  # data demotions the detector
        # the store and the lease state are shared with the background
        # ticker thread: one reentrant lock serializes every op, and a
        # ticker round holds new ops back
        self._mu = _OpLock()
        self._last_traffic_t = now
        # the comm _lease_tick gathers and agrees over: the store's, and
        # the host group's (comm.host(), made by start_ticker) while a
        # ticker round ticks
        self._lease_comm = self.comm
        self._host: Optional[Comm] = None
        self._ticker: Optional[threading.Thread] = None
        self._ticker_stop: Optional[threading.Event] = None
        self._ticker_gave_up = False   # the loop died on repeated errors

    def _ensure_log_room(self, n: int):
        # drain up front when a batch might not fit the worst backup log
        if self._pending_bound + n > self.cfg.log_capacity:
            self.drain()

    def _degraded(self) -> bool:
        return bool(self._dead or self._data_dead)

    # -- lease detector ----------------------------------------------------
    def _lease_expired(self, misses: np.ndarray, last_t: np.ndarray,
                       g: int, now: float) -> bool:
        """One server's lease verdict after a stalled observation: rounds
        mode counts stalled rounds against ``lease_misses``; wall mode
        measures the time since the counter last advanced against
        ``lease_timeout_s``."""
        if self.lease_clock == "wall":
            return now - last_t[g] >= self.lease_timeout_s
        return misses[g] >= self.lease_misses

    def _lease_tick(self, bump: bool = False):
        """Age the leases of both planes after an observation round: a
        server whose heartbeat counter did not advance accumulates a
        stalled round (and its stall timer keeps running); an expired
        lease demotes it.  ``bump`` runs the heartbeat-only tick op
        first: read-only rounds (GET) and the idle ticker age leases
        through it, mutating ops bump in their bodies."""
        if self.lease_misses <= 0:
            return
        self.telemetry.count("lease_ticks")
        if bump:
            self.store = self.ops["tick"](self.store)
        now = time.monotonic()
        self._last_traffic_t = now
        # one device-to-host copy for both planes' counters (gathered
        # over the ranks)
        cm = self._lease_comm
        hb, dhb = cm.all_gather(torch.stack(
            [self.store.hb, self.store.data.hb], 1).to(
                cm.device or self.device)).T.cpu().numpy()
        self._age_plane(hb, self._last_hb, self._hb_misses, self._hb_t,
                        self._dead, self._demote, now, cm)
        self._age_plane(dhb, self._last_data_hb, self._data_hb_misses,
                        self._data_hb_t, self._data_dead,
                        self._demote_data, now, cm)
        self._last_hb = hb
        self._last_data_hb = dhb

    def _age_plane(self, hb, last, misses, last_t, dead, demote,
                   now: float, cm):
        """Age one plane's leases against its freshly read counters (the
        one aging body both planes share).  The ranks' wall clocks
        differ, so over ranks a wall-clock lease expires where it has
        run out on every rank (``cm``'s agree of the minimum): no rank
        demotes a server sooner than its own clock says."""
        expired = np.zeros((self.G,), bool)
        for g in range(self.G):
            if g in dead:
                continue
            if hb[g] != last[g]:
                misses[g] = 0
                last_t[g] = now
            else:
                misses[g] += 1
                expired[g] = self._lease_expired(misses, last_t, g, now)
        if self.lease_clock == "wall" and cm.distributed:
            expired = cm.agree(torch.as_tensor(expired),
                               "min").cpu().numpy().astype(bool)
        for g in np.nonzero(expired)[0]:
            demote(int(g), detected=True)

    def _demote(self, g: int, detected: bool = False):
        """Degraded routing for index server ``g``: the client-side half
        of a failure, no oracle call and no state wipe."""
        self.store = self.store._replace(
            alive=tree.put_leaf(self.store.alive, False, g))
        self._dead.add(g)
        self._hb_misses[g] = 0   # a demoted server no longer "stalls"
        if detected:
            self.detected.append(g)
        self.telemetry.count("index_demotions")
        self.telemetry.span({"event": "demote", "plane": "index",
                             "server": g, "detected": detected})

    def _demote_data(self, g: int, detected: bool = False):
        """Degraded routing for DATA server ``g``: GETs of its shard fail
        over to mirror-served fetches, PUTs displace one hop."""
        self.store = self.store._replace(data=self.store.data._replace(
            alive=tree.put_leaf(self.store.data.alive, False, g)))
        self._data_dead.add(g)
        self._data_hb_misses[g] = 0
        if detected:
            self.detected_data.append(g)
        self.telemetry.count("data_demotions")
        self.telemetry.span({"event": "demote", "plane": "data",
                             "server": g, "detected": detected})

    def lease_stalled(self) -> bool:
        """Did the last observation round see a not-yet-demoted server's
        heartbeat stalled (either plane)?  The client's wall-clock retry
        pacing keys on this."""
        return bool((self._hb_misses > 0).any()
                    or (self._data_hb_misses > 0).any())

    # -- background ticker (idle-client wall-clock detection) --------------
    def start_ticker(self) -> bool:
        """Start the background ticker thread: whenever no foreground
        traffic has run for ``cfg.lease_interval_s`` it issues a
        heartbeat-only tick round, so wall-clock leases expire with zero
        foreground ops.  No-op when detection is off.  Returns True if a
        ticker is running, and False when a previous one gave up after
        repeated tick errors (``stop_ticker()`` clears that latch).  Over
        ranks every rank calls it, and the tickers tick in agreed rounds
        (the module docstring)."""
        if self.lease_misses <= 0:
            return False
        if self._ticker_gave_up:
            return False
        if self._ticker is not None and self._ticker.is_alive():
            return True
        self._host = self.comm.host()
        stop = threading.Event()
        self._ticker_stop = stop
        # the thread holds only a weak reference to this backend (and a
        # finalizer sets its stop event): a client dropped without
        # stop_ticker() must not pin the store on the device
        self._ticker = threading.Thread(
            target=_lease_ticker_loop, args=(weakref.ref(self), stop),
            name="histore-lease-ticker", daemon=True)
        weakref.finalize(self, stop.set)
        self._ticker.start()
        return True

    def _ticker_round(self, stopping: bool) -> tuple:
        """One round of the background ticker, in lock step with the
        other ranks' (the module docstring): it ticks, as a foreground
        read-only op would, where every rank is idle after the same count
        of foreground ops and none is stopping.  Returns (ticked, ended:
        a rank stopped, so every ticker ends)."""
        seq = self._mu.open_round(lambda: not stopping and (
            time.monotonic() - self._last_traffic_t
            >= self.lease_interval_s))
        try:
            host = self._host
            v = host.all_gather(torch.tensor([[int(stopping), seq]]))
            ended = bool(v[:, 0].any())
            if ended or seq < 0 or not bool((v[:, 1] == seq).all()):
                return False, ended
            self._lease_comm = host
            try:
                self._lease_tick(bump=True)
            finally:
                self._lease_comm = self.comm
            return True, False
        finally:
            if seq >= 0:
                self._mu.close_round()

    def stop_ticker(self) -> None:
        # an explicit stop also clears the give-up latch
        self._ticker_gave_up = False
        if self._ticker is None:
            return
        self._ticker_stop.set()
        self._ticker.join(timeout=60.0)
        if self._ticker.is_alive():
            # still inside a tick; its own stop event is set, so it exits
            # at the next loop check and a new ticker gets a new event
            warnings.warn("lease ticker still draining a tick in flight "
                          "(exits at the next loop check)", RuntimeWarning)
        self._ticker = None
        self._ticker_stop = None

    # -- ops ---------------------------------------------------------------
    def put(self, keys, vals, valid):
        with self._mu:
            n = int(valid.sum())
            self._ensure_log_room(n)
            self._pending_bound += n
            # any masked-dead server -> the variant with the old-slot
            # replica probe and the value displacement
            op = self.ops["put_degraded" if self._degraded() else "put"]
            self.store, ok, addrs, nrep = op(self.store, keys, vals, valid)
            self._lease_tick()
            return ok, addrs, nrep

    def get(self, keys, valid):
        with self._mu:
            addrs, found, acc, vals, routed, val_ok = self.ops["get"](
                self.store, keys, valid)
            found = found & valid
            hops = valid.to(I32)
            # second hop: a value homed on another shard (or a dead data
            # server) is fetched by address from the first live holder
            need = found & ~val_ok
            if bool(need.any()):
                self.store, fvals, fok = self.ops["fetch"](self.store,
                                                           addrs, need)
                vals = torch.where(need[:, None], fvals, vals)
                routed = routed & (~need | fok)
                hops = hops + need.to(I32)
            self._lease_tick(bump=True)
            return addrs, found, acc, vals, routed & valid, hops

    def delete(self, keys, valid):
        with self._mu:
            n = int(valid.sum())
            self._ensure_log_room(n)
            self._pending_bound += n
            op = self.ops[
                "delete_degraded" if self._degraded() else "delete"]
            self.store, ok, found, nrep = op(self.store, keys, valid)
            self._lease_tick()
            return ok, found & valid, nrep

    def scan(self, lo, hi, limit: int):
        with self._mu:
            loa = lo.reshape(1).expand(self.G)
            hia = hi.reshape(1).expand(self.G)
            # the result width is static: one scan op per distinct limit
            scan_op = (self.ops if limit == self.scan_limit else kv.make_ops(
                self.cfg, self.G, self.capacity_q, limit, self.comm))["scan"]
            k, a, covered, self.store = scan_op(self.store, loa, hia)
            n = (k != key_inf(k.dtype)).sum(dtype=I32)
            self._pending_bound = 0          # scan drained the logs
            self._lease_tick()
            return k, a, n, covered

    def apply_async(self):
        with self._mu:
            self.store = self.ops["apply"](self.store)
            self._pending_bound = max(
                0, self._pending_bound - self.cfg.async_apply_batch)
            self._lease_tick()

    def gc_round(self):
        """One routed flush of the pending free queues."""
        with self._mu:
            self.store = self.ops["gc"](self.store)
            self._lease_tick()

    def pending_frees(self) -> int:
        with self._mu:
            return int(self.comm.agree(
                lg.pending_count(self.store.data.freeq).sum(), "sum"))

    def drain(self):
        with self._mu:
            while self.pending_ops() > 0:
                self.apply_async()
            self._pending_bound = 0
            # flush the free queues until empty or stuck (frees addressed
            # to a dead data shard stay queued)
            prev = -1
            while True:
                cur = self.pending_frees()
                if cur == 0 or cur == prev:
                    break
                prev = cur
                self.gc_round()

    def pending_ops(self) -> int:
        with self._mu:
            return int(self.comm.agree(
                (self.store.blog.tail - self.store.blog.applied).max(),
                "max"))

    def telemetry_gauges(self) -> dict:
        with self._mu:
            return kv.device_counters(self.store, self.comm)

    def migrate_values(self) -> int:
        """Background value migration: move degraded-write strays home and
        patch the index addresses; the pass's log barrier runs as apply
        rounds.  Returns the values moved."""
        with self._mu:
            self.store, moved = kv.migrate_values(
                self.store, self.cfg, apply_fn=self.ops["apply"],
                comm=self.comm)
            return moved

    # -- failures and recovery ---------------------------------------------
    def _wipe_capability(self, what: str) -> bool:
        # wiping needs a surviving copy to exist; with one group every
        # replica lives on the failing server, so the failure degrades to
        # mask-only, said out loud (FailResult.wiped + a warning)
        if self.G > 1:
            return True
        warnings.warn(
            f"single-device mesh: {what} degrades to mask-only (every "
            "replica lives on the failing device, so no surviving copy "
            "could exist; state is masked, NOT wiped)", RuntimeWarning,
            stacklevel=3)
        return False

    def fail_server(self, server: int) -> FailResult:
        with self._mu:
            wiped = self._wipe_capability("fail_server")
            self.store = kv.fail_server(self.store, server, wipe=wiped,
                                        comm=self.comm)
            self._dead.add(server)
            # a known-dead server no longer "stalls"
            self._hb_misses[server] = 0
            self._hb_t[server] = time.monotonic()
            return FailResult(server, wiped)

    def sever_server(self, server: int) -> FailResult:
        """Crash ``server`` without updating the routing view: its
        heartbeats stop and its state is destroyed, but ``alive`` still
        says up until the lease detector (or a recovery) demotes it."""
        with self._mu:
            wiped = self._wipe_capability("sever_server")
            self.store = kv.sever_server(self.store, server, wipe=wiped,
                                         comm=self.comm)
            self._severed.add(server)
            return FailResult(server, wiped)

    def recover_server(self, server: int, online: bool = True,
                       re_replicate: bool = True) -> RecoverResult:
        """Rebuild ``server`` and re-admit it.  ``online`` (default)
        snapshot-clones and lets the pending-log delta stream in through
        the ordinary apply rounds; ``re_replicate`` then verifies every
        live holder against the group authorities and rebuilds
        divergent copies."""
        with self._mu:
            if server in self._severed and server not in self._dead:
                # an operator's recovery implies the failure is known
                self._demote(server)
            # a RecoveryError propagates with the host-side tracking and
            # the store untouched: the server stays routed-dead
            self.store = kv.recover_server(self.store, server, self.cfg,
                                           online=online, comm=self.comm)
            n_reb = 0
            if re_replicate:
                self.store, n_reb = kv.re_replicate(self.store, self.cfg,
                                                    comm=self.comm)
            self._severed.discard(server)
            self._dead.discard(server)
            self._hb_misses[server] = 0
            self._hb_t[server] = time.monotonic()
            self.telemetry.count("index_recoveries")
            self.telemetry.span({"event": "recover", "plane": "index",
                                 "server": server, "online": online})
            return RecoverResult(server, online, n_reb, self.pending_ops())

    def fail_data_server(self, server: int) -> FailResult:
        with self._mu:
            wiped = self._wipe_capability("fail_data_server")
            self.store = kv.fail_data_server(self.store, server,
                                             wipe=wiped, comm=self.comm)
            self._data_dead.add(server)
            self._data_hb_misses[server] = 0   # see fail_server
            self._data_hb_t[server] = time.monotonic()
            return FailResult(server, wiped)

    def sever_data_server(self, server: int) -> FailResult:
        """Crash ``server``'s DATA server without updating the routing
        view: reads of its shard fail over to the mirrors per op at
        once; writes nack and retry until the lease detector demotes
        it."""
        with self._mu:
            wiped = self._wipe_capability("sever_data_server")
            self.store = kv.sever_data_server(self.store, server,
                                              wipe=wiped, comm=self.comm)
            self._data_severed.add(server)
            return FailResult(server, wiped)

    def recover_data_server(self, server: int):
        """Rebuild ``server``'s data shard from its mirrors and re-admit
        it, from the oracle-masked or the lease-detected state alike."""
        with self._mu:
            if server in self._data_severed and \
                    server not in self._data_dead:
                self._demote_data(server)
            self.store = kv.recover_data_server(
                self.store, server, self.cfg, apply_fn=self.ops["apply"],
                comm=self.comm)
            self._data_severed.discard(server)
            self._data_dead.discard(server)
            self._data_hb_misses[server] = 0
            self._data_hb_t[server] = time.monotonic()
            self.telemetry.count("data_recoveries")
            self.telemetry.span({"event": "recover", "plane": "data",
                                 "server": server})


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
        kd = self._key_dtype
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
        # scan-completeness retry: a group with no live, unsevered holder
        # answered nothing.  Each rescan is an observation round (paced
        # by _retry_pause under wall-clock leases), so the bounded
        # retries let the lease detector demote the crashed holders;
        # coverage only returns once they are recovered, so afterwards
        # the scan reports the missing groups instead of looping
        budget = min(self.max_retries,
                     max(getattr(self.backend, "lease_misses", 0), 0) + 1)
        tries = 0
        cov = covered.cpu().numpy()
        while not bool(cov.all()) and tries < budget:
            # rescans help only while the detector watches a stalled
            # heartbeat; once the holders are demoted (or oracle-failed)
            # report after one round
            if not self.backend.lease_stalled():
                break
            tries += 1
            self.stats["retries"] += 1
            self.telemetry.count("retries")
            self._retry_pause(budget)
            k, a, n, covered = self.backend.scan(
                torch.as_tensor(lo, dtype=kd, device=self.device),
                torch.as_tensor(hi, dtype=kd, device=self.device), limit)
            cov = covered.cpu().numpy()
        missing = tuple(int(g) for g in np.nonzero(~cov)[0].tolist())
        tel = self.telemetry
        if tel.enabled:
            tel.count("scan_ops")
            tel.observe("scan", time.perf_counter() - t0)
            if missing:
                tel.count("incomplete_scans")
            tel.span({"op": "scan", "limit": limit, "retries": tries,
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
        """Start the backend's background lease ticker (idle-client
        wall-clock failure detection).  True when one is running; False
        for backends without leases (LocalBackend tracks liveness on the
        host) or with detection off (lease_misses=0)."""
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

    @property
    def _key_dtype(self):
        """The backend's key dtype (int32 where it names none)."""
        return getattr(self.backend, "key_dtype", None) or key_dtype()

    def _as_keys(self, keys):
        k = torch.as_tensor(np.asarray(keys) if not torch.is_tensor(keys)
                            else keys, device=self.device).to(self._key_dtype)
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

    def _retry_pause(self, budget: Optional[int] = None):
        """Wall-clock leases expire by elapsed time, not retry count: an
        unpaced retry loop would run out of retries long before a crashed
        server's lease can expire.  Pace the loop (the RPC client's
        backoff) so its remaining budget spans at least one lease
        timeout, only while the detector watches a stalled heartbeat; a
        healthy push-back retry stays fast.  No-op in rounds mode, with
        detection off, and for lease-less backends."""
        be = self.backend
        if getattr(be, "lease_clock", "") != "wall":
            return
        if getattr(be, "lease_misses", 0) <= 0:
            return
        if not be.lease_stalled():
            return
        # the first stalled round goes unpaced (the stall is only
        # observable after it), so spread the timeout over budget - 1
        n = max(budget if budget is not None else self.max_retries, 2)
        time.sleep(be.lease_timeout_s / (n - 1))

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
            self._retry_pause()
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
            self._retry_pause()
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
            self._retry_pause()
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
