"""The rank processes' side of the port's tests over ``torch.distributed``
(``tests/test_torch_dist_ranks.py``, ``tests/test_torch_dist_selftest.py``,
``tests/test_torch_dist_faults.py``).

``repro_torch.launch.ranks.spawn`` pickles these functions by name, so
they live in a module that a fresh process imports without JAX: each
takes (rank, world, device, ...), checks what it computes with asserts
(a failed one fails the spawn) and returns plain data.
"""
from __future__ import annotations

import functools
import json
import threading
import time
import types
import warnings
from typing import NamedTuple

import numpy as np
import torch

import _dist_battery as battery
from _answers import plain
import _dist_fault_schedules as S
from oracle import FaultInjector
from repro_torch.configs.histore import scaled
from repro_torch.convert import distributed_backend_from_numpy
from repro_torch.core import kvstore as kv
from repro_torch.core import sorted_index as six
from repro_torch.core import tree, verbs
from repro_torch.core.client import DistributedBackend, HiStoreClient
from repro_torch.core.comm import Comm
from repro_torch.launch import ranks

G = 8


def _same(got, want, label):
    assert got.dtype == want.dtype, (label, got.dtype, want.dtype)
    assert tuple(got.shape) == tuple(want.shape), (label, got.shape,
                                                   want.shape)
    assert torch.equal(got, want), label


class _State(NamedTuple):
    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor


def comm_verbs(rank, world, device, seed):
    """Every verb of a Comm over ``world`` ranks against the one-process
    verb on the same global buffers (random int32, int8 and bool): the
    rank's rows of each answer equal.  Returns the collective counts."""
    comm = ranks.comm(G, device)
    one = Comm.single(G)
    g0, L = comm.g0, comm.L
    loc = comm.loc
    rng = np.random.default_rng(seed)          # the same on every rank
    c = 3
    full = {
        "i": torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31 - 1, (G, G * c),
                                          dtype=np.int32)),
        "b": torch.as_tensor(rng.random((G, G * c)) < 0.5),
        "v": torch.as_tensor(rng.integers(-9, 9, (G, G * c, 2),
                                          dtype=np.int8)),
    }
    mine = {k: loc(x) for k, x in full.items()}
    # exchange and the route back
    want = one.exchange(full)
    for k, x in comm.exchange(mine).items():
        _same(x, loc(want[k]), f"exchange {k}")
    slot = torch.as_tensor(rng.integers(0, G * c + 2, (G, 5), dtype=np.int32))
    want = verbs.route_return(full, slot, one)
    for k, x in verbs.route_return(mine, loc(slot), comm).items():
        _same(x, loc(want[k]), f"route_return {k}")
    # every shift the op bodies use: 1, r + 1, G - 1, (G - (r + 1)) % G,
    # and the whole ring
    shifts = sorted(set(range(G + 1)) | {(G - (r + 1)) % G for r in range(3)}
                    | {-1, 2 * G + 3})
    for s in shifts:
        got = comm.shift(mine, s)
        for k, x in one.shift(full, s).items():
            _same(got[k], loc(x), f"shift {s} {k}")
    # all_gather along the group axis, 0 or 1
    x = torch.as_tensor(rng.integers(0, 100, (3, G, 4), dtype=np.int32))
    _same(comm.all_gather(x[:, g0:g0 + L], 1), x, "all_gather axis 1")
    _same(comm.all_gather(loc(full["b"])), full["b"], "all_gather bool")
    _same(comm.lanes(comm.rows(torch.arange(4 * G))), torch.arange(4 * G),
          "rows -> lanes")
    # one group's state from its owner
    st = _State(full["i"], full["b"][:, 0], full["v"])
    for g in range(G):
        for got, want in zip(comm.group_leaves(_State(*map(loc, st)), g),
                             tree.at(st, g)):
            _same(got, want, f"group_leaves {g}")
    # rows to their groups' owners: each rank's rows, in order, from
    # every source rank in turn
    rows = torch.as_tensor(rng.integers(0, 1000, (world, 7, 2),
                                        dtype=np.int32))
    dest = torch.as_tensor(rng.integers(0, G, (world, 7)))
    got = comm.to_owners(rows[rank], dest[rank])
    want = torch.cat([rows[s][dest[s] // L == rank] for s in range(world)])
    _same(got, want, "to_owners")
    _same(one.to_owners(rows[0], dest[0]), rows[0], "to_owners one")
    # whole tensors between groups' owners, within a rank and across
    src = torch.as_tensor(rng.integers(-50, 50, (G, 3, 2), dtype=np.int32))
    flag = torch.as_tensor(rng.random((G, 3)) < 0.5)
    plan = [(int(a), int(b)) for a, b in rng.integers(0, G, (6, 2))]
    moves = [(a, b, (src[a], flag[a]) if comm.owns(a) else None)
             for a, b in plan]
    for (a, b), got in zip(plan, comm.move(moves, (src[0], flag[0]))):
        if comm.owns(b):
            _same(got[0], src[a], f"move {a} -> {b}")
            _same(got[1], flag[a], f"move {a} -> {b} bool")
        else:
            assert got is None, (a, b)
    whole = [(src[a], flag[a]) for a, _ in plan]
    got = one.move([(a, b, t) for (a, b), t in zip(plan, whole)],
                   (src[0], flag[0]))
    assert all(x is t for x, t in zip(got, whole)), "one process copies"
    # host decisions agreed
    assert int(comm.agree(rank, "max")) == world - 1
    assert int(comm.agree(rank, "min")) == 0
    assert int(comm.agree(torch.tensor(rank + 1), "sum")) == \
        world * (world + 1) // 2
    v = comm.agree(torch.as_tensor(np.arange(G) == rank))
    assert v.tolist() == [int(g < world) for g in range(G)]
    return {k: dict(v) for k, v in comm.stats.items()}


def _store_equal(store, comm, want, label):
    """The gathered ``store`` bit-equal, dtype too, to the one-process
    ``want``."""
    got, ref = {}, {}
    battery.leaves(kv.gathered(store, comm), "", got)
    battery.leaves(want, "", ref)
    assert sorted(got) == sorted(ref)
    for k, v in got.items():
        assert v.dtype == ref[k].dtype, (label, k, v.dtype, ref[k].dtype)
        np.testing.assert_array_equal(v, ref[k], err_msg=f"{label} {k}")


def answered(rank, world, device):
    """The data servers' fail / sever / recover and the ticker, once
    refused over ranks, answer as on one process: the same FailResults,
    reads, value-slot audit before the migration, values moved, detector
    lists, RecoveryError where no mirror lives, and store leaves (every
    rank also runs the one-process client on the same calls).  Data
    server 3's keys written while it is down land on shard 4, another
    rank's at W = 2, 4 and 8, so the recovery's sweep must mark them
    there.  Returns the answers."""
    comm = ranks.comm(G, device)
    # rounds leases, and an interval no ticker round reaches here
    cfg = scaled(log_capacity=64, async_apply_batch=32, use_kernels="off",
                 lease_clock="rounds", lease_misses=2, lease_interval_s=60.0)
    keys = np.arange(1, 8 * G + 1) * 7919
    more = np.arange(1, 4 * G + 1) * 104729
    both = np.concatenate([keys, more])
    out = []
    for cm in (comm, None):
        c = HiStoreClient(DistributedBackend(G, cfg, 64, device=device,
                                             comm=cm), batch_quantum=2 * G,
                          migrate_on_recover=False)
        be = c.backend
        assert c.put(keys, np.arange(len(keys))).all_ok
        ans = [list(c.fail_data_server(3))]
        assert c.put(more, np.arange(len(more)) + 500).all_ok
        g = c.get(both)
        ans.append([bool(g.all_found), g.hops.tolist()])
        c.recover_data_server(3)
        ans.append(kv.parity_report(be.store, cfg, comm=cm)[-1])
        ans.append(c.migrate())
        ans.append(list(c.sever_data_server(2)))
        while 2 not in be._data_dead:
            c.get(keys[:G])
        c.recover_data_server(2)
        assert be.start_ticker() is True
        be.stop_ticker()
        g = c.get(both)
        ans.append([bool(g.all_found), g.hops.tolist(),
                    g.values[:, 0].tolist(), be.detected_data,
                    sorted(be._data_dead), dict(c.stats)])
        # no live mirror: raised alike on every rank, nothing written
        c.fail_data_server(4)
        c.fail_data_server(5)
        try:
            c.recover_data_server(4)
        except kv.RecoveryError as e:
            ans.append([e.group, e.searched, e.blockers,
                        sorted(be._data_dead)])
        else:
            raise AssertionError("a recovery with no live mirror ran")
        out.append(ans)
        if cm is not None:
            mine = be.store
    assert out[0] == out[1], out
    _store_equal(mine, comm, be.store, "answered")
    return out[0]


def keys64_store(rank, world, device, events):
    """The int64 store of ``tests/test_torch_dist_keys64.py`` (case 1's
    config) over the ranks and on one process, through ``events``: the
    same answers on every rank as on one process, and the gathered store
    bit-equal to the one-process store, dtypes included.  Returns the
    answers and the store's key dtype."""
    import _dist_keys64_jax as D

    comm = ranks.comm(G, device)
    out = []
    for cm in (comm, None):
        c = HiStoreClient(DistributedBackend(
            G, scaled(**D.cfg_kw(1)), D.DCAP, capacity_q=D.CASES[1][2],
            scan_limit=128, device=device, comm=cm, key_dtype=torch.int64),
            batch_quantum=D.QUANTUM, max_retries=32)
        out.append(D.drive(c, events))
        if cm is not None:
            mine = c.backend.store
    assert out[0] == out[1]
    _store_equal(mine, comm, c.backend.store, "keys64")
    return {"answers": plain(out[0]),
            "key_dtype": str(mine.bsorted.keys.dtype)}


def fault_env(comm, device):
    """``_dist_fault_schedules``'s env over ``comm``'s ranks."""
    cfg = scaled(**S.CFG_KW)

    def own(keys):
        k = torch.as_tensor(np.asarray(keys).astype(np.int32))
        return kv.owner_group(k, G).numpy()

    return types.SimpleNamespace(
        cfg=cfg, own=own,
        kv=types.SimpleNamespace(
            parity_report=functools.partial(kv.parity_report, comm=comm),
            RecoveryError=kv.RecoveryError),
        make_client=lambda **kw: HiStoreClient(DistributedBackend(
            G, cfg, S.CAP, capacity_q=64, scan_limit=128, device=device,
            comm=comm), **kw))


def _leaves_vs(store, comm, want, prefix):
    """The gathered store's leaves bit-equal (dtype too) to JAX's
    ``{prefix}/leaf/...``; returns how many."""
    got = {}
    battery.leaves(kv.gathered(store, comm), prefix, got)
    assert sorted(got) == sorted(k for k in want
                                 if k.startswith(f"{prefix}/leaf/"))
    for k, v in got.items():
        assert v.dtype == want[k].dtype, (k, v.dtype, want[k].dtype)
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    return len(got)


def faults_vs_jax(rank, world, device, npz, names):
    """The failure schedules ``names`` of ``_dist_fault_schedules`` (and
    "carry": a JAX store taken mid-outage, carried onto the ranks by
    ``distributed_backend_from_numpy(..., comm=)``) over the ranks, each
    record equal to JAX's 8-device mesh's and the gathered store leaves
    bit-equal (the ``.npz`` at ``npz``).  Returns {name: leaves
    compared}."""
    comm = ranks.comm(G, device)
    env = fault_env(comm, device)
    with np.load(npz) as z:
        want = {k: z[k] for k in z.files}
    out = {}
    for name in names:
        if name != "carry":
            rec, c = S.SCHEDULES[name](env)
            S.assert_record_equal(rec, json.loads(str(want[f"{name}/rec"])),
                                  f"{name} rank {rank}")
            out[name] = _leaves_vs(c.backend.store, comm, want, name)
            continue
        lease = json.loads(str(want["carry/lease"]))
        be = distributed_backend_from_numpy(
            S.leaf_tree(want, "carry"), env.cfg, device, capacity_q=64,
            scan_limit=128, pending_bound=int(want["carry/pending_bound"]),
            lease=lease, comm=comm)
        n = _leaves_vs(be.store, comm, want, "carry")
        assert be._dead == {2} and be._severed == {5}
        assert be.store.hb.shape == (comm.L,)
        c = HiStoreClient(be, batch_quantum=4 * G, max_retries=32)
        rec = S.carry_after(env, c)
        S.assert_record_equal(rec, json.loads(str(want["carry/rec"])),
                              f"carry rank {rank}")
        out[name] = n + _leaves_vs(be.store, comm, want, "carry_end")
    return out


# the wall-clock leases of the ticker's tests (the one-process tests'
# _wall_client)
WALL_KW = dict(use_kernels="off", log_capacity=512, async_apply_batch=128,
               lease_misses=3, lease_clock="wall", lease_timeout_s=0.2,
               lease_interval_s=0.05)


def _wall_client(comm, device):
    cfg = scaled(**WALL_KW)
    return HiStoreClient(DistributedBackend(
        G, cfg, S.CAP, capacity_q=64, device=device, comm=comm),
        batch_quantum=4 * G, max_retries=32), cfg


def ticker_idle_sever(rank, world, device):
    """``lease_selftest.run_idle_wall_clock`` over the ranks: after a
    sever no foreground op runs, and every rank's ticker demotes the
    server in the same round, no sooner than the lease timeout by its
    own clock, within it plus an interval and slack; stop_ticker()
    stops every thread; recovery restores reads and parity.  Returns
    (seconds to the demotion, ticker rounds)."""
    comm = ranks.comm(G, device)
    client, cfg = _wall_client(comm, device)
    backend = client.backend
    keys = np.random.RandomState(17).choice(10 ** 6, 8 * G,
                                            replace=False) + 1
    assert client.put(keys, np.arange(len(keys))).all_ok
    client.drain()
    assert client.start_ticker()
    try:
        inj = FaultInjector(client)
        t0 = time.monotonic()
        inj.sever(3)
        t_hb = float(backend._hb_t[3])
        stats0 = dict(client.stats)
        budget = cfg.lease_timeout_s + cfg.lease_interval_s + 5.0
        while 3 not in backend._dead:
            time.sleep(0.01)
            assert time.monotonic() - t0 <= budget, "no idle detection"
        took = time.monotonic() - t0
        assert time.monotonic() - t_hb >= cfg.lease_timeout_s
        assert backend.detected == [3] and backend._dead == {3}
        assert dict(client.stats) == stats0, "zero foreground ops"
        assert inj.oracle_kills == 0
        rounds = client.metrics().counters.get("ticker_rounds", 0)
        assert rounds > 0
        t = backend._ticker
    finally:
        client.stop_ticker()
    assert not t.is_alive() and backend._ticker is None
    n = client.metrics().counters.get("ticker_rounds", 0)
    time.sleep(4 * cfg.lease_interval_s)
    assert client.metrics().counters.get("ticker_rounds", 0) == n
    client.recover_server(3)
    assert client.get(keys).all_found
    assert all(p["agree"] for p in kv.parity_report(backend.store, cfg,
                                                    comm=comm))
    return took, rounds


def ticker_gave_up(rank, world, device):
    """Three consecutive tick errors end every rank's ticker and say so,
    as on one process: ticker_errors 3, ticker_gave_up 1, start_ticker()
    False while latched, stop_ticker() clearing the latch."""
    comm = ranks.comm(G, device)
    client, _ = _wall_client(comm, device)
    backend = client.backend

    def boom(bump=False):
        raise RuntimeError("injected tick failure")

    backend._lease_tick = boom
    backend._last_traffic_t = time.monotonic() - 999.0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the loop's RuntimeWarning
        assert client.start_ticker()
        t = backend._ticker
        t.join(timeout=30.0)
    assert not t.is_alive(), "3 consecutive errors must end the loop"
    c = client.metrics().counters
    assert c.get("ticker_errors", 0) == 3
    assert c.get("ticker_gave_up", 0) == 1
    assert backend._ticker_gave_up is True
    assert client.start_ticker() is False
    client.stop_ticker()
    assert backend._ticker_gave_up is False
    return dict(c)


def ticker_foreground(rank, world, device):
    """Foreground PUTs and GETs from a thread while every rank's ticker
    ticks between them: every answer right, the ticks' collectives never
    paired with the store's (no hang), the ticker stopped.  Returns the
    ticker rounds."""
    comm = ranks.comm(G, device)
    client, _ = _wall_client(comm, device)
    keys = np.arange(1, 8 * G + 1) * 104729
    assert client.start_ticker()
    errors = []

    def work():
        try:
            for i in range(6):
                assert client.put(keys, np.arange(len(keys)) + i).all_ok
                time.sleep(0.06)
                g = client.get(keys)
                np.testing.assert_array_equal(g.values[:, 0].numpy(),
                                              np.arange(len(keys)) + i)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    try:
        th = threading.Thread(target=work)
        th.start()
        th.join(timeout=120)
        assert not th.is_alive(), "the foreground thread hangs"
    finally:
        client.stop_ticker()
    assert not errors, errors
    rounds = client.metrics().counters.get("ticker_rounds", 0)
    assert rounds > 0
    assert client.backend.detected == []
    return rounds


def ticker_cases(rank, world, device):
    """The three ticker bodies in one spawn, one after the other (each
    with a backend and a host group of its own): {name: its result}."""
    return {fn.__name__: fn(rank, world, device)
            for fn in (ticker_idle_sever, ticker_gave_up, ticker_foreground)}


def fail_on_rank_one(rank, world, device):
    if rank == 1:
        raise ValueError("rank one fails")
    return rank


def rank_env(comm, device):
    """The battery's env for the port over ``comm``'s ranks (its control
    plane calls bound to the comm)."""
    def own(keys):
        k = torch.as_tensor(np.asarray(keys).astype(np.int32))
        return kv.owner_group(k, G).numpy()

    bound = types.SimpleNamespace(**{
        name: functools.partial(getattr(kv, name), comm=comm)
        for name in ("fail_server", "recover_server", "parity_report")})
    return types.SimpleNamespace(
        G=G, scaled=scaled, kv=bound,
        create=lambda cap, cfg: kv.create(G, cap, cfg, device, comm),
        make_ops=lambda cfg, capacity_q, scan_limit: kv.make_ops(
            cfg, G, capacity_q, scan_limit, comm),
        make_client=lambda cfg, cap, capacity_q, scan_limit, **kw:
            HiStoreClient(DistributedBackend(
                G, cfg, cap, capacity_q=capacity_q, scan_limit=scan_limit,
                device=device, comm=comm), **kw),
        arr=lambda a: torch.as_tensor(a, device=device), own=own,
        directory_levels=six.directory_levels,
        hash_fill=lambda st, g: comm.group_leaves(st.hash, g).fill.numpy())


def battery_vs_jax(rank, world, device, npz):
    """``_dist_battery.run`` over the ranks, every op output, client
    answer and gathered store leaf held bit for bit (dtype too) against
    JAX's 8-device mesh (the ``.npz`` at ``npz``).  Returns the number of
    arrays and answers compared on this rank."""
    comm = ranks.comm(G, device)
    rec, stores = battery.run(rank_env(comm, device))
    with np.load(npz) as z:
        want = {k: z[k] for k in z.files}
    n = 0
    for k, v in rec.items():
        w = want[f"rec/{k}"]
        if v.dtype.kind == "U":
            assert json.loads(str(v)) == json.loads(str(w)), k
        else:
            assert v.dtype == w.dtype and v.shape == w.shape, (k, v.dtype,
                                                                w.dtype)
            np.testing.assert_array_equal(v, w, err_msg=k)
        n += 1
    assert sorted(rec) == sorted(k[4:] for k in want if k.startswith("rec/"))
    for name, st in stores.items():
        got = {}
        battery.leaves(kv.gathered(st, comm), name, got)
        assert sorted(got) == sorted(k for k in want
                                     if k.startswith(f"{name}/leaf/"))
        for k, v in got.items():
            assert v.dtype == want[k].dtype, (k, v.dtype, want[k].dtype)
            np.testing.assert_array_equal(v, want[k], err_msg=k)
            n += 1
    return n


def probe_case(device):
    """A store of G = 8 groups with server 5 failed and a GET chunk's
    exchange buffers rk [8, 8 c] that reach every probe path (hash hits,
    misses, the degraded lanes' replica and log windows): (cfg, store,
    rk) on ``device``."""
    cfg = scaled(log_capacity=256, async_apply_batch=64)
    ops = kv.make_ops(cfg, G, capacity_q=32)
    st = kv.create(G, 512, cfg, "cpu")
    rng = np.random.default_rng(11)
    keys = rng.choice(10 ** 6, 8 * 32, replace=False).astype(np.int32) + 1
    vals = torch.zeros((keys.size, cfg.value_words), dtype=torch.int32)
    ok = torch.ones((keys.size,), dtype=torch.bool)
    st, *_ = ops["put"](st, torch.as_tensor(keys), vals, ok)
    st = ops["apply"](st)
    st = kv.fail_server(st, 5)
    more = torch.as_tensor(keys[:128] + 7)
    st, *_ = ops["put"](st, more, vals[:128], ok[:128])
    q = torch.as_tensor(np.concatenate([keys[::2], keys[:64] + 7,
                                        keys[:64] + 9]).astype(np.int32))
    q = q.reshape(G, -1)                 # each server's lanes
    rk, _, _ = kv.get_exchange(st, q, torch.ones_like(q, dtype=torch.bool),
                               G, 32)
    return cfg, _to(st, device), rk.to(device)


def _to(x, device):
    if hasattr(x, "_fields"):
        return type(x)(*[_to(v, device) for v in x])
    return x.to(device)


def rows_of(store, g0, L):
    """The stacked (hash, bsorted, blog) of groups g0 .. g0 + L - 1."""
    h = type(store.hash)(*[x[g0:g0 + L] for x in store.hash])
    s = type(store.bsorted)(*[x[:, g0:g0 + L] for x in store.bsorted])
    b = type(store.blog)(*[x[:, g0:g0 + L] for x in store.blog])
    return h, s, b
