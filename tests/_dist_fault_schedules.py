"""The distributed store's failure schedules, written once against the
client API so that the JAX package and the port replay the very same
calls (``tests/test_torch_dist_faults.py``).

Each schedule is one of ``tests/fault_selftest.py``'s or
``tests/lease_selftest.py``'s, with the same events, fault schedule and
assertions, at 512 slots a group.  It takes an ``env`` with:

  make_client(**kw)  a HiStoreClient over a DistributedBackend of G = 8
                     groups, 512 slots each, capacity_q 64 (``kw`` go to
                     the client);
  kv                 the package's kvstore module (``parity_report``,
                     ``RecoveryError``);
  own(keys)          the owner group of each key, as numpy;
  cfg                the store's config.

and returns (record, client): ``record`` is plain JSON data (every
client call's answer and the detector's lists after it, every
``FailResult`` / ``RecoverResult``, the parity reports, ``client.stats``
and the gauges), ``client`` the client, whose store leaves the caller
compares (``assert_record_equal``, ``leaf_tree``).  Nothing here imports
JAX or PyTorch.
"""
from __future__ import annotations

import json

import numpy as np

from _answers import _digest, host, plain
from oracle import (FaultInjector, Oracle, assert_equivalent, gen_ops,
                    replay, splice_faults)

G = 8
CAP = 512
# one config for every schedule, so each package builds its ops once:
# leases on the rounds clock (deterministic), lease_misses 2
CFG_KW = dict(log_capacity=512, async_apply_batch=128, lease_misses=2,
              lease_clock="rounds", use_kernels="off")


def assert_record_equal(got, want, label):
    """Equal records, the first difference named."""
    assert sorted(got) == sorted(want), label
    for key in want:
        if key == "log":
            assert len(got[key]) == len(want[key]), (label, "log length")
            for i, (a, b) in enumerate(zip(got[key], want[key])):
                assert a == b, (f"{label}: call {i} ({b[0]}) differs:\n"
                                f"  got={a}\n  want={b}")
        else:
            assert got[key] == want[key], (f"{label}: {key} differs:\n"
                                           f"  got={got[key]}\n"
                                           f"  want={want[key]}")


def leaf_tree(arrays, prefix):
    """The numpy leaves ``{prefix}/leaf/{dotted path}`` of ``arrays`` as a
    tree of namespaces, the shape a carry takes (``convert``'s
    ``*_from_numpy``)."""
    import types

    root = {}
    for k, v in arrays.items():
        if k.startswith(f"{prefix}/leaf/"):
            node = root
            *parents, name = k.split("/leaf/")[1].split(".")
            for p in parents:
                node = node.setdefault(p, {})
            node[name] = v

    def build(d):
        return types.SimpleNamespace(**{k: build(v) if isinstance(v, dict)
                                        else v for k, v in d.items()})
    return build(root)


class Rec:
    """The client with a log: every call's answer (ops, faults and
    recoveries) and the detector's lists after it.  Op results come back
    on the host, so ``oracle.replay`` reads them with numpy."""

    def __init__(self, client, log):
        self.client = client
        self.log = log

    def __getattr__(self, name):
        fn = getattr(self.client, name)
        if not callable(fn) or name.startswith("_") or name in (
                "metrics", "metrics_text"):
            return fn

        def call(*a, **k):
            r = fn(*a, **k)
            if name in ("put", "get", "delete", "scan"):
                r = type(r)(*[host(x) if hasattr(x, "shape") else x
                              for x in r])
                ans = _digest(name, r)
            else:
                ans = plain(r)
            be = self.client.backend
            self.log.append([name, plain(list(a)), ans,
                             list(getattr(be, "detected", [])),
                             list(getattr(be, "detected_data", []))])
            return r
        return call


def _finish(rec, client, env):
    """The record's tail: stats, gauges, the final parity report and the
    detector's lists."""
    rec["stats"] = dict(client.stats)
    rec["gauges"] = plain(client.metrics().gauges)
    rec["parity_end"] = plain(env.kv.parity_report(client.backend.store,
                                                   env.cfg))
    rec["detected"] = list(client.backend.detected)
    rec["detected_data"] = list(client.backend.detected_data)
    return json.loads(json.dumps(rec)), client


def _parity(env, c):
    return plain(env.kv.parity_report(c.backend.store, env.cfg))


def _owned_by(env, keys, dev, invert=False):
    own = env.own(keys)
    return keys[(own != dev) if invert else (own == dev)]


# ---------------------------------------------------------------------------
# a. fault_selftest.run_mix
# ---------------------------------------------------------------------------
def mix(env, mix_name: str, seed: int, dead_dev: int, n_events: int = 12):
    """``fault_selftest.run_mix``: an index server fails and recovers, a
    data server fails and recovers, the value-slot audit balances and
    every SCAN is complete after each phase, the store equals the Oracle
    throughout; then one-RTT reads after the migration, and PUTs while a
    holder is dead report n_backups - 1 for exactly the groups it
    holds."""
    cfg = env.cfg
    data_dev = (dead_dev + 3) % G
    ops = gen_ops(seed, mix_name, n_events=n_events, batch=3 * G)
    trace = splice_faults(ops, [
        (n_events // 4, "fail", dead_dev),
        (n_events // 2, "recover", dead_dev),
        (5 * n_events // 8, "fail_data", data_dev),
        (7 * n_events // 8, "recover_data", data_dev),
    ])
    log, rec = [], {}
    client = env.make_client(batch_quantum=4 * G, max_retries=32)
    sysm = Rec(client, log)
    phases = []

    def hook(c, event):
        c.drain()
        if not c.backend._data_dead:
            assert c.backend.pending_frees() == 0, \
                f"gc flush left frees queued after {event}"
        report = _parity(env, c)
        for p in report:
            if p.get("kind") == "value_slots":
                assert p["agree"], f"value audit broke after {event}: {p}"
            elif p["primary_alive"] and p["holder_alive"]:
                assert p["agree"], f"live parity broke after {event}: {p}"
        s = c.scan(0, 2 ** 31 - 1)
        assert s.complete is True and s.missing_groups == (), \
            f"scan completeness broke after {event}: {s.missing_groups}"
        phases.append([plain(event), report, c.backend.pending_frees()])

    oracle = Oracle(value_words=cfg.value_words)
    obs = replay(sysm, trace, phase_hook=hook)
    assert_equivalent(obs, replay(oracle, trace),
                      label=f"dist8/{mix_name}/seed{seed}")
    rec["obs"] = obs
    rec["phases"] = phases
    assert all(p["agree"] for p in env.kv.parity_report(
        client.backend.store, cfg)), "recovery must restore parity"
    live = np.fromiter(oracle.model.keys(), np.int64)
    if len(live):
        g_all = sysm.get(live)
        assert g_all.all_found, f"{mix_name}: post-recovery readback"
        assert bool((host(g_all.hops) == 1).all()), \
            f"{mix_name}: migration must restore one-RTT GETs"
    # reduced replication is reported honestly while a holder is dead
    sysm.fail_server(dead_dev)
    wk = np.random.RandomState(seed + 999).choice(
        10 ** 6, 8 * G, replace=False) + 7 * 10 ** 7
    w = sysm.put(wk, np.arange(8 * G))
    assert w.all_ok
    own = env.own(wk)
    rep = host(w.replicas)
    hit = np.isin(own, [(dead_dev - 1) % G, (dead_dev - 2) % G])
    assert (rep[hit] == cfg.n_backups - 1).all(), \
        "dead-holder groups must report n_backups - 1"
    assert (rep[~hit & (own != dead_dev)] == cfg.n_backups).all(), \
        "unaffected groups must keep full replication"
    sysm.recover_server(dead_dev)
    g = sysm.get(wk)
    assert g.all_found
    np.testing.assert_array_equal(host(g.values)[:, 0], np.arange(8 * G))
    rec["log"] = log
    return _finish(rec, client, env)


# ---------------------------------------------------------------------------
# b. lease_selftest.run_multi_failure
# ---------------------------------------------------------------------------
def multi_failure(env):
    """Adjacent double and triple index failures, delivered by severed
    heartbeats: the fallbacks (the primary's hash + the data items' keys,
    the data-plane scan) rebuild every copy and parity is clean; then a
    truly lost configuration raises RecoveryError with its blockers."""
    cfg, kv = env.cfg, env.kv
    log, rec = [], {}
    client = env.make_client(batch_quantum=4 * G, max_retries=32)
    sysm = Rec(client, log)
    backend = client.backend
    rng = np.random.RandomState(9)
    keys = rng.choice(10 ** 6, 16 * G, replace=False) + 1
    vals = np.arange(16 * G)
    assert sysm.put(keys, vals).all_ok
    sysm.drain()
    inj = FaultInjector(sysm)
    rec["parity"] = []

    def detect_all(devs):
        probe = keys[np.isin(env.own(keys), devs, invert=True)][:G]
        for _ in range(cfg.lease_misses + 1):
            sysm.get(probe)
        assert set(devs) <= backend._dead

    for d in (2, 3):
        inj.sever(d)
    detect_all([2, 3])
    assert sysm.get(keys).all_found, "degraded GETs across the double hole"
    inj.recover(2)
    inj.recover(3)
    rec["parity"].append(_parity(env, client))
    assert all(p["agree"] for p in rec["parity"][-1]), "double failure"
    for d in (2, 3, 4):
        inj.sever(d)
    detect_all([2, 3, 4])
    for d in (2, 3, 4):
        inj.recover(d)
    rec["parity"].append(_parity(env, client))
    assert all(p["agree"] for p in rec["parity"][-1]), "triple failure"
    g_all = sysm.get(keys)
    assert g_all.all_found
    np.testing.assert_array_equal(host(g_all.values)[:, 0], vals)
    assert inj.oracle_kills == 0
    # truly lost: the fallback's blocker is typed and actionable
    for d in (2, 3, 4):
        inj.sever(d)
    detect_all([2, 3, 4])
    sysm.fail_data_server(6)
    try:
        backend.recover_server(2)
    except kv.RecoveryError as e:
        rec["recovery_error"] = [e.group, list(e.searched),
                                 list(e.blockers), str(e)]
        assert e.blockers == ["data server 6"], e.blockers
    else:
        raise AssertionError("truly lost recovery must raise")
    sysm.recover_data_server(6)
    for d in (2, 3, 4):
        inj.recover(d)
    rec["parity"].append(_parity(env, client))
    assert all(p["agree"] for p in rec["parity"][-1])
    rec["log"] = log
    return _finish(rec, client, env)


# ---------------------------------------------------------------------------
# c. rounds-clock detection
# ---------------------------------------------------------------------------
def detection_bound(env):
    """``run_detection_bound``: exactly lease_misses observation rounds
    after a sever, the client demotes the server; then degraded GETs
    serve its keys and a recovery restores parity."""
    cfg = env.cfg
    log, rec = [], {}
    client = env.make_client(batch_quantum=4 * G, max_retries=32)
    sysm = Rec(client, log)
    backend = client.backend
    keys = np.random.RandomState(1).choice(10 ** 6, 8 * G,
                                           replace=False) + 1
    assert sysm.put(keys, np.arange(8 * G)).all_ok
    dead = 3
    probe = _owned_by(env, keys, dead, invert=True)[:G]
    inj = FaultInjector(sysm)
    inj.sever(dead)
    for i in range(cfg.lease_misses):
        assert dead not in backend._dead, f"demoted after {i} rounds"
        sysm.get(probe)
    assert backend.detected == [dead]
    assert inj.oracle_kills == 0
    dk = _owned_by(env, keys, dead)
    if len(dk):
        assert sysm.get(dk).all_found
    inj.recover(dead)
    assert dead not in backend._dead and not backend._severed
    assert all(p["agree"] for p in env.kv.parity_report(backend.store, cfg))
    rec["log"] = log
    return _finish(rec, client, env)


def detector_trace(env, mix_name="uniform", seed=21, dead_dev=5,
                   n_events=10):
    """``run_detector_trace``: a seeded trace whose kill arrives only by
    severed heartbeats (``FaultInjector``), equal to the Oracle across
    the undetected, degraded and recovered phases; the detector, not an
    oracle call, demotes the server."""
    cfg = env.cfg
    log, rec = [], {"phases": []}
    ops = gen_ops(seed, mix_name, n_events=n_events, batch=3 * G)
    trace = splice_faults(ops, [(n_events // 3, "sever", dead_dev),
                                (2 * n_events // 3, "recover", dead_dev)])
    client = env.make_client(batch_quantum=4 * G, max_retries=32)
    sysm = Rec(client, log)
    inj = FaultInjector(sysm)

    class Injected:
        """Fault events through the injector; everything else as is."""

        def __getattr__(self, name):
            if name == "sever_server":
                return inj.sever
            if name == "recover_server":
                return inj.recover
            return getattr(sysm, name)

    def hook(c, event):
        c.drain()
        report = _parity(env, c)
        for p in report:
            if p.get("kind") == "value_slots":
                assert p["agree"], f"value audit broke after {event}: {p}"
            elif p["primary_alive"] and p["holder_alive"]:
                assert p["agree"], f"live parity broke after {event}: {p}"
        rec["phases"].append([plain(event), report])

    oracle = Oracle(value_words=cfg.value_words)
    rec["obs"] = replay(Injected(), trace, phase_hook=hook)
    assert_equivalent(rec["obs"], replay(oracle, trace),
                      label=f"lease/{mix_name}/seed{seed}")
    assert client.backend.detected == [dead_dev]
    assert inj.oracle_kills == 0
    rec["oracle_kills"] = inj.oracle_kills
    live = np.fromiter(oracle.model.keys(), np.int64)
    if len(live):
        g_all = sysm.get(live)
        assert g_all.all_found and bool((host(g_all.hops) == 1).all())
    rec["log"] = log
    return _finish(rec, client, env)


def data_server_detection(env):
    """``run_data_server_detection``: a data server killed only by cut
    heartbeats; its keys are mirror-served (hops 2) before detection,
    the data lease expires within the bound, displaced PUTs land, and a
    recovery from the detected state (+ migration) restores one-RTT
    reads, with no oracle kill and no index demotion."""
    cfg = env.cfg
    log, rec = [], {}
    client = env.make_client(batch_quantum=4 * G, max_retries=32)
    sysm = Rec(client, log)
    backend = client.backend
    rng = np.random.RandomState(13)
    keys = rng.choice(10 ** 6, 16 * G, replace=False) + 1
    vals = np.arange(16 * G)
    assert sysm.put(keys, vals).all_ok
    sysm.drain()
    dead = 4
    inj = FaultInjector(sysm)
    inj.sever_data(dead)
    assert dead not in backend._data_dead
    dk = _owned_by(env, keys, dead)
    assert len(dk)
    r = sysm.get(dk)
    assert r.all_found and bool((host(r.hops) == 2).all())
    probe = _owned_by(env, keys, dead, invert=True)[:G]
    rounds = 0
    while dead not in backend._data_dead:
        sysm.get(probe)
        rounds += 1
        assert rounds <= 2 * cfg.lease_misses
    rec["rounds"] = rounds
    assert backend.detected_data == [dead]
    assert backend.detected == [] and not backend._dead
    nk = rng.choice(10 ** 6, 8 * G, replace=False) + 3 * 10 ** 6
    nv = np.arange(8 * G) + 100
    assert sysm.put(nk, nv).all_ok, "displaced PUTs must land"
    assert sysm.get(nk).all_found
    inj.recover_data(dead)
    assert dead not in backend._data_dead and not backend._data_severed
    model = dict(zip(keys.tolist(), vals.tolist()))
    model.update(zip(nk.tolist(), nv.tolist()))
    allk = np.fromiter(model.keys(), np.int64)
    g_all = sysm.get(allk)
    assert g_all.all_found
    np.testing.assert_array_equal(host(g_all.values)[:, 0],
                                  [model[k] for k in allk.tolist()])
    assert bool((host(g_all.hops) == 1).all())
    assert inj.oracle_kills == 0
    sysm.drain()
    assert all(p["agree"] for p in env.kv.parity_report(backend.store, cfg))
    rec["log"] = log
    return _finish(rec, client, env)


def scan_completeness(env):
    """``run_scan_completeness``: with both holders of group 1 severed a
    SCAN names the group (complete False) after retries that drive the
    detector; recovery restores the whole range."""
    cfg = env.cfg
    log, rec = [], {}
    client = env.make_client(batch_quantum=4 * G, max_retries=32)
    sysm = Rec(client, log)
    backend = client.backend
    rng = np.random.RandomState(19)
    keys = rng.choice(10 ** 6, 16 * G, replace=False) + 1
    assert sysm.put(keys, np.arange(16 * G)).all_ok
    sysm.drain()
    s0 = sysm.scan(0, 10 ** 7, CAP)
    assert s0.complete is True and s0.missing_groups == ()
    n0 = int(s0.count)
    inj = FaultInjector(sysm)
    inj.sever(2)
    inj.sever(3)
    retries0 = client.stats["retries"]
    s1 = sysm.scan(0, 10 ** 7, CAP)
    rec["scan_retries"] = client.stats["retries"] - retries0
    assert s1.complete is False and s1.missing_groups == (1,)
    assert int(s1.count) < n0
    assert {2, 3} <= set(backend.detected)
    inj.recover(2)
    inj.recover(3)
    s2 = sysm.scan(0, 10 ** 7, CAP)
    assert s2.complete is True and int(s2.count) == n0
    assert inj.oracle_kills == 0
    assert all(p["agree"] for p in env.kv.parity_report(backend.store, cfg))
    rec["log"] = log
    return _finish(rec, client, env)


# ---------------------------------------------------------------------------
# d. lease_selftest.run_online_catch_up
# ---------------------------------------------------------------------------
def online_catch_up(env):
    """``run_online_catch_up``: recovery returns with catch-up debt still
    streaming; foreground GETs and PUTs run during the catch-up and are
    right; the debt then drains and parity holds."""
    cfg = env.cfg
    log, rec = [], {}
    client = env.make_client(batch_quantum=4 * G, max_retries=32,
                             migrate_on_recover=False)
    sysm = Rec(client, log)
    backend = client.backend
    model = {}
    rng = np.random.RandomState(7)
    keys = rng.choice(10 ** 6, 16 * G, replace=False) + 1
    assert sysm.put(keys, np.arange(16 * G)).all_ok
    model.update(zip(keys.tolist(), range(16 * G)))
    sysm.drain()
    dead = 2
    inj = FaultInjector(sysm)
    inj.sever(dead)
    other = _owned_by(env, keys, dead, invert=True)
    w = 0
    while dead not in backend._dead:
        batch = other[w % len(other):][:2 * G]
        assert sysm.put(batch, np.arange(len(batch)) + 50_000).all_ok
        model.update(zip(batch.tolist(),
                         (np.arange(len(batch)) + 50_000).tolist()))
        w += 2 * G
        assert w < 100 * G, "detector must fire"
    r = backend.recover_server(dead)
    rec["recover"] = plain(r)
    assert r.online and r.catch_up_pending > 0, r
    mid = sysm.get(keys[: 8 * G])
    assert mid.all_found
    np.testing.assert_array_equal(host(mid.values)[:, 0],
                                  [model[k] for k in keys[: 8 * G].tolist()])
    fresh = rng.choice(10 ** 6, 4 * G, replace=False) + 2 * 10 ** 6
    assert sysm.put(fresh, np.arange(4 * G)).all_ok
    model.update(zip(fresh.tolist(), range(4 * G)))
    rec["pending_mid"] = int(backend.pending_ops())
    assert rec["pending_mid"] > 0
    sysm.drain()
    assert all(p["agree"] for p in env.kv.parity_report(backend.store, cfg))
    allk = np.fromiter(model.keys(), np.int64)
    g_all = sysm.get(allk)
    assert g_all.all_found
    np.testing.assert_array_equal(host(g_all.values)[:, 0],
                                  [model[k] for k in allk.tolist()])
    assert inj.oracle_kills == 0
    rec["log"] = log
    return _finish(rec, client, env)


# ---------------------------------------------------------------------------
# carrying a store across mid-outage
# ---------------------------------------------------------------------------
CARRY_KEYS = np.random.RandomState(31).choice(10 ** 6, 16 * G,
                                              replace=False) + 1


def carry_before(env):
    """Index server 2 failed (oracle), index server 5 severed and one
    observation round into its lease: the state a carry takes across."""
    log = []
    client = env.make_client(batch_quantum=4 * G, max_retries=32)
    sysm = Rec(client, log)
    assert sysm.put(CARRY_KEYS, np.arange(16 * G)).all_ok
    sysm.fail_server(2)
    assert sysm.put(CARRY_KEYS[:4 * G], np.arange(4 * G) + 500).all_ok
    sysm.sever_server(5)
    sysm.get(_owned_by(env, CARRY_KEYS, 5, invert=True)[:G])
    return log, client


def carry_after(env, client):
    """What follows on the carried store: traffic until 5 is detected,
    both servers recovered, a read-back and the parity audit."""
    log, rec = [], {}
    sysm = Rec(client, log)
    backend = client.backend
    stats0 = dict(client.stats)
    probe = _owned_by(env, CARRY_KEYS, 5, invert=True)[:G]
    while 5 not in backend._dead:
        sysm.get(probe)
        assert len(log) < 8, "the detector must fire"
    sysm.put(CARRY_KEYS[4 * G:6 * G], np.arange(2 * G) + 900)
    sysm.recover_server(2)
    sysm.recover_server(5)
    g = sysm.get(CARRY_KEYS)
    assert g.all_found
    rec["log"] = log
    rec["stats"] = {k: v - stats0[k] for k, v in client.stats.items()}
    rec["parity_end"] = _parity(env, client)
    assert all(p["agree"] for p in rec["parity_end"])
    rec["detected"] = list(backend.detected)
    return json.loads(json.dumps(rec))


SCHEDULES = {
    "mix_uniform": lambda env: mix(env, "uniform", 11, 2),
    "mix_delete_heavy": lambda env: mix(env, "delete_heavy", 44, 3),
    "multi_failure": multi_failure,
    "detection_bound": detection_bound,
    "detector_trace": detector_trace,
    "data_server_detection": data_server_detection,
    "scan_completeness": scan_completeness,
    "online_catch_up": online_catch_up,
}
