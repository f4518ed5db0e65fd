"""Failure and recovery of the port's single-node store (paper §4.3),
held against the JAX package: degraded GET/DELETE through the backup
probe, ``fail`` with its wipe, online and stop-the-world
``recover_primary`` / ``recover_backup``, ``hash_index.replay_pending``,
and the client's fault schedule against the JAX client and the Oracle.
Index state must agree bit for bit."""
from __future__ import annotations

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import Oracle, assert_equivalent, gen_ops, replay, splice_faults
from repro.configs.histore import scaled as jscaled
from repro.core import hash_index as jhi
from repro.core import index_group as jig
from repro.core import log as jlg
from repro.core.client import HiStoreClient as JClient
from repro.core.client import LocalBackend as JLocal
from repro_torch.configs.histore import scaled
from repro_torch.convert import backend_from_numpy
from repro_torch.core import hash_index as hi
from repro_torch.core import index_group as ig
from repro_torch.core import log as lg
from repro_torch.core import sorted_index as si
from repro_torch.core.client import HiStoreClient, LocalBackend

I32 = torch.int32
GROUP_KW = dict(use_kernels="off", log_capacity=256, async_apply_batch=64)
CFG = scaled(**GROUP_KW)
JCFG = jscaled(**GROUP_KW)
TRACE_KW = dict(use_kernels="off", log_capacity=1 << 10,
                async_apply_batch=256)
N_EVENTS = 16


def _k(ks):
    return torch.as_tensor(np.asarray(ks, np.int32))


def _put(g, ks, as_, **kw):
    return ig.put(g, _k(ks), _k(as_), CFG, **kw)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _group_eq(tg, jg, label=""):
    """Every array of the port's group equals the JAX group's."""
    pairs = [(tg.hash, jg.hash, None), (tg.plog, jg.plog, None)]
    for r in range(len(tg.sorted)):
        pairs += [(tg.sorted[r], jg.sorted, r), (tg.blogs[r], jg.blogs, r)]
    for t, j, r in pairs:
        for f, x, y in zip(t._fields, t, j):
            y = np.asarray(y) if r is None else np.asarray(y)[r]
            np.testing.assert_array_equal(_np(x), y,
                                          err_msg=f"{label}: {f} {r}")
    np.testing.assert_array_equal(_np(tg.alive), np.asarray(jg.alive),
                                  err_msg=f"{label}: alive")


def _out_eq(got, want, label):
    for i, (x, y) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(_np(x), np.asarray(y),
                                      err_msg=f"{label}: output {i}")


# ---------------------------------------------------------------------------
# the index group (ports of tests/test_index_group.py)
# ---------------------------------------------------------------------------
def test_degraded_get_after_primary_failure():
    """Primary down -> GET served from sorted replica + pending log."""
    g = ig.create(2048, CFG, "cpu")
    g, _ = _put(g, [7, 8, 9], [70, 80, 90])
    g = ig.apply_async(g, CFG)                 # applied to replicas
    g, _ = _put(g, [9, 11], [91, 110])         # still pending in logs
    g = ig.fail(g, 0)
    addr, found, acc = ig.get(g, _k([7, 9, 11, 12]), CFG)
    np.testing.assert_array_equal(found.numpy(), [True, True, True, False])
    np.testing.assert_array_equal(addr.numpy()[:3], [70, 91, 110])
    levels = si.directory_levels(2048, CFG.fanout)
    assert (acc == levels + 1).all()


def test_degraded_delete_visible_in_log():
    g = ig.create(2048, CFG, "cpu")
    g, _ = _put(g, [5], [50])
    g = ig.apply_async(g, CFG)
    g, _ = ig.delete(g, _k([5]), CFG)          # pending DEL
    g = ig.fail(g, 0)
    _, found, _ = ig.get(g, _k([5]), CFG)
    assert not bool(found[0])


@pytest.mark.parametrize("online", [True, False])
def test_recover_primary_rebuilds_hash(online):
    g = ig.create(2048, CFG, "cpu")
    keys = list(range(100, 300))
    g, _ = _put(g, keys, [k - 100 for k in keys])
    g = ig.fail(g, 0)
    g = ig.recover_primary(g, CFG, online=online)
    assert bool(g.alive[0])
    addr, found, _ = ig.get(g, _k(keys), CFG)
    assert bool(found.all())
    np.testing.assert_array_equal(addr.numpy(), [k - 100 for k in keys])


def test_recover_backup_copies_replica():
    g = ig.create(2048, CFG, "cpu")
    g, _ = _put(g, [1, 2, 3], [10, 20, 30])
    g = ig.fail(g, 2)                          # backup 1 down
    g, _ = _put(g, [4], [40], backups_alive=(True, False))
    g = ig.recover_backup(g, 1, CFG)
    assert bool(g.alive.all())
    g = ig.drain(g, CFG)
    _, found, _ = si.search(g.sorted[1], _k([1, 2, 3, 4]))
    assert bool(found.all())


def test_recovered_replica_shares_nothing_it_writes():
    """recover_backup shares the source's tensors; a later write to one
    replica must leave the other unchanged (no state is written in
    place)."""
    g = ig.create(256, CFG, "cpu")
    g, _ = _put(g, [1, 2, 3], [10, 20, 30])
    g = ig.drain(g, CFG)
    g = ig.fail(g, 1)
    g = ig.recover_backup(g, 0, CFG)
    assert g.sorted[0].keys.data_ptr() == g.sorted[1].keys.data_ptr()
    before = [t.clone() for t in (*g.sorted[1], *g.blogs[1])]
    g, _ = _put(g, [4, 5], [40, 50], backups_alive=(True, False))
    g = ig.apply_async(g, CFG)
    for t, b in zip((*g.sorted[1], *g.blogs[1]), before):
        assert torch.equal(t, b)
    _, found, _ = si.search(g.sorted[0], _k([4, 5]))
    assert bool(found.all())


def test_scan_with_backup_failure():
    g = ig.create(2048, CFG, "cpu")
    g, _ = _put(g, [10, 20, 30], [1, 2, 3])
    g = ig.fail(g, 1)                          # backup 0 down -> backup 1
    (k, _, n), g = ig.scan(g, _k(10), _k(30), 8, CFG)
    assert int(n) == 3
    np.testing.assert_array_equal(k.numpy()[:3], [10, 20, 30])


def test_fail_wipes_primary_state():
    """fail(0) destroys the hash table and primary log, and fail(1 + r)
    replica r and its log, not merely masking them."""
    g = ig.create(2048, CFG, "cpu")
    g, _ = _put(g, [1, 2, 3], [10, 20, 30])
    assert int(hi.n_items(g.hash)) == 3
    g0 = ig.fail(g, 0)
    assert not bool(g0.alive[0])
    assert int(hi.n_items(g0.hash)) == 0
    assert int(lg.pending_count(g0.plog)) == 0
    g2 = ig.fail(ig.drain(g, CFG), 2)
    assert int(g2.sorted[1].size) == 0 and int(g2.sorted[0].size) == 3
    assert int(lg.pending_count(g2.blogs[1])) == 0
    assert int(hi.n_items(g.hash)) == 3, "the input group is untouched"


def test_get_static_liveness_hints_agree():
    """primary_alive True/False/None give the same answers once the
    replicas are drained."""
    g = ig.create(2048, CFG, "cpu")
    g, _ = _put(g, [5, 6, 7], [50, 60, 70])
    g = ig.drain(g, CFG)
    probe = _k([5, 6, 7, 8])
    a_t, f_t, _ = ig.get(g, probe, CFG, primary_alive=True)
    for hint in (None, False):
        a, f, _ = ig.get(g, probe, CFG, primary_alive=hint)
        assert torch.equal(a, a_t) and torch.equal(f, f_t)
    for fn in (ig.get, ig.delete, ig.owner_addr_probe):
        assert inspect.signature(fn).parameters["primary_alive"].default \
            is None, fn.__name__


def test_put_skips_dead_backup_and_recovery_resyncs():
    g = ig.create(2048, CFG, "cpu")
    g, _ = _put(g, [1, 2, 3], [10, 20, 30])
    g = ig.drain(g, CFG)
    g = ig.fail(g, 1)                       # backup 0 down (wiped)
    g, ok = _put(g, [4], [40], backups_alive=(False, True))
    assert bool(ok.all())
    assert int(lg.pending_count(g.blogs[0])) == 0, "dead log untouched"
    assert int(lg.pending_count(g.blogs[1])) == 1
    g = ig.recover_backup(g, 0, CFG)
    assert bool(g.alive.all())
    g = ig.drain(g, CFG)
    _, found, _ = si.search(g.sorted[0], _k([1, 2, 3, 4]))
    assert bool(found.all()), "re-cloned replica must hold every write"


def test_degraded_write_delete_recover_primary_roundtrip():
    g = ig.create(2048, CFG, "cpu")
    g, _ = _put(g, [1, 2], [10, 20])
    g = ig.fail(g, 0)
    g, _ = _put(g, [3], [30])               # write during the outage
    g, found = ig.delete(g, _k([1, 9]), CFG)
    np.testing.assert_array_equal(found.numpy(), [True, False])
    _, found, _ = ig.get(g, _k([1, 2, 3]), CFG, primary_alive=False)
    np.testing.assert_array_equal(found.numpy(), [False, True, True])
    g = ig.recover_primary(g, CFG)
    assert bool(g.alive[0])
    addr, found, _ = ig.get(g, _k([1, 2, 3]), CFG, primary_alive=True)
    np.testing.assert_array_equal(found.numpy(), [False, True, True])
    np.testing.assert_array_equal(addr.numpy()[1:], [20, 30])


def test_delete_with_dead_backups_recovers_consistent():
    g = ig.create(2048, CFG, "cpu")
    g, _ = _put(g, [7, 8], [70, 80])
    g = ig.drain(g, CFG)
    g = ig.fail(g, 2)                       # backup 1 down
    g, found = ig.delete(g, _k([7]), CFG, backups_alive=(True, False))
    assert bool(found[0])
    g = ig.recover_backup(g, 1, CFG)
    g = ig.drain(g, CFG)
    for r in range(CFG.n_backups):
        _, f, _ = si.search(g.sorted[r], _k([7, 8]))
        np.testing.assert_array_equal(f.numpy(), [False, True])


# ---------------------------------------------------------------------------
# against the JAX index group, op by op and state by state
# ---------------------------------------------------------------------------
def _scenario(seed, n_steps=40):
    """A seeded sequence of group ops.  Faults alternate fail and
    recover, the failed server cycling through primary, backup 1, primary,
    backup 0, so one backup always lives."""
    rng = np.random.default_rng(seed)
    pool = rng.choice(10 ** 6, 400, replace=False).astype(np.int32)
    alive = [True] * (1 + CFG.n_backups)
    victims = [0, 2, 0, 1]
    steps = []
    for _ in range(n_steps):
        kind = rng.choice(["put", "put", "delete", "get", "owner", "apply",
                           "fault", "fault"])
        n = 32                        # one shape: JAX compiles each once
        keys = rng.choice(pool, n)
        if kind == "put":
            steps.append(("put", keys, rng.integers(0, 10 ** 5, n),
                          tuple(alive[1:])))
        elif kind in ("delete", "get", "owner"):
            hint = (rng.choice([True, None]) if alive[0]
                    else rng.choice([None, False]))
            steps.append((kind, keys, hint, tuple(alive[1:])))
        elif kind == "apply":
            steps.append(("drain",) if rng.random() < 0.3 else ("apply",))
        else:
            dead = [s for s, a in enumerate(alive) if not a]
            if dead:
                s = int(rng.choice(dead))
                steps.append(("recover", s, bool(rng.integers(0, 2))))
                alive[s] = True
            else:
                s = victims[sum(st[0] == "fail" for st in steps) % 4]
                steps.append(("fail", s))
                alive[s] = False
    return steps


def _run_step(mod, g, cfg, step, to_keys):
    kind = step[0]
    if kind == "put":
        g, ok, nrep = mod.put(g, to_keys(step[1]), to_keys(step[2]), cfg,
                              backups_alive=step[3], with_nrep=True)
        return g, (ok, nrep)
    if kind == "delete":
        g, found = mod.delete(g, to_keys(step[1]), cfg,
                              backups_alive=step[3], primary_alive=step[2])
        return g, (found,)
    if kind == "get":
        return g, mod.get(g, to_keys(step[1]), cfg, primary_alive=step[2])
    if kind == "owner":
        return g, mod.owner_addr_probe(g, to_keys(step[1]), cfg, step[2])
    if kind == "apply":
        return mod.apply_async(g, cfg), ()
    if kind == "drain":
        return mod.drain(g, cfg), ()
    if kind == "fail":
        return mod.fail(g, step[1]), ()
    server, online = step[1], step[2]
    if server == 0:
        return mod.recover_primary(g, cfg, online=online), ()
    return mod.recover_backup(g, server - 1, cfg, online=online), ()


@pytest.mark.parametrize("seed,chunk", [(1, None), (2, 7), (3, None),
                                        (4, 64)])
def test_group_matches_jax_through_faults(seed, chunk, monkeypatch):
    """Random puts, deletes, degraded and healthy probes, applies, fails
    and online/offline recoveries: every output and, after every step,
    every state array equal to the JAX group's.  ``chunk`` shrinks the
    rebuild's chunk so one recovery inserts in many chunks."""
    if chunk is not None:
        monkeypatch.setattr(hi, "REBUILD_CHUNK", chunk)
    tg = ig.create(1024, CFG, "cpu")
    jg = jig.create(1024, JCFG)
    steps = _scenario(seed)
    assert any(s[0] == "recover" and s[1] == 0 for s in steps), \
        "the scenario must rebuild the primary"
    for i, step in enumerate(steps):
        tg, got = _run_step(ig, tg, CFG, step, _k)
        jg, want = _run_step(jig, jg, JCFG, step,
                             lambda a: jnp.asarray(np.asarray(a, np.int32)))
        _out_eq(got, want, f"step {i} {step[0]}")
        _group_eq(tg, jg, f"step {i} {step[0]}")


@pytest.mark.parametrize("online", [True, False])
def test_recover_primary_hash_arrays_match_jax(online, monkeypatch):
    """A primary rebuilt from a replica with a wrapped, non-empty pending
    window (puts, overwrites, deletes): the hash arrays equal the JAX
    package's one-batch rebuild bit for bit, with the rebuild chunked."""
    monkeypatch.setattr(hi, "REBUILD_CHUNK", 32)
    rng = np.random.default_rng(5)
    tg, jg = ig.create(2048, CFG, "cpu"), jig.create(2048, JCFG)
    keys = rng.choice(10 ** 6, 900, replace=False).astype(np.int32)
    for s in range(0, 900, 150):
        ks, vs = keys[s:s + 150], rng.integers(0, 10 ** 5, 150)
        tg, _ = ig.put(tg, _k(ks), _k(vs), CFG)
        jg, _ = jig.put(jg, jnp.asarray(ks), jnp.asarray(vs, np.int32), JCFG)
        tg, jg = ig.drain(tg, CFG), jig.drain(jg, JCFG)
    # 200 pending entries that wrap the 256-entry ring
    ks = np.concatenate([keys[:75], rng.choice(10 ** 6, 75)]).astype(np.int32)
    vs = rng.integers(0, 10 ** 5, 150).astype(np.int32)
    tg, _ = ig.put(tg, _k(ks), _k(vs), CFG)
    jg, _ = jig.put(jg, jnp.asarray(ks), jnp.asarray(vs), JCFG)
    ds = np.concatenate([keys[30:100], ks[100:110], [7]]).astype(np.int32)
    tg, _ = ig.delete(tg, _k(ds), CFG)
    jg, _ = jig.delete(jg, jnp.asarray(ds), JCFG)
    tg, _ = ig.put(tg, _k(ds[:19]), _k(vs[:19]), CFG)
    jg, _ = jig.put(jg, jnp.asarray(ds[:19]), jnp.asarray(vs[:19]), JCFG)
    assert int(tg.blogs[0].tail) > 256 and ig.pending_max(tg) > 150
    tg, jg = ig.fail(tg, 0), jig.fail(jg, 0)
    tg = ig.recover_primary(tg, CFG, online=online)
    jg = jig.recover_primary(jg, JCFG, online=online)
    _group_eq(tg, jg, f"recover_primary online={online}")
    assert int(hi.n_items(tg.hash)) > 800


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_replay_pending_matches_jax(seed):
    """replay_pending over a wrapped window with repeated keys, a PUT
    after a DEL and a DEL after a PUT, onto a table holding some of the
    keys: equal to the JAX package's hash arrays."""
    rng = np.random.default_rng(seed)
    pool = rng.choice(10 ** 6, 300, replace=False).astype(np.int32)
    base = pool[:150]
    th = hi.create(1024, CFG, "cpu")
    jh = jhi.create(1024, JCFG)
    th, _ = hi.insert(th, _k(base), _k(np.arange(150)), CFG)
    jh, _ = jhi.insert(jh, jnp.asarray(base), jnp.arange(150, dtype=np.int32),
                       JCFG)
    lcap = 128
    tl, jl = lg.create(lcap, "cpu"), jlg.create(lcap)
    for n in (70, 50, 90):           # applied prefix moves, window wraps
        ks = rng.choice(pool, n).astype(np.int32)
        vs = rng.integers(0, 10 ** 5, n).astype(np.int32)
        op = rng.choice([1, 1, 2], n).astype(np.int8)
        tl, _ = lg.append(tl, _k(ks), _k(vs), torch.as_tensor(op))
        jl, _ = jlg.append(jl, jnp.asarray(ks), jnp.asarray(vs),
                           jnp.asarray(op))
        tl = tl._replace(applied=tl.tail - min(int(tl.tail), 90))
        jl = jl._replace(applied=jl.tail - min(int(jl.tail), 90))
    assert int(tl.tail) > lcap
    th = hi.replay_pending(th, tl, CFG)
    jh = jhi.replay_pending(jh, jl, JCFG)
    for f, x, y in zip(th._fields, th, jh):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y), err_msg=f)
    # an empty window changes nothing
    empty = tl._replace(applied=tl.tail)
    assert all(torch.equal(a, b) for a, b in
               zip(hi.replay_pending(th, empty, CFG), th))


# ---------------------------------------------------------------------------
# the client: fault schedule, replication report, carried state, repairs
# ---------------------------------------------------------------------------
def _slots_ok(be: LocalBackend) -> bool:
    """Value-slot accounting: every live index address holds an allocated
    slot, none double-referenced or orphaned.  Authority is the hash, or
    a live drained replica while the primary is dead."""
    g = ig.drain(be.group, be.cfg)
    if be._primary_alive:
        addrs = g.hash.addr[hi.valid_mask(g.hash)]
    else:
        rep = be._backups_alive.index(True)
        _, a, valid = si.items(g.sorted[rep])
        addrs = a[valid]
    addrs = addrs.numpy()
    used = be.used.numpy()
    return (int(used.sum()) == len(addrs)
            and len(np.unique(addrs)) == len(addrs)
            and bool(used[addrs].all() if len(addrs) else True))


def _parity_ok(be: LocalBackend) -> bool:
    """After a drain every sorted replica holds exactly the hash's live
    items with equal addrs, and the slot bitmap one slot per item."""
    g = ig.drain(be.group, be.cfg)
    n_hash = int(hi.n_items(g.hash))
    for srt in g.sorted:
        keys, addrs, valid = si.items(srt)
        if int(valid.sum()) != n_hash:
            return False
        a_h, f_h, _ = hi.lookup(g.hash, keys, be.cfg)
        if not bool((f_h | ~valid).all()):
            return False
        if not bool(((a_h == addrs) | ~valid).all()):
            return False
    return _slots_ok(be)


def _slot_hook(client, _event):
    assert _slots_ok(client.backend), \
        "value-slot accounting must hold across every phase"


def _schedule():
    return [(N_EVENTS // 4, "fail", 0), (N_EVENTS // 2, "recover", 0),
            (5 * N_EVENTS // 8, "fail", 1), (7 * N_EVENTS // 8, "recover", 1)]


def _clients(**kw):
    tc = HiStoreClient(LocalBackend(4096, scaled(**{**TRACE_KW, **kw}),
                                    device="cpu"), batch_quantum=16)
    jc = JClient(JLocal(4096, jscaled(**{**TRACE_KW, **kw})),
                 batch_quantum=16)
    return tc, jc


@pytest.mark.parametrize("mix,seed", [("uniform", 1), ("zipfian", 2),
                                      ("scan_heavy", 3),
                                      ("delete_heavy", 4)])
def test_fault_schedule_three_ways(mix, seed):
    """The kill/recover schedule of tests/test_fault_injection.py: the
    primary dies (wiped) and is rebuilt online, then a backup dies and
    is re-cloned.  Port client, JAX client and Oracle observe the same
    answers; the slot audit holds at every phase boundary; the final
    state equals the JAX client's and has hash/replica parity."""
    trace = splice_faults(gen_ops(seed, mix, n_events=N_EVENTS, batch=16),
                          _schedule())
    tc, jc = _clients()
    obs_t = replay(tc, trace, phase_hook=_slot_hook)
    assert_equivalent(obs_t, replay(jc, trace), label=f"torch-vs-jax/{mix}")
    assert_equivalent(obs_t, replay(Oracle(value_words=CFG.value_words),
                                    trace), label=f"torch-vs-oracle/{mix}")
    _group_eq(tc.backend.group, jc.backend.group, f"final/{mix}")
    np.testing.assert_array_equal(tc.backend.used.numpy(),
                                  np.asarray(jc.backend.used))
    np.testing.assert_array_equal(tc.backend.vals.numpy(),
                                  np.asarray(jc.backend.vals))
    assert _parity_ok(tc.backend), "recovery must restore parity"


@pytest.mark.parametrize("server", [0, 1, 2])
def test_offline_recovery_matches_jax(server):
    """recover_server(online=False) in the middle of a trace: same
    answers and the same state as the JAX client."""
    ops_ = gen_ops(9 + server, "uniform", n_events=N_EVENTS, batch=16)
    tc, jc = _clients(log_capacity=64, async_apply_batch=16)
    half = N_EVENTS // 2
    for c in (tc, jc):
        replay(c, ops_[:half // 2])
        c.fail_server(server)
    assert_equivalent(replay(tc, ops_[half // 2:half]),
                      replay(jc, ops_[half // 2:half]), label="degraded")
    tc.recover_server(server, online=False)
    jc.recover_server(server, online=False)
    _group_eq(tc.backend.group, jc.backend.group, "after recovery")
    assert_equivalent(replay(tc, ops_[half:]), replay(jc, ops_[half:]),
                      label="recovered")
    assert _parity_ok(tc.backend)


def test_replication_reported_honestly():
    """PUT/DELETE report n_backups replicas healthy, fewer while a
    backup is dead, and all of them again after recovery."""
    be = LocalBackend(2048, scaled(telemetry="trace", **TRACE_KW),
                      device="cpu")
    client = HiStoreClient(be, batch_quantum=16)
    nb = be.cfg.n_backups
    keys = np.arange(1, 17)
    assert bool((client.put(keys, keys).replicas == nb).all())
    client.fail_server(1)                     # backup 0 down
    assert bool((client.put(keys + 100, keys).replicas == nb - 1).all())
    assert bool((client.delete(keys[:4]).replicas == nb - 1).all())
    client.recover_server(1)
    assert bool((client.put(keys + 200, keys).replicas == nb).all())
    assert _parity_ok(be)
    c = client.metrics().counters
    assert c["index_demotions"] == 1 and c["index_recoveries"] == 1
    events = [(s["event"], s["server"]) for s in be.telemetry.trace_spans()
              if "event" in s]
    assert events == [("demote", 1), ("recover", 1)]


def test_carry_state_across_mid_failure():
    """Convert a JAX backend whose primary and a backup are dead; the
    port continues the trace (degraded, then both recoveries) exactly as
    the JAX client does."""
    trace = gen_ops(31, "delete_heavy", n_events=20, batch=16)
    _, jc = _clients()
    replay(jc, trace[:8])
    jc.fail_server(0)
    jc.fail_server(2)
    replay(jc, trace[8:10])
    jb = jc.backend
    be = backend_from_numpy(jax.tree.map(np.asarray, jb.group),
                            np.asarray(jb.vals), np.asarray(jb.used),
                            scaled(**TRACE_KW), "cpu",
                            pending_bound=jb._pending_bound)
    assert be._primary_alive is False and be._backups_alive == [True, False]
    assert be.telemetry_gauges() == jb.telemetry_gauges()
    tc = HiStoreClient(be, batch_quantum=16)
    rest = splice_faults(trace[10:], [(3, "recover", 0), (6, "recover", 2)])
    assert_equivalent(replay(tc, rest), replay(jc, rest),
                      label="carried mid-failure")
    _group_eq(tc.backend.group, jc.backend.group, "carried")


def test_repairs_agree_with_jax():
    """migrate() returns 0 on one shard and counts into stats; the stats
    keys equal the JAX client's; migrate_on_recover runs it; the gauges
    count the primary's liveness."""
    tc, jc = _clients()
    assert set(tc.stats) == set(jc.stats)
    assert tc.migrate() == jc.migrate() == 0
    assert tc.stats["migrated"] == 0
    for c in (tc, jc):
        c.put(np.arange(1, 50), np.arange(1, 50))
    for server in (0, 1):
        tc.fail_server(server)
        jc.fail_server(server)
        assert tc.metrics().gauges == jc.metrics().gauges
    assert tc.metrics().gauges["live_index_servers"] == 1
    calls = []
    tc.backend.migrate_values = lambda: calls.append(1) or 0
    tc.recover_server(0)
    jc.recover_server(0)
    assert calls == [1]
    tc.migrate_on_recover = False
    tc.recover_server(1, online=False)
    jc.recover_server(1, online=False)
    assert calls == [1]
    assert tc.metrics().gauges == jc.metrics().gauges
    assert tc.stats == jc.stats
