"""The port's distributed store on int64 keys, held bit for bit against
the JAX package's DistributedBackend under ``jax_enable_x64`` (its x64
deployment) at G = 8.

x64 is a process-wide switch and the JAX store needs one device a group,
so JAX's side runs in ONE subprocess under ``JAX_ENABLE_X64=1
JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8`` on
an ``AxisType.Auto`` mesh (``tests/_dist_keys64_jax.py``), started by a
module-scoped fixture; its answers and stores come back in an ``.npz``.
``HiStoreClient(DistributedBackend(8, ..., key_dtype=torch.int64))``
replays the same events and every case holds it to JAX's, each field and
dtype (int64 keys; addresses, counters and accesses int32):

  * two ``gen_ops`` traces over [1, 2**62] with the edge keys put at
    their middle: every answer, the stats, gauges, every store leaf and
    ``parity_report``, and the Oracle's answers;
  * index server 3 failed, a degraded round, its recovery; data server 5
    failed and recovered; a drain and ``parity_report``;
  * a JAX store carried across halfway (``distributed_backend_from_numpy``)
    goes on as JAX's, a GET of the edge keys past 2**32 included;
  * ``ops.group_probe`` / ``group_probe_stacked`` / ``range_query_stacked``
    / ``hash_probe`` on the carried store against JAX's ``group_probe``
    (its jnp path), ``range_query`` and ``hash_probe`` (Pallas in
    interpret mode).

Over 2 gloo ranks the same store answers as one process, and the
self-test's battery runs at int64.  The cases marked ``requires_cuda``
hold the int64 group probe, the stacked int64 SCAN and the legacy int64
probe against their plain versions on the card, and the store on the card
against the CPU; they skip here.  This module imports no JAX
(``tests/oracle.py`` does, so the JAX-held cases import it where they
run):

    PYTHONPATH=src:tests python -m pytest -q -m requires_cuda \\
        tests/test_torch_dist_keys64.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import _dist_keys64_jax as D
import _keys64_jax as K
from _dist_battery import leaves
from repro_torch import convert
from repro_torch.configs.histore import scaled
from repro_torch.core import dist_selftest
from repro_torch.core import hash_index as hi
from repro_torch.core import kvstore as kv
from repro_torch.core import tree
from repro_torch.core.client import DistributedBackend, HiStoreClient
from repro_torch.core.comm import Comm
from repro_torch.kernels import ops
from repro_torch.launch import ranks

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
I32, I64 = torch.int32, torch.int64


@pytest.fixture(scope="module")
def jx(tmp_path_factory):
    """JAX's answers under x64: (arrays by name, the JSON records)."""
    out = tmp_path_factory.mktemp("dist_keys64") / "jax.npz"
    env = {**os.environ, "JAX_ENABLE_X64": "1", "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "PYTHONPATH": os.pathsep.join(
               [str(ROOT / "src"), str(HERE),
                os.environ.get("PYTHONPATH", "")])}
    r = subprocess.run([sys.executable, str(HERE / "_dist_keys64_jax.py"),
                        str(out)], env=env, cwd=ROOT, capture_output=True,
                       text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-6000:]
    with np.load(out) as z:
        a = {k: z[k] for k in z.files}
    return types.SimpleNamespace(a=a, js=json.loads(str(a.pop("json"))))


def _cfg(case=0):
    return scaled(**D.cfg_kw(case))


def _client(case=0, device="cpu", comm=None):
    return HiStoreClient(
        DistributedBackend(D.G, _cfg(case), D.DCAP,
                           capacity_q=D.CASES[case][2], scan_limit=128,
                           device=device, comm=comm, key_dtype=I64),
        batch_quantum=D.QUANTUM, max_retries=32)


def _json(x):
    return json.loads(json.dumps(x))


def _leaves_eq(store, a, prefix):
    """Every leaf of the port's store equals JAX's, dtype included."""
    got = {}
    leaves(store, prefix, got)
    want = sorted(k for k in a if k.startswith(f"{prefix}/leaf/"))
    assert sorted(got) == want
    for k, x in got.items():
        assert x.dtype == a[k].dtype, (k, x.dtype, a[k].dtype)
        np.testing.assert_array_equal(x, a[k], err_msg=k)


def _ns(a, prefix):
    """The numpy leaves under ``prefix`` as the tree ``convert``'s
    ``*_from_numpy`` read (``tests/oracle.py`` loads JAX, so imported
    here)."""
    from _dist_fault_schedules import leaf_tree
    return leaf_tree(a, prefix)


def _same(got, want, what):
    """Equal values and an equal dtype."""
    g = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert g.dtype == want.dtype, (what, g.dtype, want.dtype)
    np.testing.assert_array_equal(g, want, err_msg=what)


def _oracle_obs(events):
    from oracle import Oracle, replay
    return _json(replay(Oracle(value_words=4), events))


def _end_eq(c, jx, tag, case=0):
    """Stats, gauges, every store leaf and parity_report equal JAX's."""
    assert c.stats == jx.js[f"{tag}/stats"]
    assert _json(c.metrics().gauges) == jx.js[f"{tag}/gauges"]
    _leaves_eq(c.backend.store, jx.a, tag)
    report = kv.parity_report(c.backend.store, _cfg(case))
    assert _json(report) == jx.js[f"{tag}/parity"]
    assert all(e["agree"] for e in report)


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------
def test_create_matches_jax_x64(jx):
    """An empty int64 store: every leaf JAX's create gives under x64 (the
    logs', replicas', slots' and free queues' keys int64)."""
    st = kv.create(D.G, D.DCAP, _cfg(), "cpu", key_dtype=I64)
    _leaves_eq(st, jx.a, "create")
    assert st.data.freeq.keys.dtype == I64 == st.data.kmirror.dtype


@pytest.mark.parametrize("case", range(len(D.CASES)),
                         ids=[c[0] for c in D.CASES])
def test_trace_matches_jax_x64(jx, case):
    """A gen_ops trace over [1, 2**62] with the edge keys put at its
    middle: every answer (ok, addresses, values, replicas, retries, hops,
    SCAN keys) JAX's and the Oracle's, then a GET of the edge and pad
    keys and a SCAN of the whole key space, the stats, gauges, leaves
    and parity_report."""
    c = _client(case)
    assert c.backend.key_dtype == I64
    assert c.backend.store.bsorted.keys.dtype == I64
    events = D.trace(case)
    ans = _json(D.drive(c, events))
    assert ans == jx.js[f"{case}/answers"]
    assert _json(D.observations(events, ans)) == _oracle_obs(events)
    assert _json(D.answer("get", c.get(D.edge_get_keys()))) == \
        jx.js[f"{case}/edge_get"]
    s = c.scan(0, K.INT64_MAX - 1, 32)
    assert s.keys.dtype == I64 and s.addrs.dtype == I32
    assert _json(D.answer("scan", s)) == jx.js[f"{case}/scan_all"]
    _end_eq(c, jx, str(case), case)


def test_failures_match_jax_x64(jx):
    """On case 0's store: index server 3 fails (its state wiped), a
    degraded PUT / DELETE / GET / SCAN round, its recovery; data server 5
    fails, a PUT and a GET, its recovery; a GET of every key written.
    Every answer, the store at each failure and recovery, and after a
    drain the stats, gauges, leaves and parity_report equal JAX's; the
    answers equal the Oracle's."""
    c = _client(0)
    events = D.trace(0)
    ans0 = _json(D.drive(c, events))
    c.get(D.edge_get_keys())
    c.scan(0, K.INT64_MAX - 1, 32)
    phases = []

    def hook(cl, ev):
        _leaves_eq(cl.backend.store, jx.a, f"faults/{len(phases)}")
        phases.append(ev)

    faults = D.fault_events()
    ans = _json(D.drive(c, faults, hook))
    assert len(phases) == 4
    assert ans == jx.js["faults/answers"]
    got = D.observations(events + faults, ans0 + ans)
    assert _json(got) == _oracle_obs(events + faults)
    c.drain()
    _end_eq(c, jx, "faults")


def test_carry_continues_like_jax_x64(jx):
    """JAX's x64 store taken halfway through case 0 (after the PUT of the
    edge keys, its logs holding a pending window), carried across: the
    backend takes int64 keys from the carried leaves and the rest of the
    trace, the GET of the edge keys past 2**32 and the final store equal
    JAX's."""
    be = convert.distributed_backend_from_numpy(
        _ns(jx.a, "carry"), _cfg(), "cpu", capacity_q=D.CASES[0][2],
        scan_limit=128, pending_bound=jx.js["carry/pending_bound"])
    assert be.key_dtype == I64
    _leaves_eq(be.store, jx.a, "carry")
    assert int((be.store.blog.tail - be.store.blog.applied).max()) > 0
    c = HiStoreClient(be, batch_quantum=D.QUANTUM, max_retries=32)
    ans = _json(D.drive(c, D.trace(0)[D.CARRY_AT:]))
    assert ans == jx.js["0/answers"][D.CARRY_AT:]
    g = c.get(D.edge_get_keys())
    assert bool(g.found[:len(K.EDGE_KEYS)].all())
    assert _json(D.answer("get", g)) == jx.js["0/edge_get"]
    assert _json(D.answer("scan", c.scan(0, K.INT64_MAX - 1, 32))) == \
        jx.js["0/scan_all"]
    _leaves_eq(c.backend.store, jx.a, "0")


# ---------------------------------------------------------------------------
# the ops on an int64 store
# ---------------------------------------------------------------------------
def _carried(jx, device="cpu"):
    """(store, queries) of the ops: JAX's store at the carry, on
    ``device``, and the queries its subprocess probed."""
    st = convert.store_from_numpy(_ns(jx.a, "carry"), _cfg(), device)
    tr = D.trace(0)[:D.CARRY_AT]
    written = np.unique(np.concatenate([e[1] for e in tr if e[0] == "put"]))
    return st, torch.as_tensor(D.probe_queries(written), device=device)


def _check_op(op, st, q, a, device="cpu"):
    """``op`` on the store against JAX's answers in ``a``."""
    cfg = _cfg()
    R = st.blog.tail.shape[0]
    og = a["ops/og"]
    if op == "group_probe":
        for g in range(D.G):
            sel = torch.as_tensor(D.replica_select(og, g, R), device=device)
            out = ops.group_probe(cfg, tree.at(st.hash, g),
                                  tuple(tree.at(st.bsorted, r, g)
                                        for r in range(R)),
                                  tuple(tree.at(st.blog, r, g)
                                        for r in range(R)), q, sel)
            for i, x in enumerate(out):
                _same(x, a[f"ops/gp/{g}/{i}"], f"group_probe {g} output {i}")
    elif op == "group_probe_stacked":
        out = ops.group_probe_stacked(cfg, st.hash, st.bsorted, st.blog,
                                      q[None].expand(D.G, -1))
        for g in range(D.G):
            for i, x in enumerate(out[:6]):
                _same(x[g], a[f"ops/gp/{g}/{i}"],
                      f"group_probe_stacked {g} output {i}")
        _same(out[6][0], og, "owner group")
    elif op == "range_query_stacked":
        for b, (lo, hi_) in enumerate(D.BOUND_SETS):
            lo_g = torch.arange(D.G, dtype=I64, device=device) + lo
            hi_g = torch.full((D.G,), hi_, dtype=I64, device=device)
            out = ops.range_query_stacked(cfg, st.bsorted, lo_g, hi_g,
                                          D.LIMIT)
            for g in range(D.G):
                for r in range(R):
                    for i, x in enumerate(out):
                        _same(x[g, r], a[f"ops/rq/{b}/{g}/{r}/{i}"],
                              f"range set {b} group {g} replica {r} out {i}")
    else:
        h6 = hi.HashIndex(*[torch.as_tensor(a[f"probe6/leaf/{f}"],
                                            device=device)
                            for f in hi.HashIndex._fields])
        k6 = torch.tensor(D.PROBE6, dtype=I64, device=device)
        out = ops.hash_probe(h6, torch.cat([k6, q]), cfg)
        for i, x in enumerate(out):
            _same(x, a[f"probe6/{i}"], f"hash_probe output {i}")


OPS = ("group_probe", "group_probe_stacked", "range_query_stacked",
       "hash_probe")


@pytest.mark.parametrize("op", OPS)
def test_ops_on_an_int64_store_match_jax_x64(jx, op):
    """The group probes (JAX's group_probe, the jnp path it takes at
    int64, with each server's replica selects), the stacked SCAN (JAX's
    range_query of every replica at bounds past 2**32 and below 0) and
    the legacy probe (JAX's kernel in interpret mode) on the carried
    store, whose logs hold a pending window, over its keys, the edge
    and pad keys and absent ones: equal answers and dtypes."""
    st, q = _carried(jx)
    _check_op(op, st, q, jx.a)


def test_hash_probe_finds_int64_keys(jx):
    """The legacy probe hashes int64 keys at their width, as JAX's
    bucket_of / sig_fp_of do: the six keys of PROBE6 (past 2**32 and
    negative among them), put in a JAX x64 HashIndex, are all found,
    where a cast to int32 found only the first two."""
    h6 = hi.HashIndex(*[torch.as_tensor(jx.a[f"probe6/leaf/{f}"])
                        for f in hi.HashIndex._fields])
    k6 = torch.tensor(D.PROBE6, dtype=I64)
    addr, found, acc = ops.hash_probe(h6, k6, _cfg())
    assert found.tolist() == [True] * 6
    assert addr.tolist() == list(range(6))
    n = len(D.PROBE6)
    for i, x in enumerate((addr, found, acc)):
        _same(x, jx.a[f"probe6/{i}"][:n], f"hash_probe output {i}")


# ---------------------------------------------------------------------------
# over ranks, and the self-test
# ---------------------------------------------------------------------------
def test_over_two_gloo_ranks_equals_one_process():
    """The int64 store over 2 gloo ranks: a short trace, index server 3
    failed with a degraded round, its recovery and a read-back answer as
    the one-process int64 store does, and the gathered store is
    bit-equal to it, dtypes included."""
    import _dist_ranks as RB

    events = D.trace(1)[:8] + D.fault_events(1)[:6] + D.fault_events(1)[-1:]
    out = ranks.spawn(RB.keys64_store, 2, device="cpu", timeout_s=240,
                      args=(events,))
    assert out[0] == out[1]
    assert out[0]["key_dtype"] == "torch.int64"


def test_dist_selftest_battery_at_int64():
    """dist_selftest's battery on a store of int64 keys (``--key-dtype
    int64``), as JAX's runs it under x64: its asserts pass."""
    lines = []
    dist_selftest.run(Comm.single(D.G), torch.device("cpu"),
                      say=lines.append, key_dtype=I64)
    assert lines[-1].startswith("R=3 scan serve-duty ok")


def test_distributed_backend_takes_two_key_widths():
    """int32 (the default) and int64; any other width raises, as
    LocalBackend's does; the client casts keys to the store's width."""
    be = DistributedBackend(2, _cfg(), 64, device="cpu")
    assert be.key_dtype == I32 and be.store.plog.keys.dtype == I32
    with pytest.raises(ValueError, match="int32 or torch.int64"):
        DistributedBackend(2, _cfg(), 64, device="cpu",
                           key_dtype=torch.int16)
    c = HiStoreClient(DistributedBackend(2, _cfg(), 64, device="cpu",
                                         key_dtype=I64), batch_quantum=4)
    big = np.array([2 ** 40 + 1, 2 ** 40 + 2 ** 32 + 1], np.int64)
    assert c.put(big, np.array([1, 2])).all_ok
    g = c.get(big)
    assert g.found.tolist() == [True, True]
    assert g.values[:, 0].tolist() == [1, 2]


# ---------------------------------------------------------------------------
# on the card (JAX-free)
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernels are CUDA "
                    "C++ built with nvcc and have no CPU mode")
    return torch.device("cuda")


def _events(seed, n=12):
    """Writes, reads, deletes and SCANs over [0, 2**62) and the edges,
    from a numpy seed (no JAX)."""
    rng = np.random.default_rng(seed)
    pool = np.array(K.EDGE_KEYS, np.int64)
    ev = [("put", pool, np.arange(len(pool)) + 1)]
    for i in range(n):
        new = rng.integers(0, K.UNIVERSE, 32, dtype=np.int64)
        pool = np.concatenate([pool, new])
        ev.append(("put", new, rng.integers(1, 1 << 20, 32)))
        ev.append(("get", rng.choice(pool, 32)))
        if i % 3 == 2:
            ev.append(("delete", np.unique(rng.choice(pool, 16))))
            ev.append(("scan", int(rng.integers(0, K.UNIVERSE // 2)),
                       K.INT64_MAX - 1, 128))
    return ev


def _store_on(device, seed=5):
    """A case-0 client of int64 keys on ``device`` after ``_events`` and
    a PUT of fresh keys, so that its logs hold a pending window."""
    c = _client(0, device)
    D.drive(c, _events(seed))
    fresh = np.random.default_rng(seed).integers(0, K.UNIVERSE, 64,
                                                 dtype=np.int64)
    assert c.put(fresh, np.arange(64)).all_ok
    return c


@pytest.mark.requires_cuda
def test_cuda_int64_group_probe_matches_plain(cuda_device):
    """histore_group_probe_i64 on the store's stacked [R, G] leaves, by
    owner group and with rep_sel (random selects), against the plain
    version: the hash and backup halves and the owner group."""
    st = _store_on(cuda_device).backend.store
    assert int((st.blog.tail - st.blog.applied).max()) > 0
    cfg = _cfg()
    rng = np.random.default_rng(7)
    keys = tree.at(st.bsorted, 0, 0).keys.cpu().numpy()
    q = np.concatenate([keys[keys < K.INT64_MAX][:500],
                        np.array(K.EDGE_KEYS + K.PAD_KEYS, np.int64),
                        rng.integers(0, K.UNIVERSE, 300, dtype=np.int64)])
    rk = torch.as_tensor(np.stack([rng.permutation(q) for _ in range(D.G)]),
                         device=cuda_device)
    n0 = ops.LAUNCHES["group_probe_i64"]
    got = ops.group_probe_cuda(rk, None, st.hash, st.bsorted, st.blog,
                               cfg.slots_per_bucket, cfg.fanout)
    assert ops.LAUNCHES["group_probe_i64"] == n0 + 1
    h, s, b = (type(x)(*[t.cpu() for t in x])
               for x in (st.hash, st.bsorted, st.blog))
    want = ops.group_probe_stacked_plain(cfg, h, s, b, rk.cpu())
    for i, (x, y) in enumerate(zip(got, want)):
        assert x.dtype == y.dtype and torch.equal(x.cpu(), y), f"output {i}"
    R = s.keys.shape[0]
    sel = torch.as_tensor(rng.integers(0, 2, (D.G, rk.shape[1], R))
                          .astype(np.int32), device=cuda_device)
    got = ops.group_probe_cuda(rk, sel, st.hash, st.bsorted, st.blog,
                               cfg.slots_per_bucket, cfg.fanout)
    for g in range(D.G):
        want = ops.group_probe_plain(
            cfg, tree.at(h, g), tuple(tree.at(s, r, g) for r in range(R)),
            tuple(tree.at(b, r, g) for r in range(R)), rk[g].cpu(),
            sel[g].cpu())
        for i, (x, y) in enumerate(zip(got, want)):
            assert torch.equal(x[g].cpu(), y), f"group {g} output {i}"


@pytest.mark.requires_cuda
def test_cuda_int64_range_stacked_matches_plain(cuda_device):
    """The stacked SCAN at int64 (histore_range_query_i64 over the
    [R, G] leaves) against its plain version at bounds across the int64
    range, counted under sorted_search_i64."""
    c = _store_on(cuda_device)
    c.drain()
    st = c.backend.store
    cfg = _cfg()
    s = type(st.bsorted)(*[t.cpu() for t in st.bsorted])
    for lo, hi_ in D.BOUND_SETS:
        lo_g = torch.arange(D.G, dtype=I64) * 7 + lo
        hi_g = torch.full((D.G,), hi_, dtype=I64)
        n0 = ops.LAUNCHES["sorted_search_i64"]
        got = ops.range_query_stacked_cuda(st.bsorted.keys, st.bsorted.addrs,
                                           lo_g.to(cuda_device),
                                           hi_g.to(cuda_device), D.LIMIT,
                                           cfg.fanout)
        assert ops.LAUNCHES["sorted_search_i64"] == n0 + 1
        want = ops.range_query_stacked_plain(cfg, s, lo_g, hi_g, D.LIMIT)
        for i, (x, y) in enumerate(zip(got, want)):
            assert x.dtype == y.dtype and torch.equal(x.cpu(), y), \
                (lo, hi_, i)


@pytest.mark.requires_cuda
def test_cuda_int64_legacy_hash_probe_matches_plain(cuda_device):
    """histore_legacy_hash_probe_keys_i64 against the plain version
    (descriptors at the keys' width) on a table of int64 keys: hits,
    misses, edges and negative keys."""
    cfg = _cfg()
    rng = np.random.default_rng(8)
    keys = np.unique(np.concatenate([
        np.array(K.EDGE_KEYS + D.PROBE6, np.int64),
        rng.integers(-2 ** 63, K.INT64_MAX, 20000, dtype=np.int64)]))
    h, ok = hi.insert(hi.create(1 << 14, cfg, "cpu"), torch.as_tensor(keys),
                      torch.arange(len(keys), dtype=I32), cfg)
    assert bool(ok.all())
    q = torch.as_tensor(np.concatenate([
        keys, np.array(K.PAD_KEYS, np.int64),
        rng.integers(-2 ** 63, K.INT64_MAX, 5000, dtype=np.int64)]))
    want = ops.hash_probe(h, q, cfg)
    n0 = ops.LAUNCHES["legacy_hash_probe_i64"]
    got = ops.hash_probe(hi.HashIndex(*[t.to(cuda_device) for t in h]),
                         q.to(cuda_device), cfg)
    assert ops.LAUNCHES["legacy_hash_probe_i64"] == n0 + 1
    for i, (x, y) in enumerate(zip(got, want)):
        assert x.dtype == y.dtype and torch.equal(x.cpu(), y), f"output {i}"
    assert bool(want[1][:len(keys)].all())


@pytest.mark.requires_cuda
def test_cuda_int64_distributed_store_matches_cpu(cuda_device):
    """The int64 DistributedBackend on the card against the CPU through
    writes, reads, deletes, SCANs, an index- and a data-server failure
    and recovery: every answer and store leaf equal, and the int64
    kernels launched, no int32 one."""
    events = _events(9) + [("fail", D.FAILED)] + _events(10, 3) + [
        ("recover", D.FAILED), ("fail_data", D.DATA_FAILED)] + _events(
        11, 3) + [("recover_data", D.DATA_FAILED)] + _events(12, 2)
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    clients = [_client(0, d) for d in (cuda_device, "cpu")]
    answers = [_json(D.drive(c, events)) for c in clients]
    assert answers[0] == answers[1]
    for name in ("group_probe", "hash_probe", "merge", "sorted_search"):
        assert ops.LAUNCHES[name + "_i64"] > 0, name
        assert ops.LAUNCHES[name] == 0, name
    got, want = {}, {}
    leaves(clients[0].backend.store, "", got)
    leaves(clients[1].backend.store, "", want)
    for k, x in want.items():
        assert got[k].dtype == x.dtype
        np.testing.assert_array_equal(got[k], x, err_msg=k)
