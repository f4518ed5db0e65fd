"""The port's distributed store (repro_torch.core.kvstore and the
DistributedBackend) held against the JAX package's, on the CPU.

The JAX DistributedBackend needs one device per group.  A subprocess
forces 8 host devices, builds the mesh with ``AxisType.Auto`` axes (with
jax 0.9's default Explicit axes ``kv.create`` fails with a
ShardingTypeError), replays seeded ``tests/oracle.gen_ops`` traces with
``lease_misses=0`` and writes the observations, the final store leaves,
``parity_report`` and the gauges to an ``.npz``.  The port replays the
same traces at G = 8: the observations must be equal, every store leaf
bit-equal (dtype too), and both must equal the Oracle.  The subprocess
also fails one index server and runs the JAX ``get`` op body on the
store it leaves; the port's ``get`` body on the same store carried
across (``store_from_numpy``) must give the same outputs, which reaches
the group probe's backup half on the store's own path.  G = 1 runs in
process.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import Oracle, assert_equivalent, gen_ops, replay
from repro.configs.histore import scaled as jscaled
from repro.core import kvstore as jkv
from repro.core.client import DistributedBackend as JDist
from repro.core.client import HiStoreClient as JClient
from repro_torch.configs.histore import scaled
from repro_torch.convert import distributed_backend_from_numpy
from repro_torch.convert import store_from_numpy
from repro_torch.core import kvstore as kv
from repro_torch.core.client import DistributedBackend, HiStoreClient

ROOT = Path(__file__).resolve().parents[1]
G = 8
DCAP = 512
# (mix, seed, capacity_q, log_capacity, async_apply_batch): the small
# exchange capacities force routing push-back and client retries, the
# small logs force drains
CASES = [("uniform", 7, 64, 1 << 10, 256), ("zipfian", 8, 64, 1 << 10, 256),
         ("delete_heavy", 9, 4, 64, 16), ("scan_heavy", 10, 2, 64, 16)]
FAILED = 2          # the index server the subprocess fails (case 0's store)

JAX_SIDE = r'''
import json, os, sys
import numpy as np
import jax
from oracle import gen_ops, replay
from repro.configs.histore import scaled
from repro.core import kvstore as kv
from repro.core.client import DistributedBackend, HiStoreClient

CASES, G, DCAP, FAILED = json.loads(sys.argv[2])
mesh = jax.make_mesh((G,), ("kv",),
                     axis_types=(jax.sharding.AxisType.Auto,))
out = {}


def leaves(prefix, t, path=""):
    if hasattr(t, "_fields"):
        for f in t._fields:
            leaves(prefix, getattr(t, f), f"{path}.{f}" if path else f)
    else:
        out[f"{prefix}/leaf/{path}"] = np.asarray(t)


def cfg_of(lcap, ab):
    return scaled(use_kernels="off", lease_misses=0, log_capacity=lcap,
                  async_apply_batch=ab)


leaves("create", kv.create(mesh, DCAP, cfg_of(1 << 10, 256)))
for i, (mix, seed, capq, lcap, ab) in enumerate(CASES):
    cfg = cfg_of(lcap, ab)
    c = HiStoreClient(DistributedBackend(mesh, cfg, DCAP, capacity_q=capq,
                                         scan_limit=128),
                      batch_quantum=16, max_retries=32)
    obs = replay(c, gen_ops(seed, mix, n_events=14, batch=32))
    out[f"{i}/obs"] = np.array(json.dumps(obs))
    out[f"{i}/stats"] = np.array(json.dumps(c.stats))
    out[f"{i}/gauges"] = np.array(json.dumps(c.metrics().gauges))
    leaves(str(i), c.backend.store)
    out[f"{i}/parity"] = np.array(json.dumps(
        kv.parity_report(c.backend.store, cfg)))
    if i == 0:
        st = c.backend.store
        ops = kv.make_ops(mesh, cfg, capacity_q=capq)
        # the second-hop fetch: live addresses and -1 lanes, on the store
        # and with data server 3 failed (its shard served by the mirror)
        sig = np.asarray(st.hash.sig).reshape(-1)
        addrs = np.asarray(st.hash.addr).reshape(-1)[(sig != 0)
                                                     & (sig != -1)][:120]
        addrs = np.concatenate([addrs, np.full(128 - len(addrs), -1)])
        out["fetch/addrs"] = addrs.astype(np.int32)
        out["fetch/valid"] = np.arange(128) % 7 != 3
        for tag, s2 in (("fetch", st), ("fetchdd",
                                        kv.fail_data_server(st, 3))):
            leaves(tag, s2)
            s3, vals, routed = ops["fetch"](s2, out["fetch/addrs"],
                                            out["fetch/valid"])
            out[f"{tag}/vals"] = np.asarray(vals)
            out[f"{tag}/routed"] = np.asarray(routed)
            leaves(f"{tag}_after", s3)
        # a gc round over filled free queues: device d frees slots of
        # shard d + 1 and one of shard 5, whose data server is down (its
        # frees are re-queued); device 0 sends more than capacity_q to
        # one shard (the overflow is re-queued)
        fq = [np.array(a) for a in st.data.freeq]
        lcap_fq = fq[0].shape[1]
        for d in range(G):
            s = (d + 1) % G
            a = np.concatenate([s * DCAP + np.arange(70 if d == 0 else 5),
                                [5 * DCAP + d]]).astype(np.int32)
            pos = (fq[3][d] + np.arange(len(a))) % lcap_fq
            fq[0][d, pos] = 0
            fq[1][d, pos] = a
            fq[2][d, pos] = 1
            fq[3][d] += len(a)
        alive = np.asarray(st.data.alive).copy()
        alive[5] = False
        st_gc = jax.device_put(st._replace(data=st.data._replace(
            freeq=type(st.data.freeq)(*[jax.numpy.asarray(a) for a in fq]),
            alive=jax.numpy.asarray(alive))), kv.store_sharding(mesh))
        leaves("gc", st_gc)
        leaves("gc_after", ops["gc"](st_gc))
        c.fail_server(FAILED)
        leaves("fail", c.backend.store)
        rng = np.random.default_rng(0)
        hits = np.unique(np.concatenate(
            [e[1] for e in gen_ops(seed, mix, n_events=14, batch=32)
             if e[0] == "put"]))[:96]
        keys = np.concatenate([hits, rng.integers(0, 10 ** 6,
                                                  128 - len(hits))])
        keys = keys.astype(np.int32)
        valid = np.arange(len(keys)) % 9 != 4
        res = kv.make_ops(mesh, cfg, capacity_q=capq)["get"](
            c.backend.store, keys, valid)
        out["fail/keys"] = keys
        out["fail/valid"] = valid
        for j, r in enumerate(res):
            out[f"fail/out{j}"] = np.asarray(r)
np.savez(sys.argv[1], **out)
'''


def _cfg(lcap=1 << 10, ab=256):
    return scaled(use_kernels="off", lease_misses=0, log_capacity=lcap,
                  async_apply_batch=ab)


def _leaves(t, path=""):
    """{dotted field path: numpy array} of a port state."""
    if hasattr(t, "_fields"):
        out = {}
        for f in t._fields:
            out.update(_leaves(getattr(t, f), f"{path}.{f}" if path else f))
        return out
    return {path: t.cpu().numpy()}


def _assert_leaves_equal(store, jax8, prefix):
    got = _leaves(store)
    want = {k.split("/leaf/")[1]: v for k, v in jax8.items()
            if k.startswith(f"{prefix}/leaf/")}
    assert sorted(got) == sorted(want)
    for path, x in got.items():
        assert x.dtype == want[path].dtype, (path, x.dtype, want[path].dtype)
        np.testing.assert_array_equal(x, want[path], err_msg=path)


def _ns(jax8, prefix):
    """The numpy leaves under ``prefix`` as a tree of namespaces, the
    shape ``store_from_numpy`` reads."""
    root = {}
    for k, v in jax8.items():
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


def _json(obs):
    return json.loads(json.dumps(obs))


@pytest.fixture(scope="module")
def jax8(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax8") / "jax8.npz"
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}:{ROOT / 'tests'}",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "JAX_PLATFORMS": "cpu"}
    r = subprocess.run(
        [sys.executable, "-c", JAX_SIDE, str(path),
         json.dumps([CASES, G, DCAP, FAILED])],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _port_client(case):
    _, _, capq, lcap, ab = CASES[case]
    return HiStoreClient(
        DistributedBackend(G, _cfg(lcap, ab), DCAP, capacity_q=capq,
                           scan_limit=128, device="cpu"),
        batch_quantum=16, max_retries=32)


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[c[0] for c in CASES])
def test_g8_trace_matches_jax_and_oracle(jax8, case):
    """Observations, client stats, every store leaf, parity_report and
    the gauges equal the JAX DistributedBackend's at G = 8."""
    mix, seed, _, lcap, ab = CASES[case]
    trace = gen_ops(seed, mix, n_events=14, batch=32)
    c = _port_client(case)
    obs = replay(c, trace)
    assert_equivalent(_json(obs), json.loads(str(jax8[f"{case}/obs"])),
                      label=f"torch-vs-jax/{mix}")
    assert_equivalent(obs, replay(Oracle(value_words=4), trace),
                      label=f"torch-vs-oracle/{mix}")
    assert c.stats == json.loads(str(jax8[f"{case}/stats"]))
    _assert_leaves_equal(c.backend.store, jax8, str(case))
    report = kv.parity_report(c.backend.store, _cfg(lcap, ab))
    assert _json(report) == json.loads(str(jax8[f"{case}/parity"]))
    assert all(e["agree"] for e in report)
    assert c.metrics().gauges == json.loads(str(jax8[f"{case}/gauges"]))


def test_g8_retries_and_drains_happen(jax8):
    """The small cases do push back and drain (what the traces above are
    meant to exercise)."""
    c = _port_client(3)
    replay(c, gen_ops(CASES[3][1], CASES[3][0], n_events=14, batch=32))
    assert c.stats["retries"] > 0
    assert c.metrics().counters.get("pushbacks", 0) > 0


def test_create_and_owner_group_match_jax(jax8):
    _assert_leaves_equal(kv.create(G, DCAP, _cfg(), "cpu"), jax8, "create")
    keys = np.concatenate([np.arange(-3, 3000), [2 ** 31 - 1, 2 ** 31 - 2,
                                                 -2 ** 31]]).astype(np.int32)
    for g in (1, 2, 3, 8, 13):
        got = kv.owner_group(torch.as_tensor(keys), g)
        want = np.asarray(jkv.owner_group(jnp.asarray(keys), g))
        assert got.dtype == torch.int32 and want.dtype == np.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"G={g}")


def test_get_body_after_fail_server_matches_jax(jax8):
    """The JAX store right after ``fail_server(FAILED)`` (its hash and
    primary log wiped, the lanes it owned routed to its backup holder),
    carried across: the port's ``get`` op body gives the JAX body's
    outputs, and the failed group's keys are answered by the backup half
    of the group probe (the pending log and the sorted replica)."""
    cfg = _cfg()
    st = store_from_numpy(_ns(jax8, "fail"), cfg, "cpu")
    _assert_leaves_equal(st, jax8, "fail")
    assert not bool(st.alive[FAILED])
    keys = torch.as_tensor(jax8["fail/keys"])
    valid = torch.as_tensor(jax8["fail/valid"])
    out = kv.make_ops(cfg, G, capacity_q=CASES[0][2])["get"](st, keys,
                                                            valid)
    for j, x in enumerate(out):
        np.testing.assert_array_equal(x.numpy(), jax8[f"fail/out{j}"],
                                      err_msg=f"get output {j}")
    owned = (kv.owner_group(keys, G) == FAILED) & valid
    assert bool(out[1][owned].any())        # found via the backup half


def test_carried_backend_continues_like_jax(jax8):
    """A backend carried across with distributed_backend_from_numpy
    answers a GET batch as the JAX store's own get body did (healthy
    store of case 0)."""
    cfg = _cfg()
    be = distributed_backend_from_numpy(_ns(jax8, "0"), cfg, "cpu",
                                        capacity_q=CASES[0][2])
    assert be._pending_bound == be.pending_ops()
    c = HiStoreClient(be, batch_quantum=16)
    trace = gen_ops(CASES[0][1], CASES[0][0], n_events=14, batch=32)
    put_keys = np.unique(np.concatenate([e[1] for e in trace
                                         if e[0] == "put"]))
    oracle = Oracle(value_words=4)
    replay(oracle, trace)
    res = c.get(put_keys)
    want = oracle.get(put_keys)
    np.testing.assert_array_equal(res.found.numpy(), want.found)
    np.testing.assert_array_equal(res.values.numpy(), want.values)


def test_fetch_body_matches_jax(jax8):
    """The second-hop fetch on the healthy store and with data server 3
    failed (reads of its shard fail over to the mirror on device 4):
    values, routed lanes and the returned store (heartbeats) equal
    JAX's."""
    cfg = _cfg()
    fetch = kv.make_ops(cfg, G, capacity_q=CASES[0][2])["fetch"]
    addrs = torch.as_tensor(jax8["fetch/addrs"])
    valid = torch.as_tensor(jax8["fetch/valid"])
    for tag in ("fetch", "fetchdd"):
        st = store_from_numpy(_ns(jax8, tag), cfg, "cpu")
        st2, vals, routed = fetch(st, addrs, valid)
        np.testing.assert_array_equal(vals.numpy(), jax8[f"{tag}/vals"])
        np.testing.assert_array_equal(routed.numpy(), jax8[f"{tag}/routed"])
        _assert_leaves_equal(st2, jax8, f"{tag}_after")
        on3 = (addrs >= 0) & (addrs // DCAP == 3) & valid
        assert bool(on3.any()) and bool(vals[on3].any())


def test_gc_body_matches_jax(jax8):
    """A gc round over filled free queues, frees to a data-dead shard and
    an exchange overflow among them: the store after the round (bitmaps,
    re-queued frees, fq_spill, heartbeats) equals JAX's."""
    cfg = _cfg()
    st = store_from_numpy(_ns(jax8, "gc"), cfg, "cpu")
    after = kv.make_ops(cfg, G, capacity_q=CASES[0][2])["gc"](st)
    _assert_leaves_equal(after, jax8, "gc_after")
    left = int((after.data.freeq.tail - after.data.freeq.applied).sum())
    assert 0 < left < int((st.data.freeq.tail - st.data.freeq.applied).sum())


def test_value_plane_audits_match_jax(jax8):
    """keys_for_addrs (shard, else key mirror, else RecoveryError) and
    the pending free addresses against JAX's, which read the numpy
    leaves; the two drains (per pair, and in apply rounds) agree."""
    from repro.core import data_plane as jdp
    from repro_torch.core import data_plane as dp

    cfg = _cfg()
    ns = _ns(jax8, "fetchdd")            # data server 3 down, wiped
    st = store_from_numpy(ns, cfg, "cpu")
    addrs = jax8["fetch/addrs"][jax8["fetch/addrs"] >= 0]
    assert (addrs // DCAP == 3).any()
    np.testing.assert_array_equal(dp.keys_for_addrs(st, addrs),
                                  jdp.keys_for_addrs(ns, addrs))
    ns.data.alive = ns.data.alive.copy()
    ns.data.alive[4] = False             # shard 3's mirror is on 4
    st = store_from_numpy(ns, cfg, "cpu")
    with pytest.raises(jdp.RecoveryError) as je:
        jdp.keys_for_addrs(ns, addrs)
    with pytest.raises(dp.RecoveryError) as te:
        dp.keys_for_addrs(st, addrs)
    assert str(te.value) == str(je.value)
    gc = _ns(jax8, "gc_after")
    np.testing.assert_array_equal(
        dp._pending_free_addrs(store_from_numpy(gc, cfg, "cpu").data.freeq),
        jdp._pending_free_addrs(gc.data.freeq))
    # pending entries, then both drains
    ops = kv.make_ops(cfg, G, capacity_q=CASES[0][2])
    st = store_from_numpy(_ns(jax8, "0"), cfg, "cpu")
    keys = torch.arange(1, 129, dtype=torch.int32) * 7919
    st, ok, _, _ = ops["put"](st, keys, torch.zeros((128, 4), dtype=torch.int32),
                              torch.ones(128, dtype=torch.bool))
    assert bool(ok.all()) and kv.device_counters(st)["pending_log_ops"] > 0
    a = dp.drain_all_logs(st, cfg)
    b = dp.drain_all_logs(st, cfg, ops["apply"])
    for x, y in ((a.bsorted, b.bsorted), (a.blog, b.blog)):
        for f, u, v in zip(x._fields, x, y):
            assert torch.equal(u, v), f
    assert int((a.blog.tail - a.blog.applied).max()) == 0


class _OnHost:
    """A client whose op results come back on the host (``replay`` reads
    them with numpy)."""

    def __init__(self, client):
        self.client = client

    def __getattr__(self, name):
        fn = getattr(self.client, name)

        def call(*args):
            r = fn(*args)
            return type(r)(*[x.cpu() if torch.is_tensor(x) else x
                             for x in r])
        return call


@pytest.mark.requires_cuda
def test_cuda_distributed_store_matches_cpu():
    """The port's DistributedBackend on the card (group probe, hash
    probe, merge and search kernels) against the same trace on the CPU:
    observations and every store leaf equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernels are CUDA "
                    "C++ built with nvcc and have no CPU mode")
    from repro_torch.kernels import ops

    mix, seed, capq, lcap, ab = CASES[2]
    cfg = scaled(lease_misses=0, log_capacity=lcap, async_apply_batch=ab)
    trace = gen_ops(seed, mix, n_events=14, batch=32)
    clients = [HiStoreClient(DistributedBackend(G, cfg, DCAP,
                                                capacity_q=capq,
                                                device=d),
                             batch_quantum=16, max_retries=32)
               for d in ("cuda", "cpu")]
    n0 = ops.LAUNCHES["group_probe"]
    obs = [replay(_OnHost(c), trace) for c in clients]
    assert ops.LAUNCHES["group_probe"] > n0
    assert_equivalent(obs[0], obs[1], label="cuda-vs-cpu")
    got = _leaves(clients[0].backend.store)
    for path, x in _leaves(clients[1].backend.store).items():
        np.testing.assert_array_equal(got[path], x, err_msg=path)


@pytest.mark.parametrize("mix", ["uniform", "delete_heavy"])
def test_g1_in_process_matches_jax(mix):
    """G = 1 needs no subprocess: every group's backups fold onto the one
    device, which reaches the probe's all-selected backup half."""
    kw = dict(use_kernels="off", lease_misses=0, log_capacity=64,
              async_apply_batch=16)
    mesh = jax.make_mesh((1,), ("kv",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    trace = gen_ops(5, mix, n_events=12, batch=16)
    jc = JClient(JDist(mesh, jscaled(**kw), 1024, capacity_q=32),
                 batch_quantum=16, max_retries=32)
    tc = HiStoreClient(DistributedBackend(1, scaled(**kw), 1024,
                                          capacity_q=32, device="cpu"),
                       batch_quantum=16, max_retries=32)
    obs = replay(tc, trace)
    assert_equivalent(obs, replay(jc, trace), label=f"g1/{mix}")
    assert_equivalent(obs, replay(Oracle(value_words=4), trace),
                      label=f"g1-oracle/{mix}")
    want = jax.tree.map(np.asarray, jc.backend.store)
    got = _leaves(tc.backend.store)
    for path, x in got.items():
        y = want
        for f in path.split("."):
            y = getattr(y, f)
        assert x.dtype == y.dtype, path
        np.testing.assert_array_equal(x, y, err_msg=path)
    report = kv.parity_report(tc.backend.store, scaled(**kw))
    assert report == jkv.parity_report(jc.backend.store, jscaled(**kw))


def test_distributed_backend_scope():
    """Leases on (lease_misses=3, the paper's DEFAULT) construct, and the
    seven failure-handling calls answer as JAX's DistributedBackend
    answers them: at G = 1 in process, each kill switch mask-only with
    its RuntimeWarning and FailResult(0, False), the recoveries and the
    migration as JAX's, the store's leaves equal after the sequence; at
    G = 2 the kill switch wipes."""
    import warnings

    kw = dict(use_kernels="off", lease_misses=3, lease_clock="rounds")
    mesh = jax.make_mesh((1,), ("kv",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    jc = JClient(JDist(mesh, jscaled(**kw), 64, capacity_q=8))
    tc = HiStoreClient(DistributedBackend(1, scaled(**kw), 64, capacity_q=8,
                                          device="cpu"))
    for c in (jc, tc):
        assert c.put(np.arange(1, 9) * 31, np.arange(8)).all_ok
    calls = ("fail_server", "sever_server", "recover_server",
             "fail_data_server", "sever_data_server", "recover_data_server",
             "migrate")
    for call in calls:
        got = []
        for c in (jc, tc):
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                r = getattr(c, call)(*(() if call == "migrate" else (0,)))
            got.append((None if r is None else tuple(np.asarray(r).tolist())
                        if isinstance(r, tuple) else r,
                        [str(x.message) for x in w]))
        assert got[0] == got[1], (call, got)
    assert tc.backend.lease_stalled() is jc.backend.lease_stalled()
    assert tc.stats == jc.stats
    want = jax.tree.map(np.asarray, jc.backend.store)
    for path, x in _leaves(tc.backend.store).items():
        y = want
        for f in path.split("."):
            y = getattr(y, f)
        np.testing.assert_array_equal(x, y, err_msg=path)
    c = HiStoreClient(DistributedBackend(2, scaled(lease_misses=3), 64,
                                         device="cpu"))
    assert c.backend.lease_misses == 3 and c.backend.lease_clock == "wall"
    assert c.fail_server(0) == (0, True)
    assert c.backend.batch_multiple == 2


def test_distributed_ticker_answers_as_jax():
    """With lease_misses=0 JAX's DistributedBackend has no lease to tick:
    start_ticker() answers False and stop_ticker() None, in both
    packages (G = 1, so the JAX side runs in this process)."""
    mesh = jax.make_mesh((1,), ("kv",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    jc = JClient(JDist(mesh, jscaled(use_kernels="off", lease_misses=0),
                       64, capacity_q=8))
    tc = HiStoreClient(DistributedBackend(1, _cfg(), 64, device="cpu"))
    for c in (jc, tc):
        assert c.start_ticker() is False
        assert c.stop_ticker() is None


def test_distributed_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DistributedBackend(2, _cfg(), 64)
