"""The port's distributed store under failures (degraded PUT and DELETE,
index- and data-server fail / sever / recover, re-replication, value
migration, lease detection and the ticker) held against the JAX
package's, on the CPU.

One module-scoped subprocess forces 8 host devices, builds the JAX mesh
with ``AxisType.Auto`` axes, and replays the schedules of
``tests/_dist_fault_schedules.py`` (``fault_selftest.run_mix`` for two
mixes; ``lease_selftest``'s multi-failure, detection-bound, detector
trace, data-server detection, scan completeness and online catch-up)
through the unmodified JAX ``DistributedBackend`` at
``use_kernels="off"``; it writes each schedule's record (every client
call's answer and the detector's lists after it, the FailResults and
RecoverResults, RecoveryError's fields, the parity reports with their
value-slot audits, ``client.stats``, the gauges) and the final store
leaves to an ``.npz``.  The port replays the same schedules at G = 8:
every record equal, every store leaf bit-equal (dtype too), and the
schedules assert the Oracle and their own checks on both sides.  The
subprocess also carries one store across in the middle of an outage.
G = 1 (mask-only failures), the wall-clock ticker and its give-up latch
run in process.

Over gloo ranks on the CPU (``repro_torch.launch.ranks.spawn``, rank
bodies in ``tests/_dist_ranks.py``, each spawn with its timeout): every
schedule and the carry over 4 ranks in one spawn, the multi-failure and
the data-server detection over 8 (one group a rank), each rank's record
equal to JAX's and the gathered leaves bit-equal; the ticker over 2
ranks in one spawn (an idle sever detected on both, the give-up latch,
foreground ops from a thread while the tickers tick).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import types
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import _dist_fault_schedules as S
import _dist_ranks
from oracle import FaultInjector
from repro.configs.histore import scaled as jscaled
from repro.core.client import DistributedBackend as JDist
from repro.core.client import HiStoreClient as JClient
from repro_torch.configs.histore import scaled
from repro_torch.convert import distributed_backend_from_numpy
from repro_torch.core import kvstore as kv
from repro_torch.core.client import DistributedBackend, HiStoreClient
from repro_torch.core.results import FailResult, RecoverResult
from repro_torch.launch import ranks

ROOT = Path(__file__).resolve().parents[1]
G = S.G

JAX_SIDE = r'''
import json, sys, types
import numpy as np
import jax
import jax.numpy as jnp
import _dist_fault_schedules as S
from repro.configs.histore import scaled
from repro.core import kvstore as kv
from repro.core.client import DistributedBackend, HiStoreClient
from repro.core.hashing import key_dtype
from repro_torch.convert import lease_state

mesh = jax.make_mesh((S.G,), ("kv",),
                     axis_types=(jax.sharding.AxisType.Auto,))
cfg = scaled(**S.CFG_KW)
env = types.SimpleNamespace(
    cfg=cfg, kv=kv,
    own=lambda k: np.asarray(kv.owner_group(
        jnp.asarray(np.asarray(k), key_dtype()), S.G)),
    make_client=lambda **kw: HiStoreClient(
        DistributedBackend(mesh, cfg, S.CAP, capacity_q=64, scan_limit=128),
        **kw))
out = {}


def leaves(prefix, t, path=""):
    if hasattr(t, "_fields"):
        for f in t._fields:
            leaves(prefix, getattr(t, f), f"{path}.{f}" if path else f)
    else:
        out[f"{prefix}/leaf/{path}"] = np.asarray(t)


for name in json.loads(sys.argv[2]):
    if name != "carry":
        rec, c = S.SCHEDULES[name](env)
        out[f"{name}/rec"] = np.array(json.dumps(rec))
        leaves(name, c.backend.store)
        continue
    log, c = S.carry_before(env)
    leaves("carry", c.backend.store)
    out["carry/before"] = np.array(json.dumps(log))
    out["carry/lease"] = np.array(json.dumps(lease_state(c.backend)))
    out["carry/pending_bound"] = np.array(c.backend._pending_bound)
    out["carry/rec"] = np.array(json.dumps(S.carry_after(env, c)))
    leaves("carry_end", c.backend.store)
np.savez(sys.argv[1], **out)
'''


def _cfg():
    return scaled(**S.CFG_KW)


def _env(device="cpu", cfg=None):
    cfg = cfg or _cfg()

    def own(keys):
        k = torch.as_tensor(np.asarray(keys).astype(np.int32))
        return kv.owner_group(k, G).numpy()

    return types.SimpleNamespace(
        cfg=cfg, kv=kv, own=own,
        make_client=lambda **kw: HiStoreClient(
            DistributedBackend(G, cfg, S.CAP, capacity_q=64, scan_limit=128,
                               device=device), **kw))


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


_ns = S.leaf_tree
_assert_record_equal = S.assert_record_equal


# the JAX side's schedules in three subprocesses that run at once: most of
# its time is eager dispatch and per-shape compiles, one process each
JAX_SPLIT = (["mix_uniform", "mix_delete_heavy"],
             ["multi_failure", "detection_bound", "scan_completeness"],
             ["detector_trace", "data_server_detection", "online_catch_up",
              "carry"])


@pytest.fixture(scope="module")
def jax8(tmp_path_factory):
    assert sorted(n for part in JAX_SPLIT for n in part) == sorted(
        list(S.SCHEDULES) + ["carry"])
    tmp = tmp_path_factory.mktemp("jax8f")
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}:{ROOT / 'tests'}",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "JAX_PLATFORMS": "cpu"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", JAX_SIDE, str(tmp / f"{i}.npz"),
         json.dumps(part)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=ROOT, env=env) for i, part in enumerate(JAX_SPLIT)]
    out = {}
    for i, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=900)
        finally:
            for q in procs:
                if q.poll() is None and p.returncode is None:
                    q.kill()
        assert p.returncode == 0, err[-4000:]
        with np.load(tmp / f"{i}.npz") as z:
            out.update({k: z[k] for k in z.files})
    return out


@pytest.fixture(scope="module")
def jax8_npz(jax8, tmp_path_factory):
    """The JAX records and leaves as an ``.npz`` the rank processes read."""
    path = tmp_path_factory.mktemp("jax8r") / "faults.npz"
    np.savez(path, **jax8)
    return str(path)


@pytest.mark.parametrize("name", list(S.SCHEDULES))
def test_schedule_matches_jax(jax8, name):
    """Every client call's answer, the FailResults and RecoverResults,
    RecoveryError's fields, the parity reports and value-slot audits,
    the detector's lists after every call, ``client.stats``, the gauges
    and every store leaf equal the JAX DistributedBackend's; the
    schedule's own checks (the Oracle among them) hold on the port."""
    rec, c = S.SCHEDULES[name](_env())
    _assert_record_equal(rec, json.loads(str(jax8[f"{name}/rec"])), name)
    _assert_leaves_equal(c.backend.store, jax8, name)


def test_schedules_reach_what_they_are_for(jax8):
    """The schedules exercise what they claim: displaced PUTs and strays
    migrated, demotions by the detector, a rebuilt copy, a scan retried,
    catch-up debt, a data-plane fallback blocked by a dead shard."""
    recs = {n: json.loads(str(jax8[f"{n}/rec"])) for n in S.SCHEDULES}
    assert all(recs[n]["stats"]["migrated"] > 0
               for n in ("mix_uniform", "mix_delete_heavy"))
    assert recs["detector_trace"]["detected"] == [5]
    assert recs["data_server_detection"]["detected_data"] == [4]
    assert recs["scan_completeness"]["scan_retries"] > 0
    assert recs["online_catch_up"]["recover"][3] > 0
    assert recs["multi_failure"]["recovery_error"][2] == ["data server 6"]
    fails = [e for r in recs.values() for e in r["log"]
             if e[0] in ("fail_server", "sever_server", "fail_data_server",
                         "sever_data_server")]
    assert fails and all(e[2] == [e[1][0], True] for e in fails)
    recovers = [e[2] for r in recs.values() for e in r["log"]
                if e[0] == "recover_server"]
    assert recovers and all(len(x) == 4 for x in recovers)


def test_carried_mid_outage_continues_like_jax(jax8):
    """A store carried across in the middle of an outage (index server 2
    failed, 5 severed and one round into its lease), with its liveness
    and lease state: the port goes on exactly as the JAX backend did
    (detection at the same call, both recoveries, every answer, the
    store's leaves)."""
    lease = json.loads(str(jax8["carry/lease"]))
    assert lease["_dead"] == [2] and lease["_severed"] == [5]
    assert lease["_hb_misses"][5] == 1
    be = distributed_backend_from_numpy(
        _ns(jax8, "carry"), _cfg(), "cpu", capacity_q=64, scan_limit=128,
        pending_bound=int(jax8["carry/pending_bound"]), lease=lease)
    _assert_leaves_equal(be.store, jax8, "carry")
    assert be._dead == {2} and be._severed == {5}
    c = HiStoreClient(be, batch_quantum=4 * G, max_retries=32)
    rec = S.carry_after(_env(), c)
    _assert_record_equal(rec, json.loads(str(jax8["carry/rec"])), "carry")
    _assert_leaves_equal(c.backend.store, jax8, "carry_end")


def test_g1_failure_is_mask_only_in_both_packages():
    """With one group every replica lives on the failing server: both
    packages mask without wiping, warn, and report wiped=False; the
    leaves after each kill switch and after recovery are equal."""
    kw = dict(use_kernels="off", lease_misses=0, log_capacity=64,
              async_apply_batch=16)
    mesh = jax.make_mesh((1,), ("kv",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    jc = JClient(JDist(mesh, jscaled(**kw), 256, capacity_q=32),
                 batch_quantum=16)
    tc = HiStoreClient(DistributedBackend(1, scaled(**kw), 256,
                                          capacity_q=32, device="cpu"),
                       batch_quantum=16)
    keys = np.arange(1, 41) * 7919
    for c in (jc, tc):
        assert c.put(keys, np.arange(40)).all_ok
    for call in ("fail_server", "sever_server", "fail_data_server",
                 "sever_data_server"):
        out = []
        for c in (jc, tc):
            with pytest.warns(RuntimeWarning, match="mask-only"):
                out.append(getattr(c, call)(0))
        assert out[0] == out[1] == (0, False)
        assert isinstance(out[1], FailResult)
    r = [c.recover_server(0) for c in (jc, tc)]
    assert tuple(r[0]) == tuple(r[1]) and isinstance(r[1], RecoverResult)
    for c in (jc, tc):
        c.recover_data_server(0)
        g = c.get(keys)
        assert bool(np.asarray(g.found).all())
    want = jax.tree.map(np.asarray, jc.backend.store)
    for path, x in _leaves(tc.backend.store).items():
        y = want
        for f in path.split("."):
            y = getattr(y, f)
        assert x.dtype == y.dtype, path
        np.testing.assert_array_equal(x, y, err_msg=path)


def _wall_client(**kw):
    cfg = scaled(use_kernels="off", log_capacity=512, async_apply_batch=128,
                 lease_misses=3, lease_clock="wall", lease_timeout_s=0.2,
                 lease_interval_s=0.05)
    return HiStoreClient(DistributedBackend(G, cfg, S.CAP, capacity_q=64,
                                            device="cpu"),
                         batch_quantum=4 * G, max_retries=32, **kw), cfg


def test_wall_clock_ticker_detects_an_idle_sever():
    """``lease_selftest.run_idle_wall_clock``'s contract on the port: after
    a sever not one foreground op runs, and the ticker alone demotes the
    server, no sooner than the lease timeout and within it plus a tick
    interval and slack; stop_ticker() stops the thread; recovery restores
    the reads and parity."""
    client, cfg = _wall_client()
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
        # the heartbeat counter stops here: the lease runs from the last
        # advance the ticker saw, at or before the sever
        t_hb = float(backend._hb_t[3])
        assert t_hb <= time.monotonic()
        stats0 = dict(client.stats)
        budget = cfg.lease_timeout_s + cfg.lease_interval_s + 5.0
        while 3 not in backend._dead:
            time.sleep(0.01)
            assert time.monotonic() - t0 <= budget, "no idle detection"
        assert time.monotonic() - t_hb >= cfg.lease_timeout_s
        assert backend.detected == [3]
        assert dict(client.stats) == stats0, "zero foreground ops"
        assert inj.oracle_kills == 0
        assert client.metrics().counters.get("ticker_rounds", 0) > 0
        t = backend._ticker
    finally:
        client.stop_ticker()
    assert not t.is_alive() and backend._ticker is None
    rounds = client.metrics().counters.get("ticker_rounds", 0)
    time.sleep(4 * cfg.lease_interval_s)
    assert client.metrics().counters.get("ticker_rounds", 0) == rounds
    client.recover_server(3)
    assert client.get(keys).all_found
    assert all(p["agree"] for p in kv.parity_report(backend.store, cfg))


def test_ticker_gave_up_is_latched_and_counted():
    """Three consecutive tick errors end the ticker and say so: the
    ticker_errors / ticker_gave_up counters, start_ticker() False while
    latched, stop_ticker() clearing the latch; the thread holds only a
    weak reference to the backend."""
    client, _ = _wall_client()
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
    # lease_misses=0: no lease to tick, as in JAX
    off = HiStoreClient(DistributedBackend(
        2, scaled(use_kernels="off", lease_misses=0), 64, device="cpu"))
    assert off.start_ticker() is False and off.stop_ticker() is None


def test_ticker_thread_serializes_with_foreground_ops():
    """A running ticker and foreground ops share the backend's lock: a
    foreground thread's PUT/GET stream with the ticker ticking between
    them stays right, and the ticker stops."""
    client, _ = _wall_client()
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
    finally:
        client.stop_ticker()
    assert not errors, errors
    assert client.metrics().counters.get("ticker_rounds", 0) > 0
    assert client.backend.detected == []


@pytest.mark.parametrize("world,names,timeout_s", [
    (4, list(S.SCHEDULES) + ["carry"], 600),
    (8, ["multi_failure", "data_server_detection"], 300)])
def test_schedules_over_ranks_match_jax(jax8, jax8_npz, world, names,
                                        timeout_s):
    """The schedules (and the mid-outage carry, through
    ``distributed_backend_from_numpy(..., comm=)``) over ``world`` gloo
    ranks, one spawn: the data servers' fail / sever / recover with the
    allocator's sweep, the index servers', the detector and the
    migration, on every rank a record equal to JAX's 8-device mesh and
    the gathered store leaves bit-equal, dtype too."""
    if world == 8:
        rec = json.loads(str(jax8["multi_failure/rec"]))
        assert rec["recovery_error"][2] == ["data server 6"]
        rec = json.loads(str(jax8["data_server_detection/rec"]))
        assert rec["detected_data"] == [4]
    out = ranks.spawn(_dist_ranks.faults_vs_jax, world, device="cpu",
                      timeout_s=timeout_s, args=(jax8_npz, names))
    assert len(out) == world
    assert all(o == out[0] for o in out) and sorted(out[0]) == sorted(names)
    assert all(n > 20 for n in out[0].values())


@pytest.fixture(scope="module")
def ticker2():
    """The ticker's three cases over 2 gloo ranks, one spawn
    (``_dist_ranks.ticker_cases``): each rank's results by case."""
    return ranks.spawn(_dist_ranks.ticker_cases, 2, device="cpu",
                       timeout_s=240)


def test_ticker_over_ranks_detects_an_idle_sever(ticker2):
    """The wall-clock ticker over 2 gloo ranks: with zero foreground ops
    both ranks demote the severed index server in the same round, no
    sooner than the lease timeout, and stop (``ticker_idle_sever``)."""
    assert all(took < 5.25 and rounds > 0
               for took, rounds in (r["ticker_idle_sever"] for r in ticker2))


def test_ticker_over_ranks_gave_up_is_latched(ticker2):
    """Three tick errors on each of 2 gloo ranks end both tickers in the
    same round, latched and counted as on one process
    (``ticker_gave_up``)."""
    got = [r["ticker_gave_up"] for r in ticker2]
    assert got[0] == got[1] and got[0]["ticker_errors"] == 3


def test_ticker_over_ranks_serializes_with_foreground_ops(ticker2):
    """Foreground PUTs and GETs from a thread on each of 2 gloo ranks
    while the tickers tick in their own rounds: right answers, no hang
    inside the spawn's timeout (``ticker_foreground``)."""
    assert all(r["ticker_foreground"] > 0 for r in ticker2)


@pytest.mark.requires_cuda
def test_cuda_fault_schedule_matches_cpu():
    """Schedule a (``fault_selftest.run_mix``, uniform) on the card, its
    degraded PUTs and DELETEs through the stacked group probe and its
    recoveries through the hash probe and the merge, against the same
    schedule on the CPU: every record and every store leaf equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernels are CUDA "
                    "C++ built with nvcc and have no CPU mode")
    from repro_torch.kernels import ops

    n0 = ops.LAUNCHES["group_probe"]
    cfg = scaled(**{**S.CFG_KW, "use_kernels": "auto"})
    cuda_env, cpu_env = _env("cuda", cfg), _env("cpu", cfg)
    got, gc = S.SCHEDULES["mix_uniform"](cuda_env)
    want, wc = S.SCHEDULES["mix_uniform"](cpu_env)
    assert ops.LAUNCHES["group_probe"] > n0
    _assert_record_equal(got, want, "cuda-vs-cpu")
    ref = _leaves(wc.backend.store)
    for path, x in _leaves(gc.backend.store).items():
        np.testing.assert_array_equal(x, ref[path], err_msg=path)
