"""The port's HiStoreClient over LocalBackend, held against the JAX
package's client and the dict + sorted-list Oracle on seeded traces,
plus the port's device rule, its import boundary and the distributed
store's calls, which LocalBackend refuses as JAX's does."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from oracle import Oracle, assert_equivalent, gen_ops, replay
from repro.configs.histore import scaled as jscaled
from repro.core.client import HiStoreClient as JClient
from repro.core.client import LocalBackend as JLocal
from repro_torch.configs.histore import scaled
from repro_torch.convert import backend_from_numpy
from repro_torch.core.client import HiStoreClient, LocalBackend

ROOT = Path(__file__).resolve().parents[1]
TRACE_CFG = dict(use_kernels="off", log_capacity=1 << 10,
                 async_apply_batch=256)


def _jax_client(**kw):
    return JClient(JLocal(4096, jscaled(**{**TRACE_CFG, **kw})),
                   batch_quantum=16)


def _torch_client(**kw):
    return HiStoreClient(LocalBackend(4096, scaled(**{**TRACE_CFG, **kw}),
                                      device="cpu"), batch_quantum=16)


@pytest.mark.parametrize("seed", [11, 12])
@pytest.mark.parametrize("mix", ["uniform", "zipfian", "scan_heavy",
                                 "delete_heavy"])
def test_trace_parity_three_ways(mix, seed):
    trace = gen_ops(seed, mix, n_events=14, batch=16)
    obs_t = replay(_torch_client(), trace)
    obs_j = replay(_jax_client(), trace)
    obs_o = replay(Oracle(value_words=4), trace)
    assert_equivalent(obs_t, obs_j, label=f"torch-vs-jax/{mix}")
    assert_equivalent(obs_t, obs_o, label=f"torch-vs-oracle/{mix}")


def test_state_parity_after_trace():
    """Beyond the answers: the index state itself (hash arrays, logs,
    sorted replicas, value shard, slot bitmap) matches the JAX client's
    bit for bit after a trace with overflow drains."""
    trace = gen_ops(5, "delete_heavy", n_events=16, batch=24)
    small = dict(log_capacity=64, async_apply_batch=16)
    tc, jc = _torch_client(**small), _jax_client(**small)
    replay(tc, trace)
    replay(jc, trace)
    tg, jg = tc.backend.group, jc.backend.group
    pairs = [(tg.hash, jg.hash, None), (tg.plog, jg.plog, None)]
    for r in range(len(tg.sorted)):
        pairs += [(tg.sorted[r], jg.sorted, r), (tg.blogs[r], jg.blogs, r)]
    for t, j, r in pairs:
        for f, x, y in zip(t._fields, t, j):
            y = np.asarray(y) if r is None else np.asarray(y)[r]
            np.testing.assert_array_equal(x.numpy(), y, err_msg=f"{f} {r}")
    np.testing.assert_array_equal(tc.backend.vals.numpy(),
                                  np.asarray(jc.backend.vals))
    np.testing.assert_array_equal(tc.backend.used.numpy(),
                                  np.asarray(jc.backend.used))


def test_overflow_retry_and_apply_every_n_ops():
    """A shard smaller than the writes forces push-back retries; the
    periodic async apply runs; both clients agree op by op."""
    kw = dict(use_kernels="off", log_capacity=64, async_apply_batch=16)
    tc = HiStoreClient(LocalBackend(48, scaled(**kw), device="cpu"),
                       batch_quantum=16, apply_every_n_ops=32)
    jc = JClient(JLocal(48, jscaled(**kw)), batch_quantum=16,
                 apply_every_n_ops=32)
    rng = np.random.RandomState(3)
    for step in range(6):
        keys = rng.randint(1, 200, 40).astype(np.int64)
        vals = rng.randint(1, 1000, 40).astype(np.int64)
        rt, rj = tc.put(keys, vals), jc.put(keys, vals)
        np.testing.assert_array_equal(rt.ok.numpy(), np.asarray(rj.ok))
        np.testing.assert_array_equal(rt.addrs.numpy(), np.asarray(rj.addrs))
        assert rt.retries == rj.retries
        dk = keys[:10]
        dt, dj = tc.delete(dk), jc.delete(dk)
        np.testing.assert_array_equal(dt.found.numpy(), np.asarray(dj.found))
        gt, gj = tc.get(keys), jc.get(keys)
        for x, y in zip(gt, gj):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        st, sj = tc.scan(0, 150, 32), jc.scan(0, 150, 32)
        np.testing.assert_array_equal(st.keys.numpy(), np.asarray(sj.keys))
        assert int(st.count) == int(sj.count)
    assert tc.stats == {k: jc.stats[k] for k in tc.stats}
    assert tc.stats["retries"] > 0 and tc.stats["applies"] > 0


def test_carry_state_across():
    """Load in JAX, convert, then continue one trace in both packages."""
    trace = gen_ops(21, "uniform", n_events=20, batch=16)
    jc = _jax_client()
    replay(jc, trace[:10])
    jb = jc.backend
    leaves = jax.tree.map(np.asarray, jb.group)
    be = backend_from_numpy(leaves, np.asarray(jb.vals), np.asarray(jb.used),
                            scaled(**TRACE_CFG), "cpu",
                            pending_bound=jb._pending_bound)
    tc = HiStoreClient(be, batch_quantum=16)
    assert_equivalent(replay(tc, trace[10:]), replay(jc, trace[10:]),
                      label="carried state")


def test_metrics_and_trace_dump(tmp_path):
    cfg = scaled(telemetry="trace", **TRACE_CFG)
    c = HiStoreClient(LocalBackend(1024, cfg, device="cpu"),
                      batch_quantum=16)
    c.put(np.arange(1, 40), np.arange(1, 40))
    c.get(np.arange(1, 60))
    c.delete(np.arange(1, 5))
    c.scan(0, 100, 16)
    snap = c.metrics()
    assert snap.counters["put_ops"] == 39
    assert snap.counters["get_ops"] == 59
    assert snap.gauges["pending_log_ops"] == 0      # the scan drained
    assert "histore_put_ops_total 39" in c.metrics_text()
    c.dump_trace(tmp_path / "t.json")
    assert (tmp_path / "t.json").read_text().startswith("[")


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LocalBackend(64, scaled())
    assert LocalBackend(64, scaled(), device="cpu").device.type == "cpu"


def test_out_of_scope_calls_raise():
    """LocalBackend refuses the distributed store's calls with JAX's
    messages, which name the distributed backend.  The ticker is not
    among them: JAX answers it on LocalBackend."""
    c = HiStoreClient(LocalBackend(64, scaled(**TRACE_CFG), device="cpu"))
    jc = JClient(JLocal(64, jscaled(**TRACE_CFG)))
    for name in ("sever_server", "sever_data_server", "fail_data_server",
                 "recover_data_server"):
        msgs = []
        for client in (jc, c):
            with pytest.raises(NotImplementedError,
                               match="[Dd]istributed[ B]") as e:
                getattr(client, name)(0)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1], name


def test_ticker_answers_as_jax_on_local_backend():
    """LocalBackend has no lease ticker: JAX's client answers
    start_ticker() with False and stop_ticker() with None, and so does
    the port's."""
    jc = _jax_client()
    tc = _torch_client()
    for c in (jc, tc):
        assert c.start_ticker() is False
        assert c.stop_ticker() is None


def test_port_imports_no_jax():
    """Import the port and every module under it in a fresh interpreter:
    neither jax nor the JAX package may be loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('clean', len([m for m in sys.modules\n"
        "                    if m.startswith('repro_torch')]))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode == 0, r.stderr
    assert "clean" in r.stdout
