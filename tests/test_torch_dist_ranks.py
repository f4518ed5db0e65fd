"""The distributed store over ranks on the CPU: one process a rank, gloo.

``repro_torch.core.comm.Comm`` carries the store's collectives over the W
ranks of a process group, each holding G / W of the G = 8 groups.  Its
verbs (exchange, route return, every shift the op bodies use, all_gather,
group_leaves, agree) equal the one-process verbs on random int32, int8
and bool buffers at W = 1, 2, 4 and 8, one spawn a W
(``repro_torch.launch.ranks.spawn``, each with its timeout).  On one
process the store calls no collective.  The stacked group probe's plain
version at g0 > 0 equals the matching rows of the whole stack.  The data servers' fail / sever / recover and
the ticker, once refused over ranks, answer as one process does, and
a store sharded over ranks needs its comm.
``python -m repro_torch.core.dist_selftest --ranks 2
--device cpu`` ends with DIST-SELFTEST-OK.  The battery over 8 and 4
ranks against JAX's 8-device mesh is in ``test_torch_dist_selftest.py``.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import _dist_ranks as R
from repro_torch.configs.histore import scaled
from repro_torch.core import kvstore as kv
from repro_torch.core.client import DistributedBackend
from repro_torch.kernels import ops
from repro_torch.launch import ranks

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_comm_verbs_match_one_process(world):
    stats = ranks.spawn(R.comm_verbs, world, device="cpu",
                        timeout_s=TIMEOUT_S, args=(world,))
    assert len(stats) == world
    # every rank made the same collectives
    assert all(s["calls"] == stats[0]["calls"] for s in stats)
    assert stats[0]["calls"]["all_to_all"] > 0


def test_one_process_store_calls_no_collective(monkeypatch):
    """W = 1 without a process group: the ops, a failure, a recovery and
    the parity report run with every collective made to raise."""
    import torch.distributed as dist

    def boom(*a, **k):
        raise AssertionError("a collective on the one-process path")

    for name in ("all_to_all_single", "all_gather", "broadcast",
                 "all_reduce"):
        monkeypatch.setattr(dist, name, boom)
    cfg, st, rk = R.probe_case("cpu")
    ops_ = kv.make_ops(cfg, R.G, capacity_q=32)
    st = kv.recover_server(st, 5, cfg)
    st, ok, *_ = ops_["put"](st, torch.arange(1, 65, dtype=torch.int32),
                             torch.zeros((64, cfg.value_words),
                                         dtype=torch.int32),
                             torch.ones((64,), dtype=torch.bool))
    assert bool(ok.all())
    assert all(p["agree"] for p in kv.parity_report(st, cfg))


@pytest.mark.parametrize("g0,L", [(1, 1), (2, 2), (4, 4), (3, 5)])
def test_group_probe_plain_at_g0(g0, L):
    """Servers g0 .. g0 + L - 1 probed alone (the store's G and g0 given)
    answer as the same rows of the whole stack's probe."""
    cfg, st, rk = R.probe_case("cpu")
    whole = ops.group_probe_stacked_plain(cfg, st.hash, st.bsorted, st.blog,
                                          rk)
    part = ops.group_probe_stacked_plain(cfg, *R.rows_of(st, g0, L),
                                         rk[g0:g0 + L], R.G, g0)
    assert bool(whole[4].any()), "no lane took the replica path"
    for i, (p, w) in enumerate(zip(part, whole)):
        assert p.dtype == w.dtype
        assert torch.equal(p, w[g0:g0 + L]), i
    # the stack's own G by default: g0 = 0, G = L is the old call
    own = ops.group_probe_stacked_plain(cfg, *R.rows_of(st, 0, R.G), rk)
    for p, w in zip(own, whole):
        assert torch.equal(p, w)


def test_unported_work_raises_over_ranks():
    """The work this test once found refused over ranks (the data
    servers' fail / sever / recover, the ticker) now answers on 2 ranks
    as on one process (``_dist_ranks.answered`` holds each rank's
    answers and gathered store against a one-process client's)."""
    answers = ranks.spawn(R.answered, 2, device="cpu", timeout_s=TIMEOUT_S)
    assert answers[0] == answers[1]
    fail, read, audit, moved, sever, last, lost = answers[0]
    assert fail == [3, True] and sever == [2, True]
    assert read[0] and 2 in read[1]          # shard 3 read from a mirror
    assert audit["agree"] and moved > 0      # the strays swept, then home
    assert last[0] and set(last[1]) == {1}   # home again: one hop
    assert last[3] == [2] and last[4] == []  # 2 detected, then recovered
    assert lost == [4, ["mirror 0 on device 5"], [], [4, 5]]


def test_one_process_data_plane_calls_no_collective(monkeypatch):
    """W = 1 without a process group: the data servers' fail, sever and
    recovery (the sweep and the copies from the mirrors) and the
    ticker's round run with every collective made to raise."""
    import torch.distributed as dist

    def boom(*a, **k):
        raise AssertionError("a collective on the one-process path")

    for name in ("all_to_all_single", "all_gather", "broadcast",
                 "all_reduce", "new_group"):
        monkeypatch.setattr(dist, name, boom)
    cfg, st, _ = R.probe_case("cpu")
    st = kv.recover_server(st, 5, cfg)
    for dev, kill in ((2, kv.fail_data_server), (6, kv.sever_data_server)):
        st = kv.recover_data_server(kill(st, dev), dev, cfg)
    assert all(p["agree"] for p in kv.parity_report(st, cfg))
    be = DistributedBackend(R.G, scaled(use_kernels="off"), 64,
                            device="cpu")
    be._host = be.comm.host()
    be._last_traffic_t -= 999.0
    assert be._ticker_round(False) == (True, False)
    assert be._ticker_round(True) == (False, True)


def test_sharded_store_needs_its_comm():
    """A store holding 2 of its 8 groups is a rank's part: the control
    plane refuses it without the comm, where it once took the default
    process group's."""
    cfg, st, _ = R.probe_case("cpu")
    part = kv._map_groups(st, kv.GROUP_AXES,
                          lambda x, ax: x.narrow(ax, 2, 2).clone())
    for call in (lambda: kv.fail_server(part, 1),
                 lambda: kv.parity_report(part, cfg),
                 lambda: kv.migrate_values(part, cfg)):
        with pytest.raises(ValueError, match="2 of 8 groups"):
            call()


def test_spawn_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        ranks.spawn(R.fail_on_rank_one, 2, device="cpu",
                    timeout_s=TIMEOUT_S)


def test_dist_selftest_module_over_two_ranks():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.dist_selftest", "--ranks",
         "2", "--device", "cpu", "--timeout", str(TIMEOUT_S)],
        capture_output=True, text=True, cwd=ROOT, env=env,
        timeout=TIMEOUT_S + 60)
    assert r.returncode == 0, r.stderr[-4000:]
    lines = r.stdout.splitlines()
    assert lines[-1] == "DIST-SELFTEST-OK"
    assert "client ops ok" in lines and "raw ops ok" in lines
    assert len(lines) == 6
