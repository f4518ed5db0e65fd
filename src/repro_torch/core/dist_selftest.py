"""Distributed KV-store self-test (port of ``repro/core/dist_selftest.py``):
the protocol battery on G = 8 index groups over W ranks.

    PYTHONPATH=src python -m repro_torch.core.dist_selftest [--ranks W] [--device cpu] [--key-dtype int64]
    PYTHONPATH=src torchrun --nproc-per-node W -m repro_torch.core.dist_selftest [--device cpu]

W is 1, 2, 4 or 8 (8 is the JAX package's layout, one group a device).
With ``--ranks W > 1`` the script spawns W processes (``launch/ranks.py``:
NCCL with rank r on ``cuda:r``, gloo on the CPU); under torchrun each
process joins torchrun's group; with W = 1 one process holds the 8
groups and no process group is made.  Every rank runs the same calls and
checks the same answers; rank 0 prints.  On the card unless ``--device``
names another device.  ``--key-dtype int64`` runs the battery on a store
of int64 keys, as JAX's runs under ``jax_enable_x64`` (its keys drawn at
``key_dtype()``); int32 by default.

Checks, as JAX's: routed PUT/GET roundtrip, value payload integrity,
distributed DELETE round-trip (PUT -> DELETE -> GET miss -> SCAN
excludes), SCAN after async-apply drains, degraded GET under primary
failure, degraded PUT via temporary primary, recovery and parity, then
the same protocol through HiStoreClient / DistributedBackend (overflow
push-back absorbed by the retry loop, failover and recovery, reduced
replication reported), then R = 3's SCAN serve duty.  Ends with
DIST-SELFTEST-OK.
"""
from __future__ import annotations

import argparse
import os
import sys
import warnings

import numpy as np
import torch

from repro_torch.configs.histore import scaled
from repro_torch.core import kvstore as kv
from repro_torch.core import sorted_index as six
from repro_torch.core.client import DistributedBackend, HiStoreClient
from repro_torch.core.comm import Comm
from repro_torch.launch import ranks

G = 8
KEY_DTYPES = {"int32": torch.int32, "int64": torch.int64}


def _np(t):
    return t.cpu().numpy()


def run(comm, device, say=print, key_dtype=torch.int32) -> None:
    """The battery over ``comm``'s ranks on ``device`` on a store of
    ``key_dtype`` keys; ``say`` prints a progress line."""
    cfg = scaled(log_capacity=512, async_apply_batch=128)
    KD = key_dtype
    store = kv.create(G, 4096, cfg, device, comm, KD)
    ops = kv.make_ops(cfg, G, capacity_q=64, scan_limit=128, comm=comm)

    def own_of(k):
        return _np(kv.owner_group(torch.as_tensor(k, dtype=KD,
                                                  device=device), G))

    def fill(st, g):
        return int(comm.group_leaves(st.hash, g).fill.sum())

    rng = np.random.RandomState(0)
    Q = 32 * G
    keys = torch.as_tensor(rng.choice(10 ** 6, Q, replace=False) + 1,
                           dtype=KD, device=device)
    vals = torch.arange(Q, dtype=torch.int32, device=device)[:, None].repeat(
        1, cfg.value_words)
    all_valid = torch.ones((Q,), dtype=torch.bool, device=device)

    # --- PUT roundtrip ----------------------------------------------------
    store, ok, addrs, nrep = ops["put"](store, keys, vals, all_valid)
    assert bool(ok.all()), "put ok"
    assert bool((nrep == cfg.n_backups).all()), \
        "healthy puts must reach every replica log"
    # --- GET hits with value payloads --------------------------------------
    addr, found, acc, val, routed, vok = ops["get"](store, keys, all_valid)
    assert bool(routed.all()), "get routed"
    assert bool(found.all()), "get found"
    assert bool(vok.all()), "healthy values are owner-local"
    np.testing.assert_array_equal(_np(val)[:, 0], np.arange(Q))
    assert int(acc.max()) <= cfg.max_chain, "one-sided accesses"
    # --- GET misses --------------------------------------------------------
    _, found_m, _, _, _, _ = ops["get"](store, keys + 10 ** 7, all_valid)
    assert not bool(found_m.any()), "get miss"
    # --- valid-mask padding lanes mutate nothing ---------------------------
    half = torch.arange(Q, device=device) < Q // 2
    pad_keys = torch.where(half, keys + 3 * 10 ** 7, keys)
    store, ok_h, _, _ = ops["put"](store, pad_keys, vals, half)
    assert bool(ok_h[: Q // 2].all()), "masked put ok"
    _, found_h, _, _, _, _ = ops["get"](store, keys + 3 * 10 ** 7, all_valid)
    assert not bool(found_h[Q // 2:].any()), \
        "invalid lanes must not be written"
    # --- SCAN (drains logs) -------------------------------------------------
    lo = torch.full((Q,), 0, dtype=KD, device=device)
    hi = torch.full((Q,), 10 ** 7, dtype=KD, device=device)
    sk, sa, cov, store = ops["scan"](store, lo, hi)
    np.testing.assert_array_equal(_np(sk), np.sort(_np(keys))[:128])
    assert bool(cov.all()), "healthy scan must cover all groups"
    say("scan ok")

    # --- distributed DELETE round-trip --------------------------------------
    del_mask = torch.arange(Q, device=device) < G  # one key a group's worth
    store, ok_d, found_d, _ = ops["delete"](store, keys, del_mask)
    assert bool(ok_d[:G].all()), "delete acked"
    assert bool(found_d[:G].all()), "delete found"
    _, found_after, _, _, _, _ = ops["get"](store, keys, all_valid)
    fa = _np(found_after)
    assert not fa[:G].any(), "deleted keys must miss"
    assert fa[G:].all(), "surviving keys must hit"
    sk2, _, _, store = ops["scan"](store, lo, hi)
    deleted = set(_np(keys[:G]).tolist())
    assert not (set(_np(sk2).tolist()) & deleted), \
        "scan must exclude deleted keys"
    say("delete ok")

    # --- failure: server 2 down (index state WIPED: must rebuild) ----------
    store = kv.fail_server(store, 2, comm=comm)
    assert fill(store, 2) == 0, "dead hash must be wiped"
    addr2, found2, acc2, _, _, _ = ops["get"](store, keys[G:],
                                              all_valid[G:])
    assert bool(found2.all()), "degraded get found"
    # degraded lookups of group-2 keys go through the sorted replica + its
    # pending log: their access count is exactly the directory depth + 1,
    # strictly above the single-sub-bucket hash read of healthy groups
    degraded_cost = six.directory_levels(4096, cfg.fanout) + 1
    own = own_of(keys[G:])
    acc2 = _np(acc2)
    assert int(acc2[own == 2].min()) == degraded_cost, \
        "degraded reads must pay the sorted+log path"
    assert int(acc2[own != 2].max()) < degraded_cost, \
        "healthy reads must stay on the one-sided hash path"
    # --- degraded PUT (temporary primary) ----------------------------------
    nk = torch.as_tensor(rng.choice(10 ** 6, 64, replace=False) + 2 * 10 ** 7,
                         dtype=KD, device=device)
    nv = torch.arange(64, dtype=torch.int32, device=device)[:, None].repeat(
        1, cfg.value_words)
    nvalid = torch.ones((64,), dtype=torch.bool, device=device)
    store, ok3, _, nrep3 = ops["put"](store, nk, nv, nvalid)
    assert bool(ok3.all()), "degraded put ok"
    # groups whose replica holder (or temporary primary chain) includes the
    # dead device report honestly-reduced replication
    own3 = own_of(nk)
    nrep3 = _np(nrep3)
    hit = np.isin(own3, [0, 1])  # dev 2 holds replica 1 of g0, 0 of g1
    assert (nrep3[hit] == cfg.n_backups - 1).all(), \
        "writes touching the dead holder must report reduced replication"
    assert (nrep3[own3 == 2] == cfg.n_backups).all(), \
        "temporary primary still reaches both surviving replica logs"
    assert (nrep3[~hit & (own3 != 2)] == cfg.n_backups).all(), \
        "unaffected groups keep full replication"
    _, found3, _, _, _, _ = ops["get"](store, nk, nvalid)
    assert bool(found3.all()), "degraded put visible to get"
    # --- scans still complete under failure ---------------------------------
    sk3, _, cov3, store = ops["scan"](store, lo, hi)
    np.testing.assert_array_equal(_np(sk3), _np(sk2))
    assert bool(cov3.all()), \
        "a single failure leaves every group >= 1 live holder: covered"
    # --- recovery: rebuild hash from replica, re-clone replicas -------------
    store = kv.recover_server(store, 2, cfg, comm=comm)
    assert fill(store, 2) > 0, "recovery must rebuild hash"
    _, found4, _, _, _, _ = ops["get"](store, keys[G:], all_valid[G:])
    assert bool(found4.all()), "post-recovery get"
    assert all(p["agree"] for p in kv.parity_report(store, cfg,
                                                    comm=comm)), \
        "hash/sorted parity must hold after recovery"
    say("raw ops ok")

    # ------------------------------------------------------------------
    # The same protocol through the unified client (what callers use)
    # ------------------------------------------------------------------
    client = HiStoreClient(
        DistributedBackend(G, cfg, 4096, capacity_q=2, scan_limit=128,
                           device=device, comm=comm, key_dtype=KD),
        batch_quantum=8 * G, max_retries=32)
    ck = rng.choice(10 ** 6, 300, replace=False) + 4 * 10 ** 7
    res = client.put(ck, np.arange(300))
    # capacity_q=2 (2 slots per sender/destination pair) with ~5 requests
    # per pair forces exchange overflow -> client-side retry rounds
    assert res.all_ok, "client put all acked under overflow"
    assert res.retries > 0, "overflow must have engaged the retry loop"
    g = client.get(ck)
    assert g.all_found, "client get"
    np.testing.assert_array_equal(_np(g.values)[:, 0], np.arange(300))
    d = client.delete(ck[:50])
    assert bool(d.ok.all()) and bool(d.found.all()), "client delete"
    g2 = client.get(ck[:50])
    assert not bool(g2.found.any()), "client get-after-delete miss"
    s = client.scan(4 * 10 ** 7, 10 ** 8)
    got = set(_np(s.keys[: int(s.count)]).tolist())
    assert not (got & set(int(k) for k in ck[:50])), "client scan excludes"
    client.fail_server(1)
    g3 = client.get(ck[50:])
    assert g3.all_found, "client degraded get"
    np.testing.assert_array_equal(_np(g3.values)[:, 0], np.arange(300)[50:],
                                  "degraded reads fetch values by address")
    # writes during the failure: reduced replication is reported honestly
    wk = rng.choice(10 ** 6, 200, replace=False) + 6 * 10 ** 7
    w = client.put(wk, np.arange(200))
    assert w.all_ok
    wown = own_of(wk)
    wrep = _np(w.replicas)
    whit = np.isin(wown, [7, 0])  # dev 1 holds replica 0 of g0, 1 of g7
    assert (wrep[whit] == cfg.n_backups - 1).all(), "reduced replication"
    assert (wrep[~whit & (wown != 1)] == cfg.n_backups).all()
    client.recover_server(1)
    g4 = client.get(np.concatenate([ck[50:], wk]))
    assert g4.all_found, "post-recovery client get"
    np.testing.assert_array_equal(
        _np(g4.values)[:, 0],
        np.concatenate([np.arange(300)[50:], np.arange(200)]))
    assert all(p["agree"] for p in kv.parity_report(
        client.backend.store, cfg, comm=comm)), \
        "client-side recovery must restore parity"
    say("client ops ok")

    # --- R=3 scan serve-duty: alive-dead-alive must not double-serve --------
    # with three sorted replicas per group, killing the MIDDLE holder
    # leaves replicas 0 and 2 alive; exactly one may serve
    cfg3 = scaled(log_capacity=512, async_apply_batch=128, n_backups=3,
                  lease_clock="rounds")
    client3 = HiStoreClient(
        DistributedBackend(G, cfg3, 512, capacity_q=64, scan_limit=512,
                           device=device, comm=comm, key_dtype=KD),
        batch_quantum=4 * G)
    k3 = np.random.RandomState(3).choice(10 ** 6, 12 * G,
                                         replace=False) + 1
    assert client3.put(k3, np.arange(12 * G)).all_ok
    client3.drain()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        client3.sever_server(3)      # middle holder of group 1 (2, 3, 4)
    s3 = client3.scan(0, 10 ** 7, limit=512)
    ks3 = _np(s3.keys)[: int(s3.count)]
    assert len(set(ks3.tolist())) == len(ks3), \
        "R=3 alive-dead-alive scan emitted duplicate keys"
    assert int(s3.count) == 12 * G, \
        f"R=3 scan count {int(s3.count)} != {12 * G}"
    assert s3.complete is True, "one live holder per group -> complete"
    say("R=3 scan serve-duty ok (no double-serve, count exact)")


def _rank_main(rank, world, device, key_dtype=torch.int32):
    run(ranks.comm(G, device), device,
        say=(lambda m: print(m, flush=True)) if rank == 0 else
        (lambda m: None), key_dtype=key_dtype)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=1,
                    help="processes, each holding 8 / W groups (1, 2, 4, 8)")
    ap.add_argument("--device", default="cuda",
                    help="torch device type (default: the card)")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds before a rank's collective or the whole "
                         "spawned run gives up")
    ap.add_argument("--key-dtype", choices=sorted(KEY_DTYPES),
                    default="int32",
                    help="the store's key width (int64: JAX's x64 store)")
    args = ap.parse_args(argv)
    kd = KEY_DTYPES[args.key_dtype]
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        import torch.distributed as dist
        rank, world, dev = ranks.init_from_env(args.device,
                                               timeout_s=args.timeout)
        _rank_main(rank, world, dev, kd)
        dist.destroy_process_group()
        if rank != 0:
            return 0
    elif args.ranks == 1:
        dev = torch.device(args.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("the self-test runs on the card by default "
                               "and CUDA is not available; pass --device "
                               "cpu")
        run(Comm.single(G), dev, key_dtype=kd)
    else:
        ranks.spawn(_rank_main, args.ranks, device=args.device,
                    timeout_s=args.timeout, args=(kd,))
    print("DIST-SELFTEST-OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
