"""The distributed store's protocol battery (``src/repro/core/
dist_selftest.py``'s, lines 27-222), written once against an ``env`` so
that the JAX package and the port replay the very same calls
(``tests/test_torch_dist_selftest.py``).

The same steps, data and assertions as the self-test, at G = 8: the raw
ops (routed PUT / GET with payloads, misses, padding lanes, SCAN, DELETE
-> miss -> SCAN excludes, index server 2 failed: degraded GET and PUT,
scans under failure, ``recover_server``, ``parity_report``), then the
client half (overflow retries, DELETE, server 1 failed and recovered,
reduced replication), then R = 3's scan duty.  The env has:

  G                        8
  scaled(**kw)             the package's HiStoreConfig
  kv                       the package's kvstore module
  create(cap, cfg)         kv.create over the G groups
  make_ops(cfg, capacity_q, scan_limit)
  make_client(cfg, cap, capacity_q, scan_limit, **client_kw)
  arr(a)                   a numpy array as the package's array
  own(keys)                the owner group of each key, as numpy
  directory_levels(cap, fanout)
  hash_fill(store, g)      group g's hash fill counts, as numpy

``run(env)`` returns (record, stores): ``record`` maps a step's name to
the numpy outputs of its op (JSON data for the client's answers), and
``stores`` the final stores of the raw ops and of both clients.  Nothing
here imports JAX or PyTorch.
"""
from __future__ import annotations

import json
import warnings

import numpy as np

from _answers import _digest, host, plain


def leaves(tree, prefix, out, path=""):
    """The numpy leaves of a store (either package's), by dotted path."""
    if hasattr(tree, "_fields"):
        for f in tree._fields:
            leaves(getattr(tree, f), prefix, out,
                   f"{path}.{f}" if path else f)
    else:
        out[f"{prefix}/leaf/{path}"] = host(tree)


def run(env):
    rec = {}

    def keep(name, *xs):
        outs = [host(x) for x in xs]
        for i, x in enumerate(outs):
            rec[f"{name}/{i}"] = x
        return outs

    def answer(name, r):
        rec[name] = np.array(json.dumps(_digest(name.split("/")[-1]
                                                .split("#")[0], r)))
        return r

    G = env.G
    cfg = env.scaled(log_capacity=512, async_apply_batch=128)
    store = env.create(4096, cfg)
    ops = env.make_ops(cfg, capacity_q=64, scan_limit=128)

    rng = np.random.RandomState(0)
    Q = 32 * G
    keys = (rng.choice(10 ** 6, Q, replace=False) + 1).astype(np.int32)
    vals = np.tile(np.arange(Q, dtype=np.int32)[:, None],
                   (1, cfg.value_words))
    all_valid = np.ones((Q,), bool)
    A = env.arr

    # --- PUT roundtrip -------------------------------------------------------
    store, *out = ops["put"](store, A(keys), A(vals), A(all_valid))
    ok, _, nrep = keep("put", *out)
    assert ok.all(), "put ok"
    assert (nrep == cfg.n_backups).all(), \
        "healthy puts must reach every replica log"
    # --- GET hits with value payloads ----------------------------------------
    _, found, acc, val, routed, vok = keep(
        "get", *ops["get"](store, A(keys), A(all_valid)))
    assert routed.all(), "get routed"
    assert found.all(), "get found"
    assert vok.all(), "healthy values are owner-local"
    np.testing.assert_array_equal(val[:, 0], np.arange(Q))
    assert int(acc.max()) <= cfg.max_chain, "one-sided accesses"
    # --- GET misses ----------------------------------------------------------
    found_m = keep("get_miss", *ops["get"](store, A(keys + 10 ** 7),
                                           A(all_valid)))[1]
    assert not found_m.any(), "get miss"
    # --- valid-mask padding lanes mutate nothing -----------------------------
    half = np.arange(Q) < Q // 2
    pad_keys = np.where(half, keys + 3 * 10 ** 7, keys).astype(np.int32)
    store, *out = ops["put"](store, A(pad_keys), A(vals), A(half))
    ok_h = keep("put_masked", *out)[0]
    assert ok_h[: Q // 2].all(), "masked put ok"
    found_h = keep("get_masked", *ops["get"](store, A(keys + 3 * 10 ** 7),
                                             A(all_valid)))[1]
    assert not found_h[Q // 2:].any(), "invalid lanes must not be written"
    # --- SCAN (drains logs) --------------------------------------------------
    lo = A(np.zeros((G,), np.int32))
    hi = A(np.full((G,), 10 ** 7, np.int32))
    *out, store = ops["scan"](store, lo, hi)
    sk, _, cov = keep("scan", *out)
    np.testing.assert_array_equal(sk, np.sort(keys)[:128])
    assert cov.all(), "healthy scan must cover all groups"

    # --- distributed DELETE round-trip ---------------------------------------
    del_mask = np.arange(Q) < G        # drop one key per device's worth
    store, *out = ops["delete"](store, A(keys), A(del_mask))
    ok_d, found_d, _ = keep("delete", *out)
    assert ok_d[:G].all(), "delete acked"
    assert found_d[:G].all(), "delete found"
    fa = keep("get_after_delete", *ops["get"](store, A(keys),
                                              A(all_valid)))[1]
    assert not fa[:G].any(), "deleted keys must miss"
    assert fa[G:].all(), "surviving keys must hit"
    *out, store = ops["scan"](store, lo, hi)
    sk2 = keep("scan_after_delete", *out)[0]
    assert not (set(sk2.tolist()) & set(keys[:G].tolist())), \
        "scan must exclude deleted keys"

    # --- failure: server 2 down (index state WIPED, must rebuild) ------------
    store = env.kv.fail_server(store, 2)
    assert int(env.hash_fill(store, 2).sum()) == 0, "dead hash must be wiped"
    _, found2, acc2, *_ = keep(
        "get_degraded", *ops["get"](store, A(keys[G:]), A(all_valid[G:])))
    assert found2.all(), "degraded get found"
    # degraded lookups of group-2 keys go through the sorted replica + its
    # pending log: directory depth + 1 accesses, above the healthy groups'
    degraded_cost = env.directory_levels(4096, cfg.fanout) + 1
    own = env.own(keys[G:])
    assert int(acc2[own == 2].min()) == degraded_cost, \
        "degraded reads must pay the sorted+log path"
    assert int(acc2[own != 2].max()) < degraded_cost, \
        "healthy reads must stay on the one-sided hash path"
    # --- degraded PUT (temporary primary) ------------------------------------
    nk = (rng.choice(10 ** 6, 64, replace=False) + 2 * 10 ** 7).astype(
        np.int32)
    nv = np.tile(np.arange(64, dtype=np.int32)[:, None],
                 (1, cfg.value_words))
    nvalid = np.ones((64,), bool)
    store, *out = ops["put"](store, A(nk), A(nv), A(nvalid))
    ok3, _, nrep3 = keep("put_degraded", *out)
    assert ok3.all(), "degraded put ok"
    own3 = env.own(nk)
    hit = np.isin(own3, [0, 1])   # dev 2 holds replica 1 of g0, 0 of g1
    assert (nrep3[hit] == cfg.n_backups - 1).all(), \
        "writes touching the dead holder must report reduced replication"
    assert (nrep3[own3 == 2] == cfg.n_backups).all(), \
        "temporary primary still reaches both surviving replica logs"
    assert (nrep3[~hit & (own3 != 2)] == cfg.n_backups).all(), \
        "unaffected groups keep full replication"
    found3 = keep("get_degraded_put", *ops["get"](store, A(nk),
                                                  A(nvalid)))[1]
    assert found3.all(), "degraded put visible to get"
    # --- scans still complete under failure ----------------------------------
    *out, store = ops["scan"](store, lo, hi)
    sk3, _, cov3 = keep("scan_degraded", *out)
    np.testing.assert_array_equal(sk3, sk2)
    assert cov3.all(), \
        "a single failure leaves every group >= 1 live holder: covered"
    # --- recovery: rebuild hash from replica, re-clone replicas --------------
    store = env.kv.recover_server(store, 2, cfg)
    assert int(env.hash_fill(store, 2).sum()) > 0, \
        "recovery must rebuild hash"
    found4 = keep("get_recovered", *ops["get"](store, A(keys[G:]),
                                               A(all_valid[G:])))[1]
    assert found4.all(), "post-recovery get"
    report = env.kv.parity_report(store, cfg)
    rec["parity"] = np.array(json.dumps(plain(report)))
    assert all(p["agree"] for p in report), \
        "hash/sorted parity must hold after recovery"

    # -------------------------------------------------------------------------
    # The same protocol through the unified client (what callers use)
    # -------------------------------------------------------------------------
    client = env.make_client(cfg, 4096, capacity_q=2, scan_limit=128,
                             batch_quantum=8 * G, max_retries=32)
    ck = rng.choice(10 ** 6, 300, replace=False) + 4 * 10 ** 7
    res = answer("client/put", client.put(ck, np.arange(300)))
    # capacity_q=2 with ~5 requests per pair forces exchange overflow ->
    # client-side retry rounds
    assert res.all_ok, "client put all acked under overflow"
    assert res.retries > 0, "overflow must have engaged the retry loop"
    g = answer("client/get", client.get(ck))
    assert g.all_found, "client get"
    np.testing.assert_array_equal(host(g.values)[:, 0], np.arange(300))
    d = answer("client/delete", client.delete(ck[:50]))
    assert bool(host(d.ok).all()) and bool(host(d.found).all()), \
        "client delete"
    g2 = answer("client/get#2", client.get(ck[:50]))
    assert not host(g2.found).any(), "client get-after-delete miss"
    s = answer("client/scan", client.scan(4 * 10 ** 7, 10 ** 8))
    got = set(host(s.keys)[: int(host(s.count))].tolist())
    assert not (got & set(int(k) for k in ck[:50])), "client scan excludes"
    client.fail_server(1)
    g3 = answer("client/get#3", client.get(ck[50:]))
    assert g3.all_found, "client degraded get"
    np.testing.assert_array_equal(host(g3.values)[:, 0], np.arange(300)[50:],
                                  "degraded reads fetch values by address")
    # writes during the failure: reduced replication is reported honestly
    wk = rng.choice(10 ** 6, 200, replace=False) + 6 * 10 ** 7
    w = answer("client/put#2", client.put(wk, np.arange(200)))
    assert w.all_ok
    wown = env.own(wk)
    wrep = host(w.replicas)
    whit = np.isin(wown, [7, 0])  # dev 1 holds replica 0 of g0, 1 of g7
    assert (wrep[whit] == cfg.n_backups - 1).all(), "reduced replication"
    assert (wrep[~whit & (wown != 1)] == cfg.n_backups).all()
    client.recover_server(1)
    g4 = answer("client/get#4", client.get(np.concatenate([ck[50:], wk])))
    assert g4.all_found, "post-recovery client get"
    np.testing.assert_array_equal(
        host(g4.values)[:, 0],
        np.concatenate([np.arange(300)[50:], np.arange(200)]))
    report = env.kv.parity_report(client.backend.store, cfg)
    rec["client/parity"] = np.array(json.dumps(plain(report)))
    assert all(p["agree"] for p in report), \
        "client-side recovery must restore parity"
    rec["client/stats"] = np.array(json.dumps(client.stats))

    # --- R=3 scan serve-duty: alive-dead-alive must not double-serve ---------
    cfg3 = env.scaled(log_capacity=512, async_apply_batch=128, n_backups=3,
                      lease_clock="rounds")
    client3 = env.make_client(cfg3, 512, capacity_q=64, scan_limit=512,
                              batch_quantum=4 * G)
    k3 = np.random.RandomState(3).choice(10 ** 6, 12 * G,
                                         replace=False) + 1
    assert answer("r3/put", client3.put(k3, np.arange(12 * G))).all_ok
    client3.drain()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        client3.sever_server(3)      # middle holder of group 1 (2, 3, 4)
    s3 = answer("r3/scan", client3.scan(0, 10 ** 7, limit=512))
    ks3 = host(s3.keys)[: int(host(s3.count))]
    assert len(set(ks3.tolist())) == len(ks3), \
        "R=3 alive-dead-alive scan emitted duplicate keys"
    assert int(host(s3.count)) == 12 * G, \
        f"R=3 scan count {int(host(s3.count))} != {12 * G}"
    assert s3.complete is True, "one live holder per group -> complete"
    return rec, {"ops": store, "client": client.backend.store,
                 "r3": client3.backend.store}
