"""The JAX package's side of tests/test_torch_keys64.py: its store, its
kernel dispatch and its serving engine under ``jax_enable_x64`` (int64
keys), run in a process of its own because x64 is a process-wide switch:

    JAX_ENABLE_X64=1 JAX_PLATFORMS=cpu PYTHONPATH=src \\
        python tests/_keys64_jax.py OUT.npz

It writes every input it draws and every answer and state it reaches to
OUT.npz (the model's weights to OUT.npz.params.pkl), so that the test
holds the port to them in its own process without enabling x64 there.
The inputs come from numpy seeds through the functions below, which
import no JAX, and the traces from ``tests/oracle.py``'s ``gen_ops``.
"""
from __future__ import annotations

import json
import pickle
import sys
from pathlib import Path

import numpy as np

# tests/oracle.py imports the JAX package's result types, so it is
# imported where a trace is made or replayed, not here: the card's tests
# import this module on a machine without JAX
sys.path.insert(0, str(Path(__file__).resolve().parent))

INT64_MAX = np.iinfo(np.int64).max
# application keys across the 64-bit space (the largest is key_inf - 1)
EDGE_KEYS = [0, 1, 5, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1, 2 ** 32,
             2 ** 32 + 1, 2 ** 33 | 5, 2 ** 62, INT64_MAX - 1]
# what a padded lane or a probe past the keys may carry
PAD_KEYS = [-1, -2, -(2 ** 31), -(2 ** 32) - 1, -(2 ** 63), INT64_MAX]
UNIVERSE = 2 ** 62

TRACE_KW = dict(use_kernels="on", log_capacity=1 << 10,
                async_apply_batch=256)
TRACE_CAP = 4096
QUANTUM = 16
TRACES = (("uniform", 31), ("scan_heavy", 32))
N_EVENTS = 16
FAULT_MIX, FAULT_SEED = "delete_heavy", 33
CARRY_SEED, CARRY_EVENTS, CARRY_AT = 34, 20, 10
SERVE_ARCH = "musicgen-large"
ENGINE = dict(batch_slots=3, max_len=64, page_size=8)


def fault_schedule():
    """The primary dies and is rebuilt online, then backup 0 dies and is
    re-cloned (tests/test_torch_recovery.py's schedule)."""
    return [(N_EVENTS // 4, "fail", 0), (N_EVENTS // 2, "recover", 0),
            (5 * N_EVENTS // 8, "fail", 1), (7 * N_EVENTS // 8, "recover", 1)]


def trace(mix, seed, n_events=N_EVENTS):
    from oracle import gen_ops
    return gen_ops(seed, mix, n_events=n_events, batch=16, universe=UNIVERSE)


def hash_keys(seed=0):
    """int64 keys for the hashes: the edges, the pads and 256 draws over
    the whole int64 range."""
    rng = np.random.default_rng(seed)
    return np.concatenate([
        np.array(EDGE_KEYS + PAD_KEYS, np.int64),
        rng.integers(-2 ** 63, INT64_MAX, 256, dtype=np.int64, endpoint=True)])


def group_inputs(seed=1):
    """The writes that build the ops' group, the queries, the SCAN
    bounds, the merge batch and the replica selects."""
    rng = np.random.default_rng(seed)
    keys = np.unique(np.concatenate([
        np.array(EDGE_KEYS, np.int64),
        rng.integers(0, UNIVERSE, 700, dtype=np.int64),
        # neighbours that share a low or a high word
        (rng.integers(0, 2 ** 30, 40, dtype=np.int64) << 32) | 7,
        rng.integers(0, 2 ** 30, 40, dtype=np.int64) + (5 << 32)]))
    keys = keys[rng.permutation(len(keys))][:800]
    addrs = rng.permutation(len(keys)).astype(np.int32)
    absent = rng.integers(0, UNIVERSE, 60, dtype=np.int64)
    queries = np.concatenate([keys[:300], keys[-100:], absent,
                              np.array(EDGE_KEYS + PAD_KEYS, np.int64)])
    live = np.sort(keys)
    bounds = [(0, INT64_MAX - 1), (int(live[10]), int(live[200])),
              (int(live[300]), int(live[300])), (int(live[400]) + 1, 2 ** 62),
              (2 ** 62, INT64_MAX), (INT64_MAX, INT64_MAX),
              (int(live[50]), int(live[20])), (-(2 ** 63), 5),
              (2 ** 31, 2 ** 33)]
    m = 96
    bk = np.concatenate([
        rng.choice(keys, m // 2),
        rng.integers(0, UNIVERSE, m - m // 2, dtype=np.int64)])
    bk[:8] = bk[8:16]                              # duplicate keys
    bk[16:20] = np.array(EDGE_KEYS[-4:], np.int64)
    batch = (bk, rng.integers(0, 5000, m).astype(np.int32),
             rng.choice([0, 1, 1, 2], m).astype(np.int8))
    sel = rng.integers(0, 2, (len(queries), 2)).astype(np.int32)
    return keys, addrs, queries, bounds, batch, sel


def build_group(c, keys, addrs):
    """Load the ops' store through client ``c`` (chunks of QUANTUM keys):
    keys[:600] written and applied, then keys[600:650] written, one
    apply, keys[:40] deleted and keys[650:700] written, so that the logs
    hold a pending window; the rest of ``keys`` is never written."""
    for s, e in ((0, 600), (600, 650)):
        assert bool(np.asarray(c.put(keys[s:e], addrs[s:e]).ok).all())
        c.drain() if s == 0 else c.apply()
    c.delete(keys[:40])
    assert bool(np.asarray(c.put(keys[650:700], addrs[650:700]).ok).all())


def requests(seed=0):
    """(first run, second run) of the engine: lists of (prompt, max_new);
    the second repeats two prompts (prefix hits)."""
    rng = np.random.default_rng(seed)
    first = [(rng.integers(1, 256, int(n)).tolist(), int(m))
             for n, m in zip(rng.integers(6, 21, 5), rng.integers(6, 13, 5))]
    second = [first[0], first[3], (rng.integers(1, 256, 9).tolist(), 8)]
    return first, second


def drive_engine(e, put_keys):
    """Run ``requests`` through engine ``e``; returns (stats after the
    first run, each request's tokens by rid).  ``put_keys`` collects the
    keys of every directory PUT, in order."""
    tokens = {}
    release, put = e.release, e.client.put

    def record_release(r):
        tokens[r.rid] = list(r.tokens)
        release(r)

    def record_put(keys, values=None):
        put_keys.extend(int(k) for k in np.asarray(keys).tolist())
        return put(keys, values)

    e.release = record_release
    e.client.put = record_put
    first, second = requests()
    for prompt, m in first:
        e.submit(prompt, max_new=m)
    e.run()
    stats1 = dict(e.stats)
    for prompt, m in second:
        e.submit(prompt, max_new=m)
    e.run()
    return stats1, tokens


def group_leaves(prefix, g):
    """{prefix/field: numpy array} of an IndexGroup's leaves, the replicas
    and their logs stacked along [R] as the JAX package keeps them."""
    out = {f"{prefix}/alive": np.asarray(g.alive)}
    for part in ("hash", "plog", "sorted", "blogs"):
        st = getattr(g, part)
        for f in st._fields:
            out[f"{prefix}/{part}/{f}"] = np.asarray(getattr(st, f))
    return out


def parity(g, cfg):
    """(hash items, [items of each replica], [replicas agreeing with the
    hash]) after a drain: the audit of tests/test_torch_recovery.py."""
    from repro.core import hash_index as hi
    from repro.core import index_group as ig
    from repro.core import sorted_index as si
    import jax

    g = ig.drain(g, cfg)
    n = int(hi.n_items(g.hash))
    items, agree = [], []
    for r in range(g.blogs.tail.shape[0]):
        keys, addrs, valid = si.items(jax.tree.map(lambda a: a[r], g.sorted))
        a_h, f_h, _ = hi.lookup(g.hash, keys, cfg)
        v = np.asarray(valid)
        items.append(int(v.sum()))
        agree.append(bool(np.all(np.asarray(f_h)[v])
                          and np.array_equal(np.asarray(a_h)[v],
                                             np.asarray(addrs)[v])))
    return [n, items, agree]


def main(out_path):
    import jax
    import jax.numpy as jnp

    from oracle import replay, splice_faults

    assert jax.config.jax_enable_x64, "run under JAX_ENABLE_X64=1"
    from repro.configs.histore import scaled
    from repro.configs.tiny import tiny_config
    from repro.core import hashing as hs
    from repro.core import index_group as ig
    from repro.core.client import HiStoreClient, LocalBackend
    from repro.kernels import ops as kops
    from repro.models import transformer as tr
    from repro.serving import engine as eng

    assert hs.key_dtype() == jnp.int64
    out = {}
    js = {}

    # -- the hashes ----------------------------------------------------------
    k = jnp.asarray(hash_keys())
    h1, h2 = hs.key_mix(k)
    sig, fp = hs.sig_fp_of(k)
    out.update({"hash/h1": np.asarray(h1), "hash/h2": np.asarray(h2),
                "hash/sig": np.asarray(sig), "hash/fp": np.asarray(fp),
                "hash/bucket": np.asarray(hs.bucket_of(k, 1024))})

    # -- the routed ops on an int64 group, use_kernels="on" -----------------
    cfg = scaled(**TRACE_KW)

    def client(max_batch=16384):
        return HiStoreClient(LocalBackend(TRACE_CAP, cfg),
                             batch_quantum=QUANTUM, max_batch=max_batch)

    keys, addrs, queries, bounds, (bk, ba, bo), sel = group_inputs()
    c = client(QUANTUM)
    build_group(c, keys, addrs)
    g = c.backend.group
    assert g.sorted.keys.dtype == jnp.int64
    out.update(group_leaves("ops/group", g))
    q = jnp.asarray(queries)
    srt0 = jax.tree.map(lambda a: a[0], g.sorted)
    assert kops.active_path(cfg, key_dtype=jnp.int64) == "jnp"
    res = {"probe": kops.probe(cfg, g.hash, q),
           "search": kops.search(cfg, srt0, q),
           "merge": kops.merge(cfg, srt0, jnp.asarray(bk), jnp.asarray(ba),
                               jnp.asarray(bo)),
           "backup_probe": kops.backup_probe(cfg, g.sorted, g.blogs, q,
                                             jnp.asarray(sel))}
    for i, (lo, hi) in enumerate(bounds):
        res[f"range_query/{i}"] = kops.range_query(cfg, srt0, lo, hi, 64)
    for name, outs in res.items():
        for i, a in enumerate(outs):
            out[f"ops/{name}/{i}"] = np.asarray(a)

    # -- the client's traces over a 2^62 key space ---------------------------

    for mix, seed in TRACES:
        c = client()
        js[f"trace/{mix}"] = replay(c, trace(mix, seed))
        out.update(group_leaves(f"trace/{mix}/group", c.backend.group))
        out[f"trace/{mix}/vals"] = np.asarray(c.backend.vals)
        out[f"trace/{mix}/used"] = np.asarray(c.backend.used)
        r = c.get(jnp.asarray(np.array(EDGE_KEYS, np.int64)))
        for f in ("addrs", "found", "accesses", "values", "routed", "hops"):
            out[f"trace/{mix}/get/{f}"] = np.asarray(getattr(r, f))
        s = c.scan(0, INT64_MAX - 1, 32)
        for f in ("keys", "addrs", "count"):
            out[f"trace/{mix}/scan/{f}"] = np.asarray(getattr(s, f))

    # -- failure and recovery ------------------------------------------------
    c = client()
    phases = []
    js["faults"] = replay(
        c, splice_faults(trace(FAULT_MIX, FAULT_SEED), fault_schedule()),
        phase_hook=lambda cl, ev: phases.append(
            [list(ev), parity(cl.backend.group, cfg)]))
    js["faults_parity"] = phases
    out.update(group_leaves("faults/group", c.backend.group))
    out["faults/vals"] = np.asarray(c.backend.vals)
    out["faults/used"] = np.asarray(c.backend.used)

    # -- a backend carried across mid-failure, then continued ----------------
    c = client()
    ops_ = trace("uniform", CARRY_SEED, CARRY_EVENTS)
    replay(c, ops_[:CARRY_AT])
    c.fail_server(0)
    be = c.backend
    out.update(group_leaves("carry/at", be.group))
    out["carry/at/vals"] = np.asarray(be.vals)
    out["carry/at/used"] = np.asarray(be.used)
    js["carry_pending_bound"] = int(be._pending_bound)
    js["carry"] = replay(c, ops_[CARRY_AT:])
    c.recover_server(0)
    js["carry_after"] = replay(c, ops_[:4])
    out.update(group_leaves("carry/end", be.group))
    out["carry/end/vals"] = np.asarray(be.vals)
    out["carry/end/used"] = np.asarray(be.used)

    # -- the serving engine's page directory on int64 keys -------------------
    mcfg = tiny_config(SERVE_ARCH)
    params = tr.init_params(mcfg, jax.random.PRNGKey(0))
    with open(f"{out_path}.params.pkl", "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, params), f)
    e = eng.ServingEngine(mcfg, params, **ENGINE)
    assert (eng.PAGE_BITS, eng._PREFIX_MOD) == (20, 1 << 40)
    put_keys = []
    stats1, tokens = drive_engine(e, put_keys)
    js["serve"] = dict(stats1=stats1, stats=e.stats, put_keys=put_keys,
                       tokens={str(k): v for k, v in tokens.items()},
                       free_pages=e.free_pages)
    out.update(group_leaves("serve/group", e.directory))
    out["serve/vals"] = np.asarray(e.client.backend.vals)

    out["json"] = np.array(json.dumps(js))
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(sys.argv[1])
