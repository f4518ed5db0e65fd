"""The JAX package's side of tests/test_torch_dist_keys64.py: its
DistributedBackend under ``jax_enable_x64`` (int64 keys) on 8 host
devices, in a process of its own because x64 is a process-wide switch:

    JAX_ENABLE_X64=1 JAX_PLATFORMS=cpu \\
        XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        PYTHONPATH=src:tests python tests/_dist_keys64_jax.py OUT.npz

The mesh has ``AxisType.Auto`` axes (jax 0.9's default Explicit axes make
``kv.create`` fail).  It writes every answer and store it reaches to
OUT.npz, so that the test holds the port to them in its own process
without enabling x64 there.  The events come from numpy seeds through the
functions below, which import no JAX, and the traces from
``tests/oracle.py``'s ``gen_ops`` over [1, 2**62].
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

import _keys64_jax as K  # noqa: E402  (imports no JAX)
from _answers import _digest, host, plain  # noqa: E402
from _dist_battery import leaves  # noqa: E402  (imports no JAX)

G = 8
DCAP = 512
N_EVENTS, BATCH, QUANTUM = 14, 32, 16
# (mix, seed, capacity_q, log_capacity, async_apply_batch): case 1's small
# exchange capacity and logs force push-back, retries and drains
CASES = (("uniform", 41, 64, 1 << 10, 256),
         ("delete_heavy", 42, 4, 64, 16))
FAULT_SEED = 43
FAILED, DATA_FAILED = 3, 5
LIMIT = 64                      # the ops' SCAN width
# the SCAN bounds of the stacked range, [G] each: (lo, hi) a set
BOUND_SETS = ((0, K.INT64_MAX - 1), (2 ** 31, 2 ** 33), (2 ** 62, K.INT64_MAX),
              (-(2 ** 63), 5))
# the keys of the repaired legacy probe: int64 keys >= 2**32 and negative
# ones, which a cast to int32 used to lose
PROBE6 = [5, 2 ** 31, 2 ** 32 + 7, 2 ** 40 + 3, 2 ** 62, -1]


def cfg_kw(case):
    _, _, _, lcap, ab = CASES[case]
    return dict(use_kernels="on", lease_misses=0, log_capacity=lcap,
                async_apply_batch=ab)


def trace(case):
    """Case ``case``'s events: a ``gen_ops`` trace with a PUT of the edge
    keys at its middle (where the carry takes the store)."""
    from oracle import gen_ops

    mix, seed = CASES[case][:2]
    ev = gen_ops(seed, mix, n_events=N_EVENTS, batch=BATCH,
                 universe=K.UNIVERSE)
    edge = np.array(K.EDGE_KEYS, np.int64)
    return (ev[:N_EVENTS // 2]
            + [("put", edge, np.arange(1, len(edge) + 1) * 1009)]
            + ev[N_EVENTS // 2:])


CARRY_AT = N_EVENTS // 2 + 1     # trace(case)[:CARRY_AT] ran before the carry


def fault_events(case=0):
    """Index server FAILED fails; a degraded round of PUT (old keys and
    new), DELETE, GET and SCAN; it recovers; data server DATA_FAILED fails,
    a PUT and a GET go through, it recovers; a GET of every key written."""
    rng = np.random.default_rng(FAULT_SEED)
    tr = trace(case)
    written = np.unique(np.concatenate([e[1] for e in tr if e[0] == "put"]))
    old = rng.permutation(written)
    new = rng.integers(0, K.UNIVERSE, 48, dtype=np.int64)

    def vals(n):
        return rng.integers(1, 1 << 20, n).astype(np.int64)

    return [("fail", FAILED),
            ("put", np.concatenate([old[:16], new[:16]]), vals(32)),
            ("delete", old[16:40]),
            ("get", np.concatenate([old[:24], new[:8]])),
            ("scan", 0, K.UNIVERSE, 128),
            ("recover", FAILED),
            ("fail_data", DATA_FAILED),
            ("put", np.concatenate([old[40:56], new[16:32]]), vals(32)),
            ("get", np.concatenate([old[:16], new[16:32]])),
            ("recover_data", DATA_FAILED),
            ("get", np.concatenate([written, new]))]


def edge_get_keys():
    """The edges and what a padded lane may carry."""
    return np.array(K.EDGE_KEYS + K.PAD_KEYS, np.int64)


def answer(kind, r):
    """An op's full answer: ``_answers._digest`` (a GET's accesses too)
    and the dtype of every array field of its result."""
    d = _digest(kind, r)
    if kind == "get":
        d.append(host(r.accesses).tolist())
    return d + [{f: str(host(x).dtype) for f, x in zip(r._fields, r)
                 if hasattr(x, "dtype")}]


def drive(c, events, hook=None):
    """Each event's answer (``answer``; a fault event its marker).
    ``hook(c, event)`` runs after each fault event."""
    out = []
    for ev in events:
        kind = ev[0]
        if kind in ("put", "get", "delete"):
            args = ev[1:] if kind == "put" else ev[1:2]
            out.append([kind, answer(kind, getattr(c, kind)(*args))])
        elif kind == "scan":
            out.append([kind, answer(kind, c.scan(*ev[1:]))])
        else:
            getattr(c, kind + "_server")(ev[1])
            out.append([kind, ev[1]])
            if hook is not None:
                hook(c, ev)
    return out


def observations(events, answers):
    """``oracle.replay``'s observations of the same events, from the
    answers: what the Oracle is compared on."""
    obs = []
    for ev, (kind, a) in zip(events, answers):
        if kind == "put":
            obs.append(["put", a[0]])
        elif kind == "get":
            obs.append(["get", a[0], a[2]])
        elif kind == "delete":
            obs.append(["delete", a[0], [bool(x) for x in a[1]]])
        elif kind == "scan":
            obs.append(["scan", a[0], a[1]])
        else:
            obs.append([kind, ev[1]])
    return obs


def probe_queries(written):
    """The ops' queries: written keys, edges, pads and absent keys."""
    rng = np.random.default_rng(FAULT_SEED + 1)
    return np.concatenate([written[:200], edge_get_keys(),
                           rng.integers(0, K.UNIVERSE, 40, dtype=np.int64)])


def replica_select(og, g, R):
    """rep_sel [Q, R] int32 of server g: replica r iff server g holds
    replica r of the lane's owner group (the shifted layout)."""
    return np.stack([(og == (g - r - 1) % G).astype(np.int32)
                     for r in range(R)], axis=1)


def main(out_path):
    import jax
    import jax.numpy as jnp

    assert jax.config.jax_enable_x64, "run under JAX_ENABLE_X64=1"
    assert len(jax.devices()) == G, "run with 8 host devices"
    from repro.configs.histore import scaled
    from repro.core import hash_index as hi
    from repro.core import kvstore as kv
    from repro.core.client import DistributedBackend, HiStoreClient
    from repro.core.hashing import key_dtype
    from repro.kernels import ops as kops

    assert key_dtype() == jnp.int64
    mesh = jax.make_mesh((G,), (kv.AXIS,),
                         axis_types=(jax.sharding.AxisType.Auto,))
    out, js = {}, {}

    def client(case):
        capq = CASES[case][2]
        return HiStoreClient(
            DistributedBackend(mesh, scaled(**cfg_kw(case)), DCAP,
                               capacity_q=capq, scan_limit=128),
            batch_quantum=QUANTUM, max_retries=32)

    def record_end(c, cfg, tag):
        js[f"{tag}/stats"] = dict(c.stats)
        js[f"{tag}/gauges"] = c.metrics().gauges
        leaves(c.backend.store, tag, out)
        js[f"{tag}/parity"] = kv.parity_report(c.backend.store, cfg)

    leaves(kv.create(mesh, DCAP, scaled(**cfg_kw(0))), "create", out)
    for case in range(len(CASES)):
        cfg = scaled(**cfg_kw(case))
        c = client(case)
        tr = trace(case)
        ans = drive(c, tr[:CARRY_AT])
        if case == 0:
            # the carry: the store and its host state at the middle
            st = c.backend.store
            leaves(st, "carry", out)
            js["carry/pending_bound"] = int(c.backend._pending_bound)
            # the ops on this store (its logs hold a pending window)
            written = np.unique(np.concatenate(
                [e[1] for e in tr[:CARRY_AT] if e[0] == "put"]))
            q = jnp.asarray(probe_queries(written))
            R = st.blog.tail.shape[0]
            og = np.asarray(kv.owner_group(q, G))
            out["ops/og"] = og
            for g in range(G):
                h = jax.tree.map(lambda a: a[g], st.hash)
                srt = jax.tree.map(lambda a: a[:, g], st.bsorted)
                blg = jax.tree.map(lambda a: a[:, g], st.blog)
                sel = jnp.asarray(replica_select(og, g, R))
                for i, a in enumerate(kops.group_probe(cfg, h, srt, blg, q,
                                                       sel)):
                    out[f"ops/gp/{g}/{i}"] = np.asarray(a)
                for b, (lo, hi_) in enumerate(BOUND_SETS):
                    for r in range(R):
                        s_rg = jax.tree.map(lambda a: a[r], srt)
                        res = kops.range_query(cfg, s_rg, lo + g, hi_, LIMIT)
                        for i, a in enumerate(res):
                            out[f"ops/rq/{b}/{g}/{r}/{i}"] = np.asarray(a)
            # the legacy probe (Pallas in interpret mode) on group 0's
            # hash with the six keys of PROBE6 put in beside
            k6 = jnp.asarray(np.array(PROBE6, np.int64))
            h6, ok = hi.insert(jax.tree.map(lambda a: a[0], st.hash), k6,
                               jnp.arange(len(PROBE6), dtype=jnp.int32), cfg)
            assert bool(np.asarray(ok).all())
            leaves(h6, "probe6", out)
            for i, a in enumerate(kops.hash_probe(
                    h6, jnp.concatenate([k6, q]), cfg)):
                out[f"probe6/{i}"] = np.asarray(a)
        ans += drive(c, tr[CARRY_AT:])
        js[f"{case}/answers"] = ans
        js[f"{case}/edge_get"] = answer("get", c.get(edge_get_keys()))
        js[f"{case}/scan_all"] = answer("scan", c.scan(0, K.INT64_MAX - 1,
                                                       32))
        record_end(c, cfg, str(case))
        if case == 0:
            # the failures, on the same store
            phases = []

            def hook(cl, ev):
                leaves(cl.backend.store, f"faults/{len(phases)}", out)
                phases.append(ev)

            js["faults/answers"] = drive(c, fault_events(), hook)
            c.drain()
            record_end(c, cfg, "faults")

    out["json"] = np.array(json.dumps(plain(js)))
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(sys.argv[1])
