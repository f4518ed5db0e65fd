"""The rest of the port's kernel dispatch surface held against the JAX
package: ``ops.sort`` and the legacy wrappers ``ops.hash_probe`` /
``ops.sorted_search`` / ``ops.sort_pairs``, the torch oracles of
``repro_torch.kernels.ref``, the deprecated module shims, and the lifted
limits of the merge, the backup and group probes and the Mamba scan.

On the CPU each port call takes its plain PyTorch version; the JAX side
runs its Pallas kernels in interpret mode, as tests/test_kernels.py does.
Every integer output must be equal, the payloads of the bitonic sort's
tied keys included.  The CUDA kernels run only on the card: the tests
marked ``requires_cuda`` skip here.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.histore import scaled as jscaled
from repro.core import hash_index as jhix
from repro.core import log as jlg
from repro.core import sorted_index as jsix
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.configs.histore import scaled
from repro_torch.core import hash_index as hix
from repro_torch.core import log as lg
from repro_torch.core import sorted_index as six
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from test_torch_kernels import (CFG, INF, JCFG, _eq, _hash_state, _launched,
                                _merge_batch, _replica_states, _scan_inputs,
                                _scan_tol, _sorted_state, _t)

ROOT = Path(__file__).resolve().parents[1]


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# ---------------------------------------------------------------------------
# hash_probe: the legacy per-query probe (miss count from the row's occ)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("Q", [64, 256, 512, 300])
def test_hash_probe_matches_pallas(Q):
    """On a table with hits, tombstones and reused slots, at Q of one,
    four and eight JAX query tiles and a Q JAX pads (300 = 4 x 64 + 44):
    equal to JAX's legacy kernel, to both oracles and, since the index
    keeps occ == fill, to ``ops.probe``."""
    rng = np.random.default_rng(Q)
    keys, jh, th = _hash_state(rng)
    q = np.concatenate([rng.choice(keys, Q // 2),
                        rng.integers(0, 2 ** 31 - 1, Q - Q // 2)]
                       ).astype(np.int32)
    rng.shuffle(q)
    got = ops.hash_probe(th, torch.as_tensor(q), CFG)
    jq = jnp.asarray(q)
    _eq(got, jops.hash_probe(jh, jq, JCFG, q_block=64), "hash_probe pallas")
    b, sig, fp = jhix.descriptors(jh, jq)
    want = jref.ref_hash_probe(b, sig, fp, jh.sig, jh.fp, jh.addr,
                               slots_per_bucket=CFG.slots_per_bucket)
    _eq((got[0], got[1].to(torch.int32), got[2]), want, "hash_probe ref")
    tb, ts, tf = hix.descriptors(th, torch.as_tensor(q))
    _eq(ref.ref_hash_probe(tb, ts, tf, th.sig, th.fp, th.addr,
                           slots_per_bucket=CFG.slots_per_bucket), want,
        "torch ref_hash_probe")
    _eq(got, ops.probe(CFG, th, torch.as_tensor(q)), "ops.probe")
    assert got[1].any() and not got[1].all()


@pytest.mark.parametrize("spb,chain", [(4, 2), (8, 4), (8, 2)])
def test_hash_probe_chain_shapes_sweep(spb, chain):
    """tests/test_kernels.py's chain sweep: every key found with its
    addr, and every output equal to JAX's kernel."""
    jcfg = jscaled(slots_per_bucket=spb, max_chain=chain)
    cfg = scaled(slots_per_bucket=spb, max_chain=chain)
    keys = np.arange(1, 257, dtype=np.int32) * 31
    jh, _ = jhix.insert(jhix.create(512, jcfg), jnp.asarray(keys),
                        jnp.asarray(keys), jcfg)
    th = hix.HashIndex(*[_t(a) for a in jh])
    got = ops.hash_probe(th, torch.as_tensor(keys), cfg, q_block=128)
    _eq(got, jops.hash_probe(jh, jnp.asarray(keys), jcfg, q_block=128),
        f"hash_probe spb={spb} chain={chain}")
    assert bool(got[1].all())
    np.testing.assert_array_equal(got[0].numpy(), keys)


EDGE_KEYS = [0, -1, 2 ** 31 - 1, -2 ** 31]


def _planted_table(rng, nb, cs, n):
    """A hash table made by hand, as int32 numpy arrays (sig, fp, addr,
    fill): rows of empty slots, tombstones and other keys' signatures, then
    n distinct keys (the int32 edges among them) each planted at a random
    slot of its bucket h1 & (nb - 1), any nb; a tenth of them planted again
    later in the row with another addr (the first slot wins), a tenth behind
    a decoy with their sig and another fp.  fill is drawn apart from the
    rows, so occ != fill on most rows.  Returns (keys, table)."""
    from repro_torch.core import hashing

    keys = np.unique(np.concatenate([EDGE_KEYS, rng.integers(
        -2 ** 31, 2 ** 31, 2 * n)]).astype(np.int32))
    keys = np.concatenate([EDGE_KEYS, rng.permutation(
        np.setdiff1d(keys, EDGE_KEYS))])[:n].astype(np.int32)
    b, sg, fp = (x.numpy() for x in hashing.descriptors(_t(keys), nb))
    kind = rng.choice(3, (nb, cs), p=[0.4, 0.3, 0.3])
    sig = np.where(kind == 0, 0, np.where(
        kind == 1, -1, rng.integers(0, 2 ** 30, (nb, cs)) * 2 + 1))
    tfp = rng.integers(-2 ** 31, 2 ** 31, (nb, cs))
    addr = np.where(sig == 0, -1, rng.integers(0, 2 ** 24, (nb, cs)))
    taken = np.zeros((nb, cs), bool)
    for i in range(n):
        free = np.flatnonzero(~taken[b[i]])
        m = min(len(free), 1 + (i % 10 == 1) + (i % 10 == 2))
        if m == 0:
            continue
        slots = np.sort(rng.choice(free, m, replace=False))
        taken[b[i], slots] = True
        if i % 10 == 2 and m == 2:       # a decoy before the key
            sig[b[i], slots[0]], tfp[b[i], slots[0]] = sg[i], fp[i] ^ 1
            slots = slots[1:]
        sig[b[i], slots], tfp[b[i], slots] = sg[i], fp[i]
        addr[b[i], slots] = i * 10 + np.arange(len(slots))
    fill = rng.integers(0, cs + 1, nb)
    return keys, [x.astype(np.int32) for x in (sig, tfp, addr, fill)]


@pytest.mark.parametrize("nb,cs,S", [(64, 32, 8), (12, 6, 3), (16, 12, 4)])
def test_hash_probe_on_planted_tables_matches_pallas(nb, cs, S):
    """The keys-in route on tables made by hand (_planted_table: the int32
    edges 0, -1, 2**31 - 1 and -2**31 among the keys, duplicates, decoys
    with the key's sig and another fp, tombstones, occ != fill), at the
    DEFAULT row (cs 32), a cs that is not a multiple of 4 over a bucket
    count that is not a power of two, and cs 12: equal to JAX's legacy
    kernel in interpret mode.  addr and found equal ``ops.probe``'s; acc
    differs from it on misses whose row has occ != fill, as in JAX."""
    rng = np.random.default_rng(nb * cs)
    keys, tab = _planted_table(rng, nb, cs, nb * cs // 3)
    q = np.concatenate([keys, rng.integers(-2 ** 31, 2 ** 31, 100)]
                       ).astype(np.int32)
    rng.shuffle(q)
    cfg = scaled(use_kernels="on", slots_per_bucket=S, max_chain=cs // S)
    jcfg = jscaled(use_kernels="on", slots_per_bucket=S, max_chain=cs // S)
    th = hix.HashIndex(*[_t(a) for a in tab])
    got = ops.hash_probe(th, _t(q), cfg)
    _eq(got, jops.hash_probe(jhix.HashIndex(*[jnp.asarray(a) for a in tab]),
                             jnp.asarray(q), jcfg, q_block=64),
        f"hash_probe planted nb={nb} cs={cs}")
    want = ops.probe(cfg, th, _t(q))
    _eq(got[:2], want[:2], "hash_probe vs probe: addr and found")
    miss = ~got[1]
    assert bool(got[1].any()) and bool(miss.any())
    assert bool((got[2][miss] != want[2][miss]).any())
    assert np.isin(EDGE_KEYS[:2], q[got[1].numpy()]).all()


# ---------------------------------------------------------------------------
# sorted_search: the legacy per-level descent
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cap,n", [(256, 100), (4096, 1000), (1 << 15, 5000)])
def test_sorted_search_matches_pallas(cap, n):
    """Hits, key + 1 misses, random misses, -1, 0 and 2**31 - 1, at a Q
    JAX pads: equal to JAX's legacy kernel, both oracles and ops.search."""
    rng = np.random.default_rng(cap)
    keys, js, ts = _sorted_state(rng, cap, n)
    m = min(128, n)
    q = np.concatenate([keys[:m], keys[:m] + 1,
                        rng.integers(0, 10 ** 6, 37),
                        [-1, 0, INF, INF - 1]]).astype(np.int32)
    got = ops.sorted_search(ts, torch.as_tensor(q))
    jq = jnp.asarray(q)
    _eq(got, jops.sorted_search(js, jq, q_block=64), "sorted_search pallas")
    want = jref.ref_sorted_search(jq, js.keys, js.addrs)
    _eq((got[0], got[1].to(torch.int32), got[2]), want, "sorted_search ref")
    _eq(ref.ref_sorted_search(torch.as_tensor(q), ts.keys, ts.addrs), want,
        "torch ref_sorted_search")
    _eq(got, ops.search(CFG, ts, torch.as_tensor(q)), "ops.search")
    assert bool(got[1][:m].all())
    # 2**31 - 1 "hits" the INF padding, as in JAX; other absent keys miss
    miss = ~np.isin(q, keys) & (q != INF)
    assert not bool(got[1][torch.as_tensor(miss)].any())


# ---------------------------------------------------------------------------
# sort (stable) and sort_pairs (the bitonic network)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("R,T,hi,extremes", [
    pytest.param(6, 256, 13, False, id="6-256-13"),
    pytest.param(3, 64, 5, False, id="3-64-5"),
    pytest.param(4, 1, 9, False, id="4-1-9"),
    pytest.param(5, 128, 10 ** 6, False, id="5-128-1000000"),
    pytest.param(4, 256, 1, False, id="all-equal-keys"),
    pytest.param(3, 128, 5, True, id="int32-min-and-max-keys"),
    pytest.param(5, 1000, 13, False, id="T1000")])
def test_sort_matches_pallas(R, T, hi, extremes):
    """tests/test_kernel_dispatch.py's stability case ([6, 256], keys in
    [0, 13), distinct payloads), R = 3, T = 1, unique-ish keys, all keys
    equal, keys -2**31 and 2**31 - 1 among small ones, and T = 1000:
    equal to JAX's stable-sort kernel, its jnp path and
    ref_sort_pairs_stable.  JAX's kernel takes a power-of-two T only, so
    at T = 1000 it sorts each row padded with (2**31 - 1, payload) to
    1024 and the first 1000 columns are compared (the padding sorts
    after every real key, a real 2**31 - 1 included)."""
    rng = np.random.default_rng(R * T)
    keys = rng.integers(0, hi, (R, T)).astype(np.int32)
    if extremes:
        keys[rng.random((R, T)) < 0.3] = -2 ** 31
        keys[rng.random((R, T)) < 0.3] = 2 ** 31 - 1
    vals = np.arange(R * T, dtype=np.int32).reshape(R, T)
    got = ops.sort(CFG, torch.as_tensor(keys), torch.as_tensor(vals))
    jk, jv = jnp.asarray(keys), jnp.asarray(vals)
    if T & (T - 1):
        TP = 1 << (T - 1).bit_length()
        pk = np.pad(keys, ((0, 0), (0, TP - T)), constant_values=2 ** 31 - 1)
        pv = np.pad(vals, ((0, 0), (0, TP - T)), constant_values=-1)
        pallas = jops.sort(JCFG, jnp.asarray(pk), jnp.asarray(pv))
        _eq(got, [np.asarray(x)[:, :T] for x in pallas], "sort pallas")
    else:
        _eq(got, jops.sort(JCFG, jk, jv), "sort pallas")
    _eq(got, jops.sort(jscaled(use_kernels="off"), jk, jv), "sort jnp")
    _eq(got, jref.ref_sort_pairs_stable(jk, jv), "sort ref")
    _eq(ref.ref_sort_pairs_stable(torch.as_tensor(keys),
                                  torch.as_tensor(vals)), got,
        "torch ref_sort_pairs_stable")


@pytest.mark.parametrize("keys,vals", [
    pytest.param(np.array([[3, 1, 2, 1]], np.int16),
                 np.array([[1, 3, 2, 0]], np.int16), id="int16"),
    pytest.param(np.array([[0.5, -1.25, 2.0, 0.5, -7.0, -1.25, 3.5, 0.5],
                           [1.0, 1.0, -2.0, 8.0, -2.0, 0.25, 1.0, -9.5]],
                          np.float32),
                 np.arange(16, dtype=np.int32).reshape(2, 8), id="float32")])
def test_sort_answers_non_int32_keys_as_jax(keys, vals):
    """JAX's sort with kernels on sends only int32 keys to its kernel and
    sorts any other dtype with a stable argsort + take_along_axis, so the
    payload keeps its dtype: the port's sort under use_kernels="on" gives
    JAX's keys and payloads, dtypes included, on int16 keys and on float32
    keys with ties and negatives."""
    got = ops.sort(CFG, _t(keys), _t(vals))
    want = jops.sort(JCFG, jnp.asarray(keys), jnp.asarray(vals))
    _eq(got, want, f"sort {keys.dtype} keys")
    for x, y in zip(got, want):
        assert x.numpy().dtype == np.asarray(y).dtype


@pytest.mark.parametrize("rows,T", [(8, 64), (16, 256), (4, 1024)])
def test_sort_pairs_matches_pallas_on_ties(rows, T):
    """The bitonic network with keys in [0, 100), so most keys tie, and
    distinct payloads: the port equals JAX's bitonic_sort_kernel in
    interpret mode on keys AND payloads (the network is not stable, so
    this holds only for the same network in the same step order); the
    keys equal ref_bitonic_sort's (a stable sort), the payloads do not."""
    from repro.kernels._bitonic_sort import bitonic_sort_kernel

    rng = np.random.RandomState(rows * T)
    keys = rng.randint(0, 100, (rows, T)).astype(np.int32)
    vals = np.arange(rows * T, dtype=np.int32).reshape(rows, T)
    got = ops.sort_pairs(torch.as_tensor(keys), torch.as_tensor(vals),
                         row_block=min(rows, 8))
    jk, jv = jnp.asarray(keys), jnp.asarray(vals)
    want = bitonic_sort_kernel(jk, jv, row_block=min(rows, 8),
                               interpret=True)
    _eq(got, want, "sort_pairs vs bitonic_sort_kernel")
    _eq(got, jops.sort_pairs(jk, jv, row_block=min(rows, 8)), "sort_pairs")
    stable = jref.ref_bitonic_sort(jk, jv)
    _eq(got[:1], stable[:1], "sort_pairs keys vs ref_bitonic_sort")
    assert not np.array_equal(got[1].numpy(), np.asarray(stable[1]))
    _eq(ref.ref_bitonic_sort(torch.as_tensor(keys), torch.as_tensor(vals)),
        stable, "torch ref_bitonic_sort")


# ---------------------------------------------------------------------------
# the port raises where JAX asserts
# ---------------------------------------------------------------------------
def _bad_calls():
    k48 = np.zeros((2, 48), np.int32)          # T not a power of two
    k12 = np.zeros((12, 16), np.int32)         # 12 % min(8, 12) != 0
    fkeys = np.sort(np.random.RandomState(0).rand(64)).astype(np.float32)
    q = np.arange(4, dtype=np.int32)
    return [
        ("sort_pairs T=48",
         lambda: jops.sort_pairs(jnp.asarray(k48), jnp.asarray(k48)),
         lambda: ops.sort_pairs(_t(k48), _t(k48))),
        ("sort_pairs R=12 row_block=8",
         lambda: jops.sort_pairs(jnp.asarray(k12), jnp.asarray(k12)),
         lambda: ops.sort_pairs(_t(k12), _t(k12))),
        ("sorted_search float32 keys",
         lambda: jops.sorted_search(
             jsix.SortedIndex(jnp.asarray(fkeys), jnp.zeros(64, jnp.int32),
                              jnp.int32(64)), jnp.asarray(q)),
         lambda: ops.sorted_search(
             six.SortedIndex(_t(fkeys), torch.zeros(64, dtype=torch.int32),
                             torch.tensor(64, dtype=torch.int32)), _t(q))),
    ]


@pytest.mark.parametrize("case", range(3))
def test_legacy_calls_raise_where_jax_asserts(case):
    label, jax_call, port_call = _bad_calls()[case]
    with pytest.raises(AssertionError):
        jax_call()
    before = dict(ops.LAUNCHES)
    with pytest.raises((ValueError, TypeError)):
        port_call()
    assert ops.LAUNCHES == before, label


def test_legacy_wrappers_take_any_q_and_r():
    """JAX pads Q up to its query tile and splits R into row blocks, so
    no Q and no R that passes the asserts is refused: Q = 1 and 7, and
    sort at R = 3, 5 and 7."""
    rng = np.random.default_rng(3)
    keys, jh, th = _hash_state(rng, cap=512, n=200, n_del=20)
    skeys, js, ts = _sorted_state(rng, 512, 200)
    for Q in (1, 7):
        q = keys[:Q]
        _eq(ops.hash_probe(th, _t(q), CFG),
            jops.hash_probe(jh, jnp.asarray(q), JCFG), f"hash_probe Q={Q}")
        _eq(ops.sorted_search(ts, _t(skeys[:Q])),
            jops.sorted_search(js, jnp.asarray(skeys[:Q])),
            f"sorted_search Q={Q}")
    for R in (3, 5, 7):
        k = rng.integers(0, 4, (R, 16)).astype(np.int32)
        v = np.arange(R * 16, dtype=np.int32).reshape(R, 16)
        _eq(ops.sort(CFG, _t(k), _t(v)),
            jops.sort(JCFG, jnp.asarray(k), jnp.asarray(v)), f"sort R={R}")


# ---------------------------------------------------------------------------
# the oracles of repro_torch.kernels.ref against JAX's
# ---------------------------------------------------------------------------
def _oracle_case(name):
    """(torch call, JAX call) of one oracle on the same numpy inputs."""
    rng = np.random.default_rng(len(name))
    if name == "ref_hash_probe":
        keys, jh, th = _hash_state(rng)
        q = np.concatenate([keys[:300], rng.integers(0, 10 ** 9, 100)]
                           ).astype(np.int32)
        jb, js_, jf = jhix.descriptors(jh, jnp.asarray(q))
        tb, ts_, tf = hix.descriptors(th, _t(q))
        return (lambda: ref.ref_hash_probe(tb, ts_, tf, th.sig, th.fp,
                                           th.addr, slots_per_bucket=8),
                lambda: jref.ref_hash_probe(jb, js_, jf, jh.sig, jh.fp,
                                            jh.addr, slots_per_bucket=8))
    if name == "ref_sorted_search":
        keys, js, ts = _sorted_state(rng, 5000, 3000)
        q = np.concatenate([keys[:200], keys[:200] + 1, [-1, INF]]
                           ).astype(np.int32)
        return (lambda: ref.ref_sorted_search(_t(q), ts.keys, ts.addrs,
                                              fanout=16),
                lambda: jref.ref_sorted_search(jnp.asarray(q), js.keys,
                                               js.addrs, fanout=16))
    if name in ("ref_pending_lookup", "ref_backup_probe"):
        pool = rng.choice(10 ** 6, 3000, replace=False).astype(np.int32)
        windows = [(50, 100), (37, 37), (3, 20)]
        js, jl, ts, tl = _replica_states(rng, 4096, 64, windows, pool)
        q = np.concatenate([rng.choice(pool, 300), [INF, 0, -1]]
                           ).astype(np.int32)
        if name == "ref_pending_lookup":
            return (lambda: ref.ref_pending_lookup(
                        tl[0].keys, tl[0].addrs, tl[0].ops.to(torch.int32),
                        tl[0].applied, tl[0].tail, _t(q)),
                    lambda: jref.ref_pending_lookup(
                        jl.keys[0], jl.addrs[0], jl.ops[0].astype(jnp.int32),
                        jl.applied[0], jl.tail[0], jnp.asarray(q)))
        sel = rng.integers(0, 2, (len(q), 3)).astype(np.int32)
        tlw = torch.stack([torch.stack([x.applied, x.tail]) for x in tl])
        jlw = jnp.stack([jl.applied, jl.tail], axis=1)
        return (lambda: ref.ref_backup_probe(
                    CFG, torch.stack([s.keys for s in ts]),
                    torch.stack([s.addrs for s in ts]),
                    torch.stack([x.keys for x in tl]),
                    torch.stack([x.addrs for x in tl]),
                    torch.stack([x.ops for x in tl]).to(torch.int32), tlw,
                    _t(q), _t(sel)),
                lambda: jref.ref_backup_probe(
                    JCFG, js.keys, js.addrs, jl.keys, jl.addrs,
                    jl.ops.astype(jnp.int32), jlw, jnp.asarray(q),
                    jnp.asarray(sel)))
    if name == "ref_merge":
        keys, js, ts = _sorted_state(rng, 512, 300)
        m = 100
        bk = rng.choice(np.concatenate([keys, rng.integers(0, 10 ** 6, 50)]),
                        m).astype(np.int32)
        bk[:20] = bk[20:40]
        ba = rng.integers(0, 10 ** 5, m).astype(np.int32)
        bo = rng.choice([0, 1, 1, 2], m).astype(np.int32)
        return (lambda: ref.ref_merge(ts.keys, ts.addrs, _t(bk), _t(ba),
                                      _t(bo)),
                lambda: jref.ref_merge(js.keys, js.addrs, jnp.asarray(bk),
                                       jnp.asarray(ba), jnp.asarray(bo)))
    k = rng.integers(0, 7, (5, 64)).astype(np.int32)
    v = np.arange(5 * 64, dtype=np.int32).reshape(5, 64)
    fn = name
    return (lambda: getattr(ref, fn)(_t(k), _t(v)),
            lambda: getattr(jref, fn)(jnp.asarray(k), jnp.asarray(v)))


INT_ORACLES = ["ref_hash_probe", "ref_sorted_search", "ref_pending_lookup",
               "ref_backup_probe", "ref_merge", "ref_sort_pairs_stable",
               "ref_bitonic_sort"]


@pytest.mark.parametrize("name", INT_ORACLES)
def test_ref_oracle_matches_jax(name):
    port_call, jax_call = _oracle_case(name)
    got, want = port_call(), jax_call()
    for i, (x, y) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(_np(x).astype(np.int64),
                                      _np(y).astype(np.int64),
                                      err_msg=f"{name}: output {i}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_mamba_scan_matches_jax(dtype):
    """The sequential float32 recurrence; float32 within the JAX test's
    2e-5, bf16 within one bf16 ulp."""
    ins = _scan_inputs(np.random.RandomState(2), 2, 40, 64, 8)
    x, dt, Bs, Cs, A = ins
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jref.ref_mamba_scan(jnp.asarray(x, jd), jnp.asarray(dt),
                               jnp.asarray(Bs, jd), jnp.asarray(Cs, jd),
                               jnp.asarray(A))
    got = ref.ref_mamba_scan(_t(x).to(td), _t(dt), _t(Bs).to(td),
                             _t(Cs).to(td), _t(A))
    assert got.dtype == td
    tol = 2e-5 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=2e-5)


# ---------------------------------------------------------------------------
# the package surface and the deprecated shims
# ---------------------------------------------------------------------------
def test_kernels_package_reexports_the_dispatch_api():
    import repro.kernels as jk
    import repro_torch.kernels as tk

    for name in ("ops", "active_path", "backup_probe", "group_probe",
                 "kernels_enabled", "merge", "probe", "range_query",
                 "search", "sort"):
        assert hasattr(jk, name) and hasattr(tk, name), name
    for name in ("sort", "hash_probe", "sorted_search", "sort_pairs"):
        assert callable(getattr(jops, name)) and callable(getattr(ops, name))


@pytest.mark.parametrize("mod", ["hash_probe", "sorted_search",
                                 "bitonic_sort"])
def test_deprecated_module_shims_warn(mod):
    code = ("import warnings; "
            "warnings.simplefilter('error', DeprecationWarning); "
            f"import repro_torch.kernels.{mod}")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode != 0 and "DeprecationWarning" in r.stderr, (
        f"importing repro_torch.kernels.{mod} must warn deprecation: "
        f"{r.stderr}")


# ---------------------------------------------------------------------------
# lifted limits on the CPU: R = 9 replicas, N = 128 and float16 scans
# ---------------------------------------------------------------------------
def test_backup_and_group_probe_take_nine_replicas():
    """JAX's probes take any n_backups: at R = 9 the port's backup and
    group probes equal JAX's Pallas kernels."""
    rng = np.random.default_rng(9)
    hkeys, jh, th = _hash_state(rng, cap=1024, n=400, n_del=50)
    pool = np.unique(np.concatenate([hkeys, rng.choice(
        10 ** 6, 1000, replace=False).astype(np.int32)]))
    windows = [(50, 100), (37, 37), (10, 74), (0, 0), (3, 20), (200, 263),
               (5, 6), (60, 70), (120, 129)]
    js, jl, ts, tl = _replica_states(rng, 1024, 64, windows, pool)
    q = np.concatenate([rng.choice(pool, 200), [INF, 0, -1]]
                       ).astype(np.int32)
    sel = rng.integers(0, 2, (len(q), 9)).astype(np.int32)
    jq, jsel = jnp.asarray(q), jnp.asarray(sel)
    _eq(ops.backup_probe(CFG, ts, tl, _t(q), _t(sel)),
        jops.backup_probe(JCFG, js, jl, jq, jsel), "backup_probe R=9")
    _eq(ops.group_probe(CFG, th, ts, tl, _t(q), _t(sel)),
        jops.group_probe(JCFG, jh, js, jl, jq, jsel), "group_probe R=9")


@pytest.mark.parametrize("N,dtype", [(128, "float32"), (8, "float16")])
def test_mamba_scan_takes_what_jax_takes(N, dtype):
    """N = 128 and float16: the port's mamba_scan equals JAX's kernel in
    interpret mode (float32 within 2e-5; float16 within one float16 ulp),
    and the wrapper no longer names a state or batch limit."""
    from repro.kernels.mamba_scan import mamba_scan_kernel
    from repro_torch.kernels import mamba_scan as ms

    assert not hasattr(ms, "MAX_STATE") and torch.float16 in ms.DTYPES
    x, dt, Bs, Cs, A = _scan_inputs(np.random.RandomState(N), 1, 32, 64, N)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = mamba_scan_kernel(jnp.asarray(x, jd), jnp.asarray(dt),
                             jnp.asarray(Bs, jd), jnp.asarray(Cs, jd),
                             jnp.asarray(A), d_block=64, seq_chunk=32,
                             interpret=True)
    got = ms.mamba_scan(_t(x).to(td), _t(dt), _t(Bs).to(td), _t(Cs).to(td),
                        _t(A))
    assert got.dtype == td
    tol = 2e-5 if dtype == "float32" else 2 ** -10
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=2e-5)


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernels are CUDA "
                    "C++ built with nvcc and have no CPU mode")
    return torch.device("cuda")


def _cuda_legacy_probe_check(th, q, S, label):
    """Both entries of the legacy probe on the card against ref_hash_probe:
    the keys-in one through ops.hash_probe (one launch) and the
    descriptor-in one.  Returns the keys-in result."""
    b, s, f = hix.descriptors(th, q)
    want = ops.legacy_hash_probe_plain(b, s, f, th.sig, th.fp, th.addr,
                                       slots_per_bucket=S)
    cfg = scaled(use_kernels="on", slots_per_bucket=S)
    got = _launched("legacy_hash_probe", lambda: ops.hash_probe(th, q, cfg))
    assert got[1].dtype == torch.bool
    _eq((got[0], got[1].to(torch.int32), got[2]), want,
        f"cuda legacy hash_probe, keys in, {label}")
    _eq(_launched("legacy_hash_probe", lambda: ops.legacy_hash_probe_cuda(
        b, s, f, th.sig, th.fp, th.addr, S)), want,
        f"cuda legacy hash_probe, descriptors in, {label}")
    return got


@pytest.mark.requires_cuda
def test_cuda_legacy_probe_and_search_match_plain(cuda_device):
    """The legacy hash probe's two entries (keys in, hashed on the card,
    and descriptors in) and the legacy search kernel against their plain
    versions, and against ops.probe and ops.search, on the card: the
    probe at Q = 1, 300 and 9000 on an index's table and on a view of it
    that is not 16-byte aligned (the scalar loads), on tables made by
    hand (_planted_table) at cs 32, 6 (not a multiple of 4, over 12
    buckets) and 12, where occ != fill and the legacy acc differs from
    ops.probe's on misses, and on the index's table with tombstones past
    each row's fill."""
    rng = np.random.default_rng(21)
    keys, _, th = _hash_state(rng, cap=1 << 14, n=6000, n_del=1000)
    th = hix.HashIndex(*[a.to(cuda_device) for a in th])
    buf = torch.zeros(th.sig.numel() + 1, dtype=torch.int32,
                      device=cuda_device)
    buf[1:] = th.sig.flatten()
    th_off = th._replace(sig=buf[1:].view(th.sig.shape))
    for Q in (1, 300, 9000):
        q = torch.as_tensor(np.concatenate(
            [rng.choice(keys, Q - Q // 2), rng.integers(0, 2 ** 31 - 1,
                                                        Q // 2)]
        ).astype(np.int32), device=cuda_device)
        got = _cuda_legacy_probe_check(th, q, 8, f"Q={Q}")
        _eq(got, hix.lookup(th, q, CFG), f"cuda legacy vs lookup Q={Q}")
        _eq(_cuda_legacy_probe_check(th_off, q, 8, f"unaligned Q={Q}"), got,
            f"cuda legacy unaligned vs aligned Q={Q}")
    for nb, cs, S in ((64, 32, 8), (12, 6, 3), (16, 12, 4), (1024, 32, 8)):
        pk, tab = _planted_table(rng, nb, cs, nb * cs // 3)
        tp = hix.HashIndex(*[_t(a).to(cuda_device) for a in tab])
        for Q in (1, 300, 9000):
            q = torch.as_tensor(np.concatenate(
                [rng.choice(pk, Q - Q // 2), rng.integers(
                    -2 ** 31, 2 ** 31, Q // 2)]).astype(np.int32),
                device=cuda_device)
            _cuda_legacy_probe_check(tp, q, S, f"planted nb={nb} cs={cs} "
                                               f"Q={Q}")
    # tombstones past each row's fill: occ != fill, so the legacy acc
    # differs from ops.probe's on misses in those rows, addr and found not
    sig = th.sig.clone()
    cols = torch.arange(sig.shape[1], device=cuda_device)
    past = (cols >= th.fill[:, None]) & (cols < th.fill[:, None] + 16)
    sig[past & (torch.arange(sig.shape[0], device=cuda_device) % 2 == 0)[
        :, None]] = hix.TOMBSTONE
    tt = th._replace(sig=sig)
    q = torch.as_tensor(np.concatenate([rng.choice(keys, 4500), rng.integers(
        0, 2 ** 31 - 1, 4500)]).astype(np.int32), device=cuda_device)
    got = _cuda_legacy_probe_check(tt, q, 8, "tombstones past fill")
    want = ops.probe(CFG, tt, q)
    _eq(got[:2], want[:2], "cuda legacy vs probe past fill: addr, found")
    miss = ~got[1]
    assert bool((got[2][miss] != want[2][miss]).any())
    for cap, n in ((1, 0), (300, 137), (1 << 16, 40000)):
        skeys, _, ts = _sorted_state(rng, cap, n)
        ts = six.SortedIndex(*[a.to(cuda_device) for a in ts])
        q = torch.as_tensor(np.concatenate(
            [skeys[:3000], skeys[:3000] + 1, rng.integers(-5, 10 ** 6, 3000),
             [-1, 0, INF - 1, INF]]).astype(np.int32), device=cuda_device)
        got = _launched("legacy_sorted_search",
                        lambda: ops.sorted_search(ts, q))
        _eq((got[0], got[1].to(torch.int32), got[2]),
            ops.legacy_sorted_search_plain(q, ts.keys, ts.addrs),
            f"cuda legacy sorted_search cap={cap}")
        _eq(got, six.search(ts, q, 128), f"cuda legacy vs search cap={cap}")
    torch.cuda.synchronize()


SORT_SHAPES = [(16, 4096), (1, 16384), (1, 65536), (3, 1), (5, 1000),
               (2, 40000), (1, 1 << 17)]


@pytest.mark.requires_cuda
def test_cuda_sorts_match_plain(cuda_device):
    """Both sorts against their plain versions with keys in [0, 1024) and
    distinct payloads: rows that fit in shared memory, rows that take
    the global passes (65536 and 2**17), and for the stable sort rows
    whose T is not a power of two; then ops.sort on int64, int16 and
    float32 keys, which takes the plain version as JAX does."""
    rng = np.random.default_rng(23)
    for R, T in SORT_SHAPES:
        k = torch.as_tensor(rng.integers(0, 1024, (R, T)).astype(np.int32),
                            device=cuda_device)
        v = torch.as_tensor(rng.permutation(R * T).astype(np.int32)
                            .reshape(R, T), device=cuda_device)
        _eq(_launched("sort_stable", lambda: ops.sort(CFG, k, v)),
            ops.sort_stable_plain(k, v), f"cuda sort [{R}, {T}]")
        if T & (T - 1) == 0:
            _eq(_launched("bitonic_sort", lambda: ops.sort_pairs(k, v)),
                ops.bitonic_sort_plain(k, v), f"cuda sort_pairs [{R}, {T}]")
    # keys of another dtype take JAX's stable argsort + gather, launch
    # nothing and keep the payload's dtype
    for k2, v2 in ((k.to(torch.int64), v), (k.to(torch.int16), v.to(
            torch.int16)), (k.to(torch.float32) - 512.5, v)):
        n0 = ops.LAUNCHES["sort_stable"]
        got = ops.sort(CFG, k2, v2)
        assert ops.LAUNCHES["sort_stable"] == n0
        _eq(got, ops.sort_stable_plain(k2, v2), f"cuda sort {k2.dtype} keys")
        assert got[0].dtype == k2.dtype and got[1].dtype == v2.dtype
    torch.cuda.synchronize()


@pytest.mark.requires_cuda
def test_cuda_merge_takes_a_full_log_ring(cuda_device):
    """A 65536-entry batch (one full backup-log ring, above the old
    16384 limit) and a 20000-entry one: equal to six.merge."""
    rng = np.random.default_rng(25)
    skeys, _, ts = _sorted_state(rng, 1 << 18, 100000)
    ts = six.SortedIndex(*[a.to(cuda_device) for a in ts])
    for m in (65536, 20000):
        bk = torch.as_tensor(rng.choice(np.concatenate(
            [skeys, rng.integers(0, 10 ** 6, 30000)]), m).astype(np.int32),
            device=cuda_device)
        ba = torch.as_tensor(rng.integers(0, 10 ** 5, m).astype(np.int32),
                             device=cuda_device)
        bo = torch.as_tensor(rng.choice([0, 1, 2], m).astype(np.int8),
                             device=cuda_device)
        got = _launched("merge", lambda: ops.merge(CFG, ts, bk, ba, bo))
        _eq(got, six.merge(ts, bk, ba, bo), f"cuda merge m={m}")
    torch.cuda.synchronize()


@pytest.mark.requires_cuda
def test_cuda_sort_edges_across_tiles(cuda_device):
    """The stable sort's kernel (2048-entry tiles, then merge passes) at
    a tile's length and one either side, ragged rows over several tiles,
    R = 1000 x T = 33, all keys equal, keys -2**31 and 2**31 - 1, and a
    run of one key that crosses a tile boundary in the input (entries
    1500-2599) and in the output (around entry 4096): equal to its plain
    version."""
    rng = np.random.default_rng(29)
    cases = [(f"[{R}, {T}]", rng.integers(0, 1024, (R, T)))
             for R, T in ((1, 2047), (1, 2048), (1, 2049), (3, 4095),
                          (2, 4097), (1000, 33), (1, 6145), (1, 65537))]
    cases.append(("all equal", np.full((2, 5000), 7)))
    ext = rng.integers(-3, 3, (2, 4100))
    ext[ext == -3] = -2 ** 31
    ext[ext == 2] = 2 ** 31 - 1
    cases.append(("-2**31 and 2**31 - 1", ext))
    run = rng.integers(0, 1000, (1, 8192))
    run[0, 1500:2600] = 500
    cases.append(("run across tiles", run))
    for label, k in cases:
        k = torch.as_tensor(k.astype(np.int32), device=cuda_device)
        v = torch.as_tensor(rng.permutation(k.numel()).astype(np.int32)
                            .reshape(k.shape), device=cuda_device)
        _eq(_launched("sort_stable", lambda: ops.sort(CFG, k, v)),
            ops.sort_stable_plain(k, v), f"cuda sort {label}")
    torch.cuda.synchronize()


@pytest.mark.requires_cuda
def test_cuda_merge_edges_across_tiles(cuda_device):
    """The merge kernel (2048-entry tiles of the merged order, the batch
    through the stable sort) at caps of a tile and one either side, an
    empty, a half-full and a full index, batches of m in {1, 4096, 20000,
    65536} of every _merge_batch kind (newest wins, DELETEs only, fresh
    PUTs past cap, the index's end keys, -2**31 and 2**31 - 2); then
    runs of one key across tile boundaries: 3000 batch entries after an
    existing one, and 500 equal existing keys: equal to six.merge."""
    rng = np.random.default_rng(31)

    def check(ek, ea, n, bk, ba, bo, label):
        ts = six.SortedIndex(
            torch.as_tensor(ek, device=cuda_device),
            torch.as_tensor(ea, device=cuda_device),
            torch.tensor(n, dtype=torch.int32, device=cuda_device))
        b = [torch.as_tensor(x, device=cuda_device) for x in (bk, ba, bo)]
        got = _launched("merge", lambda: ops.merge(CFG, ts, *b))
        _eq(got, six.merge(ts, *b), f"cuda merge {label}")

    for cap in (2047, 2048, 2049):
        for n in (0, cap // 2, cap):
            keys, _, ts = _sorted_state(rng, cap, n)
            for m in (1, 4096, 20000, 65536):
                for kind in ("mixed", "all-delete", "fresh-puts", "ends",
                             "extremes"):
                    if kind == "ends" and n == 0:
                        continue
                    check(ts.keys.numpy(), ts.addrs.numpy(), n,
                          *_merge_batch(rng, keys, m, kind),
                          f"cap={cap} n={n} m={m} {kind}")
    keys, _, ts = _sorted_state(rng, 8192, 6000)
    ek, ea = ts.keys.numpy().copy(), ts.addrs.numpy()
    bk = rng.choice(keys, 4096).astype(np.int32)
    bk[:3000] = keys[1990]
    ba = rng.integers(0, 10 ** 5, 4096).astype(np.int32)
    bo = rng.choice([1, 1, 1, 2], 4096).astype(np.int8)
    check(ek, ea, 6000, bk, ba, bo, "a batch run across tiles")
    ek[1800:2300] = ek[1800]
    check(ek, ea, 6000, bk, ba, bo, "an existing run across tiles")
    torch.cuda.synchronize()


@pytest.mark.requires_cuda
def test_cuda_merge_takes_unaligned_views(cuda_device):
    """The merge kernel on index arrays that are not 16-byte aligned:
    buf[s:s + cap] views at offsets s of 1-3 entries, and row 1 of a
    stacked [2, cap] index, at odd caps a tile and more long, so the
    tiles are copied in 4-byte steps: equal to six.merge."""
    rng = np.random.default_rng(37)
    for cap, n, m, s in ((2049, 1500, 300, 1), (4097, 4097, 5000, 2),
                         (6143, 3000, 4096, 3)):
        keys, _, ts = _sorted_state(rng, cap, n)
        views = []
        for x, fill in ((ts.keys, 2 ** 31 - 1), (ts.addrs, -1)):
            buf = torch.full((cap + s,), fill, dtype=torch.int32,
                             device=cuda_device)
            buf[s:] = x.to(cuda_device)
            stack = torch.stack([buf[s:], buf[s:]])
            views.append((buf[s:], stack[1]))
        for i, label in enumerate((f"offset {s}", "stacked row 1")):
            ek, ea = views[0][i], views[1][i]
            assert ek.data_ptr() % 16 and ea.data_ptr() % 16, label
            idx = six.SortedIndex(ek, ea, torch.tensor(
                n, dtype=torch.int32, device=cuda_device))
            b = [torch.as_tensor(x, device=cuda_device)
                 for x in _merge_batch(rng, keys, m, "mixed")]
            got = _launched("merge", lambda: ops.merge(CFG, idx, *b))
            _eq(got, six.merge(idx, *b),
                f"cuda merge cap={cap} m={m} {label}")
    torch.cuda.synchronize()


@pytest.mark.requires_cuda
def test_cuda_probes_take_nine_replicas(cuda_device):
    """R = 9 replicas on a small group: the backup and group probe
    kernels against backup_probe_plain and group_probe_plain."""
    rng = np.random.default_rng(27)
    hkeys, _, th = _hash_state(rng, cap=4096, n=1500, n_del=200)
    th = hix.HashIndex(*[a.to(cuda_device) for a in th])
    pool = np.unique(np.concatenate([hkeys, rng.choice(
        10 ** 6, 5000, replace=False).astype(np.int32)]))
    windows = [(50, 100), (37, 37), (10, 74), (0, 0), (3, 20), (200, 263),
               (5, 6), (60, 70), (120, 129)]
    _, _, ts, tl = _replica_states(rng, 4096, 64, windows, pool)
    ts = tuple(six.SortedIndex(*[a.to(cuda_device) for a in s]) for s in ts)
    tl = tuple(lg.UpdateLog(*[a.to(cuda_device) for a in x]) for x in tl)
    q = torch.as_tensor(np.concatenate(
        [rng.choice(pool, 2000), [INF, 0, -1]]).astype(np.int32),
        device=cuda_device)
    sel = torch.as_tensor(rng.integers(0, 2, (q.shape[0], 9)).astype(
        np.int32), device=cuda_device)
    _eq(_launched("backup_probe",
                  lambda: ops.backup_probe(CFG, ts, tl, q, sel)),
        ops.backup_probe_plain(CFG, ts, tl, q, sel), "cuda backup_probe R=9")
    _eq(_launched("group_probe",
                  lambda: ops.group_probe(CFG, th, ts, tl, q, sel)),
        ops.group_probe_plain(CFG, th, ts, tl, q, sel), "cuda group_probe R=9")
    torch.cuda.synchronize()


@pytest.mark.requires_cuda
def test_cuda_mamba_scan_lifted_limits(cuda_device):
    """N = 128 (two 64-state tiles) in float32, bf16 and float16, float16
    at N = 16, and B = 65536 at S = 3, d_inner = 4: each against the
    plain version (float32 within 2e-5; bf16 and float16 within one ulp
    of the plain value plus 2e-5)."""
    from repro_torch.kernels import mamba_scan as ms

    rng = np.random.RandomState(29)
    for (B, S, di, N), dtypes in (
            ((2, 70, 96, 128), (torch.float32, torch.bfloat16,
                                torch.float16)),
            ((1, 40, 64, 16), (torch.float16,)),
            ((65536, 3, 4, 2), (torch.float32,))):
        x, dt, Bs, Cs, A = (torch.as_tensor(a, device=cuda_device)
                            for a in _scan_inputs(rng, B, S, di, N))
        for dtype in dtypes:
            xd, Bd, Cd = (t.to(dtype) for t in (x, Bs, Cs))
            n0 = ms.LAUNCHES["mamba_scan"]
            got = ms.mamba_scan(xd, dt, Bd, Cd, A).float()
            assert ms.LAUNCHES["mamba_scan"] == n0 + 1
            want = ms.mamba_scan_plain(xd, dt, Bd, Cd, A).float()
            assert bool(((got - want).abs() <= _scan_tol(want, dtype)).all()
                        ), (B, N, dtype)
    torch.cuda.synchronize()
