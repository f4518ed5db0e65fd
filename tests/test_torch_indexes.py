"""The port's log, sorted index, hash index, slot allocator and index
group held against the JAX modules on the same seeded inputs: exact
equality of every output and of the state they leave behind."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.histore import scaled as jscaled
from repro.core import data_plane as jdp
from repro.core import hash_index as jhix
from repro.core import index_group as jig
from repro.core import log as jlg
from repro.core import sorted_index as jsix
from repro_torch.configs.histore import scaled
from repro_torch.convert import group_from_numpy
from repro_torch.core import data_plane as tdp
from repro_torch.core import hash_index as thix
from repro_torch.core import index_group as tig
from repro_torch.core import log as tlg
from repro_torch.core import sorted_index as tsix

INF = 2 ** 31 - 1
JCFG = jscaled(use_kernels="off")
CFG = scaled(use_kernels="off")


def T(a):
    return torch.as_tensor(np.array(a))


def J(a):
    return jnp.asarray(np.asarray(a))


def same(got, want, label=""):
    if isinstance(got, tuple):
        assert len(got) == len(want), label
        for i, (x, y) in enumerate(zip(got, want)):
            same(x, y, f"{label}[{i}]")
        return
    if torch.is_tensor(got):
        got = got.numpy()
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=label)


# ---------------------------------------------------------------------------
# log
# ---------------------------------------------------------------------------
def test_log_ring_rejection_take_and_lookup():
    rng = np.random.default_rng(0)
    jl, tl = jlg.create(16), tlg.create(16, "cpu")
    for step, (q, nvalid) in enumerate([(6, 6), (8, 5), (18, 18), (4, 4)]):
        k = rng.integers(0, 20, q).astype(np.int32)
        a = rng.integers(0, 100, q).astype(np.int32)
        o = rng.choice([1, 2], q).astype(np.int8)
        v = np.arange(q) < nvalid
        jl, jok = jlg.append(jl, J(k), J(a), J(o), J(v))
        tl, tok = tlg.append(tl, T(k), T(a), T(o), T(v))
        same(tuple(tl), tuple(jl), f"append {step}")
        same(tok, jok, f"ok {step}")
        if step == 2:
            assert not bool(tok.all())            # the full ring rejected
        qk = rng.integers(0, 22, 30).astype(np.int32)
        same(tlg.pending_lookup(tl, T(qk)), jlg.pending_lookup(jl, J(qk)),
             f"pending_lookup {step}")
        same(tlg.pending_entries_np(tl), jlg.pending_entries_np(jl))
        *jout, jl = jlg.take_pending(jl, 5)
        *tout, tl = tlg.take_pending(tl, 5)
        same(tuple(tout), tuple(jout), f"take {step}")
        same(tlg.pending_count(tl), jlg.pending_count(jl))
    same(tuple(tlg.clear(tl)), tuple(jlg.clear(jl)), "clear")


# ---------------------------------------------------------------------------
# sorted index
# ---------------------------------------------------------------------------
def _sorted(rng, cap, n):
    k = rng.choice(5000, n, replace=False).astype(np.int32)
    a = rng.integers(0, 10 ** 4, n).astype(np.int32)
    js = jsix.bulk_load(jsix.create(cap), J(k), J(a))
    ts = tsix.bulk_load(tsix.create(cap, "cpu"), T(k), T(a))
    same(tuple(ts), tuple(js), "bulk_load")
    return js, ts


@pytest.mark.parametrize("cap,n,m", [(256, 0, 32), (256, 100, 50),
                                     (128, 120, 40)])
def test_sorted_merge_search_range(cap, n, m):
    rng = np.random.default_rng(cap + n)
    js, ts = _sorted(rng, cap, n)
    for rnd in range(3):
        bk = rng.integers(0, 5000, m).astype(np.int32)
        bk[: m // 3] = bk[m // 3: 2 * (m // 3)]        # duplicates
        if n:
            bk[-5:] = np.asarray(js.keys)[:5]          # present keys
        ba = rng.integers(0, 10 ** 4, m).astype(np.int32)
        bo = rng.choice([0, 1, 2], m).astype(np.int8)
        js = jsix.merge(js, J(bk), J(ba), J(bo))
        ts = tsix.merge(ts, T(bk), T(ba), T(bo))
        same(tuple(ts), tuple(js), f"merge {rnd}")
    q = np.concatenate([np.asarray(js.keys)[:20],
                        rng.integers(-3, 5100, 50)]).astype(np.int32)
    for fanout in (4, 128):
        same(tsix.search(ts, T(q), fanout), jsix.search(js, J(q), fanout),
             f"search fanout={fanout}")
    live = np.asarray(js.keys)[np.asarray(js.keys) != INF]
    first = int(live[0]) if len(live) else 0
    last = int(live[-1]) if len(live) else 0
    for lo, hi in [(-5, first), (first, last), (last, last + 10),
                   (last + 1, INF - 1), (300, 200), (0, INF - 1)]:
        for limit in (1, 7, 64):
            same(tsix.range_query(ts, torch.tensor(lo, dtype=torch.int32),
                                  torch.tensor(hi, dtype=torch.int32), limit),
                 jsix.range_query(js, jnp.int32(lo), jnp.int32(hi), limit),
                 f"range [{lo},{hi}] {limit}")
    same(tsix.items(ts), jsix.items(js), "items")
    assert tsix.directory_levels(1 << 24, 128) == 4


def test_sorted_empty_index():
    js, ts = jsix.create(64), tsix.create(64, "cpu")
    q = np.array([0, 5, INF - 1], np.int32)
    same(tsix.search(ts, T(q)), jsix.search(js, J(q)), "empty search")
    same(tsix.range_query(ts, torch.tensor(0, dtype=torch.int32),
                          torch.tensor(INF - 1, dtype=torch.int32), 8),
         jsix.range_query(js, jnp.int32(0), jnp.int32(INF - 1), 8),
         "empty range")


# ---------------------------------------------------------------------------
# hash index
# ---------------------------------------------------------------------------
def test_hash_insert_delete_lookup():
    rng = np.random.default_rng(3)
    jh = jhix.create(512, JCFG)
    th = thix.create(512, CFG, "cpu")
    same(tuple(th), tuple(jh), "create")
    universe = rng.choice(2 ** 31 - 2, 700, replace=False).astype(np.int32)
    for rnd in range(6):
        k = rng.choice(universe, 96).astype(np.int32)    # in-batch dups
        a = rng.integers(0, 10 ** 5, 96).astype(np.int32)
        v = rng.random(96) < 0.9
        jh, jok = jhix.insert(jh, J(k), J(a), JCFG, J(v))
        th, tok = thix.insert(th, T(k), T(a), CFG, T(v))
        same(tuple(th), tuple(jh), f"insert {rnd}")
        same(tok, jok, f"insert ok {rnd}")
        d = rng.choice(universe, 40).astype(np.int32)
        jh, jf = jhix.delete(jh, J(d), JCFG)
        th, tf = thix.delete(th, T(d), CFG)
        same(tuple(th), tuple(jh), f"delete {rnd}")
        same(tf, jf, f"delete found {rnd}")
        q = rng.choice(universe, 200).astype(np.int32)
        same(thix.lookup(th, T(q), CFG), jhix.lookup(jh, J(q), JCFG),
             f"lookup {rnd}")
    assert int((th.sig == thix.TOMBSTONE).sum()) > 0     # tombstones
    same(thix.valid_mask(th), jhix.valid_mask(jh))
    same(thix.n_items(th), jhix.n_items(jh))


def test_hash_chain_overflow_reports_not_ok():
    """Sixteen buckets of 32 slots, 700 keys: chains overflow and the
    rejected lanes report ok=False exactly as in JAX."""
    cfg_j = jscaled(use_kernels="off", load_factor=2.0)
    cfg_t = scaled(use_kernels="off", load_factor=2.0)
    jh, th = jhix.create(64, cfg_j), thix.create(64, cfg_t, "cpu")
    k = np.arange(1, 701, dtype=np.int32) * 7919
    a = np.arange(700, dtype=np.int32)
    jh, jok = jhix.insert(jh, J(k), J(a), cfg_j)
    th, tok = thix.insert(th, T(k), T(a), cfg_t)
    same(tuple(th), tuple(jh), "overflow state")
    same(tok, jok, "overflow ok")
    assert not bool(tok.all())


def test_dedupe():
    rng = np.random.default_rng(5)
    k = rng.integers(0, 30, 64).astype(np.int32)
    v = rng.random(64) < 0.7
    same(thix.dedupe_last(T(k)), jhix.dedupe_last(J(k)))
    same(thix.dedupe_last_valid(T(k), T(v)),
         jhix.dedupe_last_valid(J(k), J(v)))


# ---------------------------------------------------------------------------
# slot allocator (the data-plane subset LocalBackend uses)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1])
def test_alloc_free_and_spread(seed):
    rng = np.random.default_rng(seed)
    used = rng.random(64) < 0.8
    want = rng.random(32) < 0.6
    same(tdp.alloc(T(used), T(want)), jdp.alloc(J(used), J(want)), "alloc")
    slots = rng.integers(0, 70, 32).astype(np.int32)
    mask = rng.random(32) < 0.5
    same(tdp.free_slots(T(used), T(slots), T(mask)),
         jdp.free_slots(J(used), J(slots), J(mask)), "free")
    k = rng.integers(0, 10, 48).astype(np.int32)
    valid = rng.random(48) < 0.8
    win = np.asarray(jdp.winner_mask(J(k), J(valid)))
    same(tdp.winner_mask(T(k), T(valid)), win, "winner")
    addr = np.where(rng.random(48) < 0.8,
                    rng.integers(0, 100, 48), -1).astype(np.int32)
    for w in (win, rng.random(48) < 0.5):          # also several winners
        same(tdp.spread_winner_addr(T(k), T(valid), T(w), T(addr)),
             jdp.spread_winner_addr(J(k), J(valid), J(w), J(addr)),
             "spread")


# ---------------------------------------------------------------------------
# index group, healthy path
# ---------------------------------------------------------------------------
def test_index_group_put_delete_apply_scan():
    cfg_j = jscaled(use_kernels="off", log_capacity=64, async_apply_batch=16)
    cfg_t = scaled(use_kernels="off", log_capacity=64, async_apply_batch=16)
    jg = jig.create(256, cfg_j)
    tg = group_from_numpy(jig.create(256, cfg_j), "cpu")
    rng = np.random.default_rng(9)
    for rnd in range(4):
        k = rng.integers(0, 300, 24).astype(np.int32)
        a = rng.integers(0, 256, 24).astype(np.int32)
        jg, jok, jn = jig.put(jg, J(k), J(a), cfg_j,
                              backups_alive=(True, True), with_nrep=True)
        tg, tok, tn = tig.put(tg, T(k), T(a), cfg_t,
                              backups_alive=(True, True), with_nrep=True)
        same((tok, tn), (jok, jn), f"put {rnd}")
        d = rng.integers(0, 300, 8).astype(np.int32)
        jg, jf = jig.delete(jg, J(d), cfg_j, primary_alive=True)
        tg, tf = tig.delete(tg, T(d), cfg_t, primary_alive=True)
        same(tf, jf, f"delete {rnd}")
        jg, tg = jig.apply_async(jg, cfg_j), tig.apply_async(tg, cfg_t)
        q = rng.integers(0, 300, 40).astype(np.int32)
        same(tig.get(tg, T(q), cfg_t, primary_alive=True),
             jig.get(jg, J(q), cfg_j, primary_alive=True), "get")
        same(tig.owner_addr_probe(tg, T(q), cfg_t, primary_alive=True),
             jig.owner_addr_probe(jg, J(q), cfg_j, primary_alive=True))
    (jr, jg) = jig.scan(jg, jnp.int32(20), jnp.int32(250), 32, cfg_j)
    (tr, tg) = tig.scan(tg, torch.tensor(20, dtype=torch.int32),
                        torch.tensor(250, dtype=torch.int32), 32, cfg_t)
    same(tr, jr, "scan")
    same((*tg.hash, *tg.plog, tg.alive), (*jg.hash, *jg.plog, jg.alive),
         "group state")
    for f in ("sorted", "blogs"):     # R states here, stacked [R] in JAX
        for r, t in enumerate(getattr(tg, f)):
            same(tuple(t), tuple(np.asarray(x)[r] for x in getattr(jg, f)),
                 f"group state {f}[{r}]")
