"""The two GET probes as the distributed store calls them: the key-fed
hash probe (``ops.probe``, the kernel hashes its keys) and the stacked
group probe (``ops.group_probe_stacked``, the G servers of a GET chunk in
one call, each lane's replica selected by its key's owner group).

On the CPU the port takes the plain versions, held here against the JAX
package's Pallas kernels in interpret mode and their jnp paths, fed
``rep_sel`` from JAX's own ``owner_group``.  The CUDA kernels run only on
the card: the ``requires_cuda`` tests hold them against the plain
versions there and skip here.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.histore import scaled as jscaled
from repro.core import hash_index as jhix
from repro.core import kvstore as jkv
from repro.kernels import ops as jops
from repro_torch.core import hash_index as hix
from repro_torch.core import log as lg
from repro_torch.core import tree
from repro_torch.core.hashing import owner_group
from repro_torch.kernels import ops
from test_torch_kernels import (CFG, DUP_CUDA_CASES, INF, JCFG, _eq,
                                _hash_state, _launched, _replica_states, _t)

# (applied, tail) windows of a 64-entry ring: wrapped, empty, full, short
# and fresh; group g of a store takes windows g, g + 1, ... of this list
WINDOWS = [(50, 100), (37, 37), (10, 74), (3, 20), (0, 0), (120, 129),
           (60, 70), (200, 263)]


def _group_states(rng, G, R, cap, lcap, windows_of, n_hash=300):
    """G groups' hash tables and R replicas each, from numpy.  Returns the
    JAX per-group states [(hash, sorted [R], logs [R])], the port's
    stacked state (hash [G, ...], sorted and logs [R, G, ...]) and the
    keys of every hash and log."""
    jstates, th, ts, tl, hkeys = [], [], [], [], []
    for g in range(G):
        keys, jh, t_h = _hash_state(rng, cap=1024, n=n_hash, n_del=60)
        pool = np.unique(np.concatenate([keys[:n_hash // 2], rng.choice(
            10 ** 6, 600, replace=False).astype(np.int32), [-3, 0]]))
        js, jl, t_s, t_l = _replica_states(rng, cap, lcap, windows_of(g),
                                           pool)
        jstates.append((jh, js, jl))
        th.append(t_h)
        ts.append(t_s)
        tl.append(t_l)
        hkeys.append(np.concatenate([keys, pool]))
    stacked = (tree.stack(th),
               tree.stack([[ts[g][r] for g in range(G)] for r in range(R)]),
               tree.stack([[tl[g][r] for g in range(G)] for r in range(R)]))
    return jstates, stacked, hkeys


def _chunk(rng, hkeys, Q):
    """[G, Q] exchange buffers: each server's own keys, keys of the other
    groups, random keys, 0, negative keys, 2**31 - 2 and key_inf
    padding."""
    G = len(hkeys)
    every = np.concatenate(hkeys)
    rows = []
    for g in range(G):
        q = np.concatenate([rng.choice(hkeys[g], Q // 3),
                            rng.choice(every, Q // 3),
                            rng.integers(-10 ** 6, 2 ** 31 - 1, 8),
                            [0, -1, -2 ** 31, INF - 1]])
        q = np.concatenate([q, np.full(Q - len(q), INF)])
        rng.shuffle(q)
        rows.append(q)
    return np.stack(rows).astype(np.int32)


@pytest.mark.parametrize("G", [1, 3, 8])
@pytest.mark.parametrize("R", [1, 2])
def test_group_probe_stacked_matches_pallas(G, R):
    """The port's stacked group probe (its plain version on the CPU)
    against the JAX package's per-group ``group_probe`` for every server
    g, in interpret mode and on its jnp path, fed rep_sel from JAX's own
    ``owner_group`` as JAX's op body builds it: all six outputs equal, and
    the seventh equal to JAX's owner group."""
    lcap, cap, Q = 64, 2048, 160
    rng = np.random.default_rng(100 * G + R)
    jstates, (th, ts, tl), hkeys = _group_states(
        rng, G, R, cap, lcap,
        lambda g: [WINDOWS[(g + r) % len(WINDOWS)] for r in range(R)])
    rk = _chunk(rng, hkeys, Q)
    got = ops.group_probe_stacked(CFG, th, ts, tl, torch.as_tensor(rk))
    assert len(got) == 7 and all(t.shape == (G, Q) for t in got)
    jnp_cfg = jscaled(use_kernels="off")
    for g, (jh, js, jl) in enumerate(jstates):
        jq = jnp.asarray(rk[g])
        og = jkv.owner_group(jq, G)
        jsel = jnp.stack([((g - r - 1) % G == og).astype(jnp.int32)
                          for r in range(R)], axis=1)
        row = [t[g] for t in got]
        _eq(row[:6], jops.group_probe(JCFG, jh, js, jl, jq, jsel),
            f"stacked group_probe g={g} pallas")
        _eq(row[:6], jops.group_probe(jnp_cfg, jh, js, jl, jq, jsel),
            f"stacked group_probe g={g} jnp")
        _eq(row[6:], (og,), f"owner group g={g}")
    sel = torch.zeros((G, Q), dtype=torch.bool)
    for g in range(G):
        sel[g] = ops.replica_select(got[6][g], g, G, R).any(1)
    # the hash half and the backup half are both reached
    assert got[1].any() and not got[1].all()
    assert got[4].any() and bool((got[5][sel] > 0).all())
    assert not got[5][~sel].any()


def test_replica_select_matches_the_shifted_layout():
    """Lane i of server g selects replica r iff g holds replica r of its
    owner group: group (g - r - 1) mod G, so with R >= G one lane selects
    several replicas (the last one answers)."""
    og = torch.arange(5, dtype=torch.int32)
    for G, R in ((5, 2), (5, 7), (1, 3)):
        og_g = og % G
        for g in range(G):
            sel = ops.replica_select(og_g, g, G, R)
            for i in range(5):
                for r in range(R):
                    held = (g - r - 1) % G
                    assert int(sel[i, r]) == int(held == int(og_g[i]))


@pytest.mark.parametrize("cap", [64, 2048, 1 << 15])
def test_probe_takes_any_int32_key(cap):
    """The GET probe the kernel now hashes for itself, on keys at the
    edges of int32 (negative, 0, 2**31 - 2, 2**31 - 1) inserted and not:
    the port's routed probe (its plain version on the CPU) equals the JAX
    Pallas kernel in interpret mode, and owner_group equals JAX's."""
    rng = np.random.default_rng(cap)
    edge = np.array([-2 ** 31, -7, -1, 0, 1, INF - 1], np.int32)
    keys = np.unique(np.concatenate([edge, rng.integers(
        -2 ** 31, 2 ** 31 - 1, cap // 4)])).astype(np.int32)
    jh = jhix.create(cap, JCFG)
    jh, _ = jhix.insert(jh, jnp.asarray(keys),
                        jnp.arange(len(keys), dtype=jnp.int32), JCFG)
    th = hix.HashIndex(*[_t(a) for a in jh])
    q = np.concatenate([keys, [INF, -2, 2, INF - 2], rng.integers(
        -2 ** 31, 2 ** 31 - 1, 50)]).astype(np.int32)
    got = ops.probe(CFG, th, torch.as_tensor(q))
    _eq(got, jops.probe(JCFG, jh, jnp.asarray(q)), "probe")
    assert bool(got[1][:len(keys)].all())
    for G in (1, 3, 8):
        _eq((owner_group(torch.as_tensor(q), G),),
            (jkv.owner_group(jnp.asarray(q), G),), f"owner_group G={G}")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernels are CUDA "
                    "C++ built with nvcc and have no CPU mode")
    return torch.device("cuda")


def _table(nb, cs, device):
    return hix.HashIndex(
        torch.zeros((nb, cs), dtype=torch.int32, device=device),
        torch.zeros((nb, cs), dtype=torch.int32, device=device),
        torch.full((nb, cs), -1, dtype=torch.int32, device=device),
        torch.zeros((nb,), dtype=torch.int32, device=device))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("nb", [1, 8, 1 << 10, 1 << 21])
def test_cuda_hash_probe_takes_keys(cuda_device, nb):
    """The key-fed hash probe against hix.lookup on tables of 1 to 2**21
    buckets: a batch of inserted keys (all hits, with -2**31, -1, 0 and
    2**31 - 1 among them), one of keys never inserted (all misses), and
    the two mixed; one launch a call."""
    rng = np.random.default_rng(nb)
    cs = CFG.slots_per_bucket * CFG.max_chain
    idx = _table(nb, cs, cuda_device)
    n = min(nb * cs // 2, 200000)
    pool = np.unique(rng.integers(-2 ** 31, 2 ** 31 - 1, 2 * n + 64))
    pool = pool[~np.isin(pool, [-2 ** 31, -1, 0, INF])]
    rng.shuffle(pool)
    ins = np.concatenate([[-2 ** 31, -1, 0, INF], pool[:n]]).astype(np.int32)
    miss = pool[n:2 * n].astype(np.int32)
    kt = torch.as_tensor(ins, device=cuda_device)
    idx, ok = hix.insert(idx, kt, torch.arange(len(ins), dtype=torch.int32,
                                               device=cuda_device), CFG)
    hits = kt[ok]
    assert hits.numel() > 0
    for label, q in (("all hit", hits),
                     ("all miss", torch.as_tensor(miss, device=cuda_device)),
                     ("mixed", torch.cat([hits, torch.as_tensor(
                         miss, device=cuda_device)]))):
        got = _launched("hash_probe", lambda: ops.hash_probe_cuda(
            q, *idx, CFG.slots_per_bucket))
        want = hix.lookup(idx, q, CFG)
        _eq((got[0], got[1].bool(), got[2]), want, f"hash_probe {label}")
        _eq(ops.probe(CFG, idx, q), want, f"probe {label}")
        if label == "all hit":
            assert bool(got[1].all())
        if label == "all miss":
            assert not bool(got[1].any())
    torch.cuda.synchronize()


def _to(state, device):
    return type(state)(*[a.to(device) for a in state])


def _cuda_cases():
    """(G, R, lcap, windows of group g): G in {1, 3, 8}, R in {1, 2, 9},
    over the 64-entry windows and the rings of
    test_cuda_probes_newest_wins_across_slices_and_tiles."""
    cases = []
    for G in (1, 3, 8):
        for R in (1, 2, 9):
            cases.append((G, R, 64, lambda g, R=R: [
                WINDOWS[(g + r) % len(WINDOWS)] for r in range(R)]))
    for lcap, windows, _ in DUP_CUDA_CASES:
        for G in (1, 3):
            cases.append((G, len(windows), lcap,
                          lambda g, w=windows: list(w)))
    return cases


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", range(len(_cuda_cases())))
def test_cuda_group_probe_stacked_matches_plain(cuda_device, case):
    """The stacked group probe on the card, one launch for the G servers,
    against its plain version (the per-server loop) and against the
    per-group ``ops.group_probe`` of each server with rep_sel from
    ``replica_select``: all seven outputs equal."""
    G, R, lcap, windows_of = _cuda_cases()[case]
    rng = np.random.default_rng(case)
    cap = 1 << 14
    _, stacked, hkeys = _group_states(rng, G, R, cap, lcap, windows_of,
                                      n_hash=400)
    th, ts, tl = (_to(s, cuda_device) for s in stacked)
    for g in range(G):      # the windows' own keys, so that lanes hit them
        for r in range(R):
            keys, _, _ = lg.pending_entries_np(tree.at(tl, r, g))
            hkeys[g] = np.concatenate([hkeys[g], keys[:200]])
    rk = torch.as_tensor(_chunk(rng, hkeys, 1200), device=cuda_device)
    got = _launched("group_probe", lambda: ops.group_probe_stacked(
        CFG, th, ts, tl, rk))
    _eq(got, ops.group_probe_stacked_plain(CFG, th, ts, tl, rk),
        f"stacked group_probe G={G} R={R} lcap={lcap}")
    for g in range(G):
        sel = ops.replica_select(got[6][g], g, G, R)
        one = _launched("group_probe", lambda: ops.group_probe(
            CFG, tree.at(th, g), tuple(tree.at(ts, r, g) for r in range(R)),
            tuple(tree.at(tl, r, g) for r in range(R)), rk[g], sel))
        _eq([t[g] for t in got[:6]], one, f"per-group g={g}")
    assert bool(got[1].any()) and bool(got[4].any())
    torch.cuda.synchronize()


@pytest.mark.requires_cuda
def test_cuda_group_probe_stacked_reads_views(cuda_device):
    """The stacked call reads the store's leaves in place through their
    strides: a [G] and [R, G] slice of larger stacked state (rows not
    adjacent) answers as a copy of it does."""
    rng = np.random.default_rng(5)
    G, R = 6, 2
    _, stacked, hkeys = _group_states(rng, G, R, 4096, 64, lambda g: [
        WINDOWS[(g + r) % len(WINDOWS)] for r in range(R)])
    th, ts, tl = (_to(s, cuda_device) for s in stacked)
    vh = type(th)(*[a[1::2] for a in th])
    vs = type(ts)(*[a[:, 1::2] for a in ts])
    vl = type(tl)(*[a[:, 1::2] for a in tl])
    rk = torch.as_tensor(_chunk(rng, hkeys[1::2], 700), device=cuda_device)
    cont = [type(s)(*[a.contiguous() for a in s]) for s in (vh, vs, vl)]
    _eq(ops.group_probe_stacked(CFG, vh, vs, vl, rk),
        ops.group_probe_stacked(CFG, *cont, rk), "strided views")
    _eq(ops.group_probe_stacked(CFG, vh, vs, vl, rk),
        ops.group_probe_stacked_plain(CFG, *cont, rk), "plain")
    torch.cuda.synchronize()
