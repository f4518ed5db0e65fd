"""The port's kernel-dispatch surface (repro_torch.kernels.ops) held
against the JAX package's Pallas kernels.

On the CPU the port's ``probe`` / ``search`` / ``range_query`` / ``merge``
/ ``backup_probe`` take their plain PyTorch versions; the JAX side runs its Pallas kernels
in interpret mode (``use_kernels="on"``), as tests/test_kernel_dispatch.py
does.  Every output must be equal.  The CUDA kernels themselves run only
on the card: ``test_cuda_kernels_match_plain`` is marked
``requires_cuda`` and skips here.
"""
from __future__ import annotations

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

JCFG = jscaled(use_kernels="on")
CFG = scaled(use_kernels="on")
INF = 2 ** 31 - 1


def _eq(got, want, label):
    for i, (x, y) in enumerate(zip(got, want)):
        y = y.cpu().numpy() if torch.is_tensor(y) else np.asarray(y)
        np.testing.assert_array_equal(
            x.cpu().numpy(), y, err_msg=f"{label}: output {i} diverges")


def _t(a):
    return torch.as_tensor(np.array(a))


def _hash_state(rng, cap=2048, n=900, n_del=200):
    """A JAX hash table with hits, tombstones and reused slots, and the
    same table as torch tensors."""
    keys = rng.choice(2 ** 31 - 2, n, replace=False).astype(np.int32)
    h = jhix.create(cap, JCFG)
    h, _ = jhix.insert(h, jnp.asarray(keys),
                       jnp.arange(n, dtype=jnp.int32), JCFG)
    h, _ = jhix.delete(h, jnp.asarray(keys[:n_del]), JCFG)
    re = keys[:n_del // 2]
    h, _ = jhix.insert(h, jnp.asarray(re), jnp.asarray(
        np.arange(n_del // 2, dtype=np.int32) + 5000), JCFG)
    return keys, h, hix.HashIndex(*[_t(a) for a in h])


def _sorted_state(rng, cap, n):
    keys = np.sort(rng.choice(10 ** 6, n, replace=False)).astype(np.int32)
    s = jsix.bulk_load(jsix.create(cap), jnp.asarray(keys),
                       jnp.arange(n, dtype=jnp.int32))
    return keys, s, six.SortedIndex(*[_t(a) for a in s])


@pytest.mark.parametrize("seed", [0, 1])
def test_probe_matches_pallas(seed):
    rng = np.random.default_rng(seed)
    keys, jh, th = _hash_state(rng)
    q = np.concatenate([keys, rng.integers(0, 2 ** 31 - 1, 300),
                        [0, 2 ** 31 - 2]]).astype(np.int32)
    rng.shuffle(q)
    got = ops.probe(CFG, th, torch.as_tensor(q))
    _eq(got, jops.probe(JCFG, jh, jnp.asarray(q)), "probe")
    assert got[1].any() and not got[1].all()


@pytest.mark.parametrize("cap,n", [(1, 0), (300, 0), (300, 137),
                                   (20000, 15000)])
def test_search_and_range_match_pallas(cap, n):
    rng = np.random.default_rng(cap + n)
    keys, js, ts = _sorted_state(rng, cap, n)
    extra = [0, -5, INF - 1, INF, 10 ** 6 + 7]
    q = np.concatenate([keys[:200], rng.integers(0, 10 ** 6, 200),
                        extra]).astype(np.int32)
    _eq(ops.search(CFG, ts, torch.as_tensor(q)),
        jops.search(JCFG, js, jnp.asarray(q)), "search")
    first = int(keys[0]) if n else 5
    last = int(keys[-1]) if n else 10
    bounds = [(first - 10, first + 500), (first, last), (last - 3, last + 99),
              (last + 1, last + 50), (-1, INF - 1), (500, 400), (INF, INF)]
    for lo, hi in bounds:
        for limit in (1, 16, 128):
            got = ops.range_query(CFG, ts, torch.tensor(lo, dtype=torch.int32),
                                  torch.tensor(hi, dtype=torch.int32), limit)
            want = jops.range_query(JCFG, js, jnp.int32(lo), jnp.int32(hi),
                                    limit)
            _eq(got, want, f"range_query[{lo},{hi}] limit={limit}")


def _merge_batch(rng, keys, m, kind):
    """A log batch of m entries (keys, addrs, ops) against the index keys
    ``keys``.  mixed: in-batch duplicates (newest wins), PUTs and DELETEs
    of present and absent keys, op-0 lanes; all-delete: DELETEs only;
    fresh-puts: PUTs of distinct keys absent from the index; ends: PUTs
    and DELETEs of the index's first and last keys and their
    neighbours; extremes: mixed, with PUTs, a DELETE and an overwrite of
    keys -2**31 and 2**31 - 2."""
    n = len(keys)
    pool = np.concatenate([keys, rng.integers(0, 10 ** 6, 64)]) if n else \
        rng.integers(0, 10 ** 6, 64)
    if kind == "fresh-puts":
        bk = (10 ** 6 + rng.choice(10 ** 6, m, replace=False)).astype(
            np.int32)
    elif kind == "ends":
        bk = np.resize(np.array([keys[0], keys[-1], keys[0] - 1,
                                 keys[-1] + 1], np.int32), m)
    else:
        bk = rng.choice(pool, m).astype(np.int32)
    if kind in ("mixed", "extremes"):
        bk[: m // 4] = bk[m // 4: m // 2]              # in-batch duplicates
    ba = rng.integers(0, 10 ** 5, m).astype(np.int32)
    if kind == "all-delete":
        bo = np.full(m, 2, np.int8)
    elif kind == "fresh-puts":
        bo = np.ones(m, np.int8)
    else:
        bo = rng.choice([1, 2] if kind == "ends" else [0, 1, 1, 2],
                        m).astype(np.int8)
    if kind == "extremes":
        e = min(m, 5)
        bk[:e] = [-2 ** 31, 2 ** 31 - 2, -2 ** 31, 2 ** 31 - 2,
                  2 ** 31 - 2][:e]
        bo[:e] = [1, 1, 2, 1, 1][:e]
    return bk, ba, bo


@pytest.mark.parametrize("cap,n,m,kind", [
    pytest.param(64, 0, 16, "mixed", id="64-0-16"),
    pytest.param(512, 300, 100, "mixed", id="512-300-100"),
    pytest.param(4096, 3000, 256, "mixed", id="4096-3000-256"),
    pytest.param(300, 290, 64, "mixed", id="300-290-64"),
    pytest.param(64, 0, 32, "all-delete", id="empty-index-all-delete"),
    pytest.param(256, 256, 64, "fresh-puts", id="full-index-size-past-cap"),
    pytest.param(512, 300, 64, "ends", id="equal-keys-at-both-ends"),
    pytest.param(512, 300, 1, "ends", id="m1"),
    pytest.param(512, 300, 64, "extremes", id="int32-min-and-max-keys")])
def test_merge_matches_pallas(cap, n, m, kind):
    """Duplicate keys in the batch (newest wins), DELETEs of present and
    absent keys, op-0 lanes, a non-power-of-two batch, and an overflowing
    apply whose size counts past cap; then an empty index taking only
    DELETEs, a full index taking fresh PUTs (size > cap), batch keys
    equal to the index's first and last keys, a one-entry batch, and
    keys -2**31 and 2**31 - 2 (_merge_batch)."""
    rng = np.random.default_rng(cap + m)
    keys, js, ts = _sorted_state(rng, cap, n)
    bk, ba, bo = _merge_batch(rng, keys, m, kind)
    got = ops.merge(CFG, ts, torch.as_tensor(bk), torch.as_tensor(ba),
                    torch.as_tensor(bo))
    want = jops.merge(JCFG, js, jnp.asarray(bk), jnp.asarray(ba),
                      jnp.asarray(bo))
    _eq(got, want, "merge")
    if kind == "fresh-puts":
        assert int(got.size) == cap + m


def _replica_states(rng, cap, lcap, windows, pool, log_pool=None):
    """R sorted replicas and R logs with the given (applied, tail)
    windows, from numpy: the ring holds random keys of ``log_pool``
    (``pool`` unless given; stale entries outside the window too), the
    window PUTs and DELs.  Returns the JAX stacked states and the port's
    tuples."""
    R = len(windows)
    skeys = np.full((R, cap), INF, np.int32)
    saddrs = np.full((R, cap), -1, np.int32)
    for r in range(R):
        n = int(rng.integers(0, min(cap, len(pool)) + 1))
        ks = np.sort(rng.choice(pool, n, replace=False))
        skeys[r, :n] = ks
        saddrs[r, :n] = rng.integers(0, 10 ** 5, n)
    lkeys = rng.choice(pool if log_pool is None else log_pool,
                       (R, lcap)).astype(np.int32)
    laddrs = rng.integers(0, 10 ** 5, (R, lcap)).astype(np.int32)
    lops = rng.choice([0, 1, 1, 2], (R, lcap)).astype(np.int8)
    win = np.asarray(windows, np.int32)
    for r, (applied, tail) in enumerate(windows):
        seq = np.arange(applied, tail)
        lops[r, seq % lcap] = rng.choice([1, 1, 2], len(seq))
        if len(seq) >= 4:              # a PUT then a DEL of one key, and
            k, j = lkeys[r, seq[0] % lcap], lkeys[r, seq[1] % lcap]
            lkeys[r, seq[-2] % lcap] = k            # a DEL then a PUT
            lops[r, seq[0] % lcap], lops[r, seq[-2] % lcap] = 1, 2
            lkeys[r, seq[-1] % lcap] = j
            lops[r, seq[1] % lcap], lops[r, seq[-1] % lcap] = 2, 1
    size = (skeys != INF).sum(axis=1).astype(np.int32)
    js = jsix.SortedIndex(jnp.asarray(skeys), jnp.asarray(saddrs),
                          jnp.asarray(size))
    jl = jlg.UpdateLog(jnp.asarray(lkeys), jnp.asarray(laddrs),
                       jnp.asarray(lops), jnp.asarray(win[:, 1]),
                       jnp.asarray(win[:, 0]))
    ts = tuple(six.SortedIndex(_t(skeys[r]), _t(saddrs[r]), _t(size[r]))
               for r in range(R))
    tl = tuple(lg.UpdateLog(_t(lkeys[r]), _t(laddrs[r]), _t(lops[r]),
                            _t(win[r, 1]), _t(win[r, 0]))
               for r in range(R))
    return js, jl, ts, tl


# (applied, tail) per replica, lcap = 64: wrapped, empty, full, fresh,
# short, and a single-replica group
BACKUP_WINDOWS = [[(50, 100), (37, 37)], [(10, 74), (0, 0)],
                  [(3, 20), (200, 263)], [(5, 6)]]


@pytest.mark.parametrize("windows", BACKUP_WINDOWS)
def test_backup_probe_matches_pallas(windows):
    """The port's backup probe (its plain version on the CPU) against
    the JAX Pallas kernel in interpret mode, the JAX jnp path and
    ref.ref_backup_probe: no, one or several replicas selected per lane,
    and q = 2**31 - 1 against windows shorter than the ring."""
    lcap, cap = 64, 4096
    rng = np.random.default_rng(len(windows) * 100 + windows[0][0])
    pool = rng.choice(10 ** 6, 3000, replace=False).astype(np.int32)
    js, jl, ts, tl = _replica_states(rng, cap, lcap, windows, pool)
    R = len(windows)
    q = np.concatenate([rng.choice(pool, 300), rng.integers(0, 10 ** 6, 60),
                        [INF, INF, 0, -1, INF - 1]]).astype(np.int32)
    sel = rng.integers(0, 2, (len(q), R)).astype(np.int32)
    sel[:R + 1] = np.tril(np.ones((R + 1, R), np.int32), -1)  # none first
    sel[-5:-3] = 1                                  # INF with all selected
    got = ops.backup_probe(CFG, ts, tl, torch.as_tensor(q),
                           torch.as_tensor(sel))
    jq, jsel = jnp.asarray(q), jnp.asarray(sel)
    _eq(got, jops.backup_probe(JCFG, js, jl, jq, jsel), "backup_probe pallas")
    _eq(got, jops.backup_probe(jscaled(use_kernels="off"), js, jl, jq, jsel),
        "backup_probe jnp")
    lwin = jnp.stack([jl.applied, jl.tail], axis=1)
    want = jref.ref_backup_probe(JCFG, js.keys, js.addrs, jl.keys, jl.addrs,
                                 jl.ops.astype(jnp.int32), lwin, jq, jsel)
    _eq((got[0], got[1].to(torch.int32), got[2]), want, "backup_probe ref")
    assert got[1].any() and not got[1].all()
    assert (got[2] == 0).any() and (got[2] > 0).any()


# (lcap, (applied, tail) per replica) over logs of a few keys, each in
# the window many times: wrapped, the full ring, a ring whose size is no
# power of two, and a window longer than the ring
DUP_WINDOWS = [(64, [(50, 100), (70, 134)]), (96, [(90, 186), (5, 50)]),
               (100, [(37, 137)]), (64, [(3, 80), (0, 64), (10, 11)])]


@pytest.mark.parametrize("lcap,windows", DUP_WINDOWS)
def test_backup_probe_matches_pallas_on_duplicate_windows(lcap, windows):
    """Windows dense in duplicate keys (6 keys and 2**31 - 1 over up to
    100 log entries): each lane gets the NEWEST entry of its key (a PUT
    or a DEL) in its last selected replica's window, else that
    replica's sorted answer; the port's backup probe (its plain version
    on the CPU) equals the Pallas kernel in interpret mode, the jnp path
    and ref.ref_backup_probe."""
    rng = np.random.default_rng(lcap * 10 + len(windows))
    pool = np.array([3, 7, -1, 0, 12345, 2 ** 20], np.int32)
    js, jl, ts, tl = _replica_states(rng, 512, lcap, windows, pool,
                                     np.append(pool, INF))
    R = len(windows)
    q = np.concatenate([np.repeat(pool, 20), [INF] * 10, [8, -2, INF - 1]]
                       ).astype(np.int32)
    rng.shuffle(q)
    sel = rng.integers(0, 2, (len(q), R)).astype(np.int32)
    sel[:4] = 0
    got = ops.backup_probe(CFG, ts, tl, torch.as_tensor(q),
                           torch.as_tensor(sel))
    jq, jsel = jnp.asarray(q), jnp.asarray(sel)
    _eq(got, jops.backup_probe(JCFG, js, jl, jq, jsel), "backup_probe pallas")
    _eq(got, jops.backup_probe(jscaled(use_kernels="off"), js, jl, jq, jsel),
        "backup_probe jnp")
    lwin = jnp.stack([jl.applied, jl.tail], axis=1)
    want = jref.ref_backup_probe(JCFG, js.keys, js.addrs, jl.keys, jl.addrs,
                                 jl.ops.astype(jnp.int32), lwin, jq, jsel)
    _eq((got[0], got[1].to(torch.int32), got[2]), want, "backup_probe ref")
    # the cases reach both answers of the log: a key whose newest entry
    # is a DEL (a miss, whatever PUTs precede it) and one whose is a PUT
    newest = set()
    for log in tl:
        hit, op, _ = lg.pending_lookup(log, torch.as_tensor(pool))
        newest |= {int(o) for o in op[hit]}
    assert newest == {1, 2}


# (applied, tail) per replica, lcap = 64, for the group probe: wrapped,
# empty, full and short windows
GROUP_WINDOWS = [[(50, 100), (37, 37)], [(10, 74), (3, 20)],
                 [(60, 70), (120, 129)]]


@pytest.mark.parametrize("windows", GROUP_WINDOWS)
@pytest.mark.parametrize("select", ["none", "mixed"])
def test_group_probe_matches_pallas(windows, select):
    """The port's group probe (its plain version on the CPU) against the
    JAX package's fused Pallas kernel in interpret mode and its jnp
    path: all six outputs equal, with rep_sel all zero (the healthy GET's
    real lanes) or mixed, wrapped windows and q = 2**31 - 1."""
    lcap, cap = 64, 4096
    rng = np.random.default_rng(len(windows) * 10 + windows[0][0]
                                + (select == "mixed"))
    hkeys, jh, th = _hash_state(rng, cap=2048, n=900, n_del=200)
    pool = np.concatenate([hkeys[:1500], rng.choice(
        10 ** 6, 1500, replace=False).astype(np.int32)])
    pool = np.unique(pool)
    js, jl, ts, tl = _replica_states(rng, cap, lcap, windows, pool)
    R = len(windows)
    q = np.concatenate([rng.choice(hkeys, 200), rng.choice(pool, 200),
                        rng.integers(0, 2 ** 31 - 1, 60),
                        [INF, INF, 0, -1, INF - 1]]).astype(np.int32)
    rng.shuffle(q)
    if select == "none":
        sel = np.zeros((len(q), R), np.int32)
    else:
        sel = rng.integers(0, 2, (len(q), R)).astype(np.int32)
        sel[np.flatnonzero(q == INF)] = 1
    got = ops.group_probe(CFG, th, ts, tl, torch.as_tensor(q),
                          torch.as_tensor(sel))
    jq, jsel = jnp.asarray(q), jnp.asarray(sel)
    _eq(got, jops.group_probe(JCFG, jh, js, jl, jq, jsel),
        "group_probe pallas")
    _eq(got, jops.group_probe(jscaled(use_kernels="off"), jh, js, jl, jq,
                              jsel), "group_probe jnp")
    _eq(got[:3], ops.probe(CFG, th, torch.as_tensor(q)), "hash half")
    assert got[1].any() and not got[1].all()
    if select == "none":
        assert not got[4].any() and not got[5].any()
    else:
        assert got[4].any() and (got[5] > 0).any()


def _stacked_cpu_state(G, R, n=4):
    """A store's hash and backups stacked as the group probe takes them
    ([G, ...] and [R, G, ...]), on the CPU."""
    from repro_torch.core import tree
    hidx = tree.replicate(hix.create(64, CFG, "cpu"), G)
    srt = tree.replicate(tree.replicate(six.create(n, "cpu"), G), R)
    blog = tree.replicate(tree.replicate(lg.create(n, "cpu"), G), R)
    return hidx, srt, blog


def test_group_probe_wrapper_refuses_cpu_tensors():
    """The per-group use of the wrapper (G = 1, rep_sel given) refuses CPU
    tensors and counts nothing."""
    before = dict(ops.LAUNCHES)
    x = torch.zeros(4, dtype=torch.int32)
    hidx, srt, blog = _stacked_cpu_state(1, 1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.group_probe_cuda(x[None], x[None, :, None], hidx, srt, blog, 8,
                             128)
    assert ops.LAUNCHES == before


def test_group_probe_stacked_wrapper_refuses_cpu_tensors():
    """The stacked use (G = 3, rep_sel computed on the card) refuses CPU
    tensors and counts nothing; the routed op takes its plain version."""
    before = dict(ops.LAUNCHES)
    rk = torch.zeros((3, 4), dtype=torch.int32)
    hidx, srt, blog = _stacked_cpu_state(3, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.group_probe_cuda(rk, None, hidx, srt, blog, 8, 128)
    got = ops.group_probe_stacked(CFG, hidx, srt, blog, rk)
    assert len(got) == 7 and all(t.shape == (3, 4) for t in got)
    assert ops.LAUNCHES == before


def test_pending_lookup_key_inf_reads_a_stale_slot():
    """The reference reads every ring slot outside [applied, tail) as
    key_inf, so q = 2**31 - 1 "hits" the slot at sequence position
    applied + lcap - 1 and returns its stale op and addr.  Log of 8,
    applied 4, tail 6: slot 3 holds an applied PUT with addr 80."""
    keys = np.array([10, 20, 30, 40, 50, 60, 0, 0], np.int32)
    addrs = np.array([50, 60, 70, 80, 90, 100, -1, -1], np.int32)
    ops_ = np.array([1, 1, 1, 1, 1, 1, 0, 0], np.int8)
    tl = lg.UpdateLog(_t(keys), _t(addrs), _t(ops_), _t(np.int32(6)),
                      _t(np.int32(4)))
    jl = jlg.UpdateLog(*[jnp.asarray(a) for a in (keys, addrs, ops_)],
                       jnp.int32(6), jnp.int32(4))
    q = np.array([INF, 50, 40], np.int32)
    hit, op, addr = lg.pending_lookup(tl, torch.as_tensor(q))
    _eq((hit, op, addr), jlg.pending_lookup(jl, jnp.asarray(q)),
        "pending_lookup")
    assert (bool(hit[0]), int(op[0]), int(addr[0])) == (True, 1, 80)
    assert bool(hit[1]) and not bool(hit[2])
    srt = six.create(16, "cpu")
    got = ops.backup_probe(CFG, (srt,), (tl,), torch.as_tensor(q),
                           torch.ones((3, 1), dtype=torch.int32))
    assert (int(got[0][0]), bool(got[1][0])) == (80, True)


def test_dispatch_follows_the_device():
    assert ops.active_path(CFG, "cpu") == "torch"
    assert ops.active_path(scaled(use_kernels="off"), "cpu") == "torch"
    assert ops.active_path(CFG, "cuda") == "kernel"
    assert ops.active_path(scaled(use_kernels="auto"), "cuda") == "kernel"
    with pytest.raises(ValueError, match="use_kernels='off'"):
        ops.kernels_enabled(scaled(use_kernels="off"), "cuda")


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper never runs the plain version: a CPU tensor is refused,
    and nothing is counted."""
    before = dict(ops.LAUNCHES)
    x = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.sorted_search_cuda(x, x, x, 128)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.merge_cuda(x, x, x, x, x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.hash_probe_cuda(x, x[None], x[None], x[None], x[:1], 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.backup_probe_cuda(x, x[:, None], (six.create(4, "cpu"),),
                              (lg.create(4, "cpu"),), 128)
    assert ops.LAUNCHES == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernels are CUDA "
                    "C++ built with nvcc and have no CPU mode")
    return torch.device("cuda")


@pytest.mark.requires_cuda
def test_cuda_kernels_match_plain(cuda_device):
    """Each CUDA kernel against its plain PyTorch version on the card."""
    rng = np.random.default_rng(7)
    keys, _, th = _hash_state(rng, cap=1 << 14, n=6000, n_del=1000)
    thc = hix.HashIndex(*[a.to(cuda_device) for a in th])
    q = torch.as_tensor(np.concatenate(
        [keys, rng.integers(0, 2 ** 31 - 1, 3000)]).astype(np.int32),
        device=cuda_device)
    _eq(ops.probe(CFG, thc, q), hix.lookup(thc, q, CFG), "cuda probe")
    skeys, _, ts = _sorted_state(rng, 1 << 16, 40000)
    tsc = six.SortedIndex(*[a.to(cuda_device) for a in ts])
    sq = torch.as_tensor(np.concatenate(
        [skeys[:5000], rng.integers(-5, 10 ** 6, 5000), [INF - 1, INF]]
    ).astype(np.int32), device=cuda_device)
    _eq(ops.search(CFG, tsc, sq), six.search(tsc, sq, CFG.fanout),
        "cuda search")
    for lo, hi in [(-3, 50), (int(skeys[100]), int(skeys[900])),
                   (10 ** 6, INF - 1), (INF, INF)]:
        lo_t = torch.tensor(lo, dtype=torch.int32, device=cuda_device)
        hi_t = torch.tensor(hi, dtype=torch.int32, device=cuda_device)
        _eq(ops.range_query(CFG, tsc, lo_t, hi_t, 128),
            six.range_query(tsc, lo_t, hi_t, 128), "cuda range_query")
    for m in (1, 300, 4096, 16384):
        bk = torch.as_tensor(rng.choice(np.concatenate(
            [skeys, rng.integers(0, 10 ** 6, 2000)]), m).astype(np.int32),
            device=cuda_device)
        ba = torch.as_tensor(rng.integers(0, 10 ** 5, m).astype(np.int32),
                             device=cuda_device)
        bo = torch.as_tensor(rng.choice([0, 1, 2], m).astype(np.int8),
                             device=cuda_device)
        _eq(ops.merge(CFG, tsc, bk, ba, bo), six.merge(tsc, bk, ba, bo),
            f"cuda merge m={m}")
    torch.cuda.synchronize()


@pytest.mark.requires_cuda
def test_cuda_backup_probe_matches_plain(cuda_device):
    """The backup-probe kernel against its plain version on the card:
    every window shape of BACKUP_WINDOWS, a ring larger than one
    shared-memory tile, and 5000 queries with random replica selects."""
    rng = np.random.default_rng(9)
    pool = rng.choice(10 ** 6, 60000, replace=False).astype(np.int32)
    cases = [(64, w) for w in BACKUP_WINDOWS] + [
        (1 << 14, [(1000, 1000 + (1 << 14) - 7), (30000, 40000)]),
        (1 << 14, [(5, 9000), (123, 123)])]
    for lcap, windows in cases:
        _, _, ts, tl = _replica_states(rng, 1 << 16, lcap, windows, pool)
        ts = tuple(six.SortedIndex(*[a.to(cuda_device) for a in s])
                   for s in ts)
        tl = tuple(lg.UpdateLog(*[a.to(cuda_device) for a in lo])
                   for lo in tl)
        q = torch.as_tensor(np.concatenate(
            [rng.choice(pool, 4000), rng.integers(-5, 10 ** 6, 995),
             [INF, INF, 0, -1, INF - 1]]).astype(np.int32),
            device=cuda_device)
        sel = torch.as_tensor(rng.integers(0, 2, (q.shape[0], len(ts))
                                           ).astype(np.int32),
                              device=cuda_device)
        n0 = ops.LAUNCHES["backup_probe"]
        _eq(ops.backup_probe(CFG, ts, tl, q, sel),
            ops.backup_probe_plain(CFG, ts, tl, q, sel),
            f"cuda backup_probe lcap={lcap} windows={windows}")
        assert ops.LAUNCHES["backup_probe"] == n0 + 1
    torch.cuda.synchronize()


@pytest.mark.requires_cuda
def test_cuda_group_probe_matches_plain(cuda_device):
    """The group-probe kernel against its plain version on the card: the
    group windows, a ring larger than one shared-memory tile, rep_sel
    zero and random, 5000 queries with hits of the hash and the logs,
    then 3000 more lanes of q = 2**31 - 1 that all select a replica (an
    exchange buffer's padding, whole scan blocks of it)."""
    rng = np.random.default_rng(11)
    hkeys, _, th = _hash_state(rng, cap=1 << 14, n=6000, n_del=1000)
    th = hix.HashIndex(*[a.to(cuda_device) for a in th])
    pool = np.unique(np.concatenate([hkeys, rng.choice(
        10 ** 6, 50000, replace=False).astype(np.int32)]))
    cases = [(64, w) for w in GROUP_WINDOWS] + [
        (1 << 14, [(1000, 1000 + (1 << 14) - 7), (30000, 40000)])]
    for lcap, windows in cases:
        _, _, ts, tl = _replica_states(rng, 1 << 16, lcap, windows, pool)
        ts = tuple(six.SortedIndex(*[a.to(cuda_device) for a in s])
                   for s in ts)
        tl = tuple(lg.UpdateLog(*[a.to(cuda_device) for a in lo])
                   for lo in tl)
        q = torch.as_tensor(np.concatenate(
            [rng.choice(hkeys, 2000), rng.choice(pool, 2000),
             rng.integers(-5, 10 ** 6, 995), [INF, INF, 0, -1, INF - 1]]
        ).astype(np.int32), device=cuda_device)
        R = len(ts)
        mixed = torch.as_tensor(rng.integers(0, 2, (q.shape[0], R)
                                             ).astype(np.int32),
                                device=cuda_device)
        pad = torch.full((3000,), INF, dtype=torch.int32, device=cuda_device)
        pad_sel = torch.zeros((3000, R), dtype=torch.int32,
                              device=cuda_device)
        pad_sel[:, 0] = 1                  # replica 0's window may be full
        for qs, sel in ((q, torch.zeros_like(mixed)), (q, mixed),
                        (torch.cat([q, pad]), torch.cat([mixed, pad_sel]))):
            n0 = ops.LAUNCHES["group_probe"]
            _eq(ops.group_probe(CFG, th, ts, tl, qs, sel),
                ops.group_probe_plain(CFG, th, ts, tl, qs, sel),
                f"cuda group_probe lcap={lcap} windows={windows}")
            assert ops.LAUNCHES["group_probe"] == n0 + 1
    torch.cuda.synchronize()


# (lcap, (applied, tail) per replica, distinct log keys): rings of 65536
# (16 slices of 4096 entries, two shared-memory tables each), one full and
# wrapping, one holding a single key; a ring whose size is no power of
# two; and R = 9
DUP_CUDA_CASES = [
    (1 << 16, [(70000, 70000 + (1 << 16)), (5, 40000)], 3000),
    (50000, [(123456, 173456)], 100),
    (1 << 16, [(1 << 16, 1 << 17), (9, 9)], 1),
    (5000, [(4000 + 700 * r, 9000 + 500 * r) for r in range(9)], 50),
]


def _plant(log, applied, entries):
    """Write (position in the window, key, op, addr) into a log's ring."""
    lcap = log.keys.shape[0]
    for pos, k, op, a in entries:
        i = (applied + pos) % lcap
        log.keys[i], log.ops[i], log.addrs[i] = k, op, a


def _launched(name, fn):
    n0 = ops.LAUNCHES[name]
    out = fn()
    assert ops.LAUNCHES[name] == n0 + 1, name
    return out


@pytest.mark.requires_cuda
@pytest.mark.parametrize("lcap,windows,n_keys", DUP_CUDA_CASES)
def test_cuda_probes_newest_wins_across_slices_and_tiles(
        cuda_device, lcap, windows, n_keys):
    """The window lookup of both probes on windows dense in duplicate
    keys, against their plain versions on the card: four keys planted in
    replica 0's window so that the newest entry lies in a later slice, a
    later position of one table, the newest slot of the window, or the
    newer of a slice's two tables (a PUT behind a DEL and a DEL behind a
    PUT), and 2**31 - 1 planted once; every lane's key in the window with
    replica 0 selected, then random selects, then none."""
    rng = np.random.default_rng(lcap + n_keys)
    hkeys, _, th = _hash_state(rng, cap=1 << 12, n=1500, n_del=200)
    th = hix.HashIndex(*[a.to(cuda_device) for a in th])
    pool = rng.choice(10 ** 6, n_keys, replace=False).astype(np.int32)
    _, _, ts, tl = _replica_states(
        rng, 1 << 14, lcap, windows, np.unique(np.concatenate([pool, hkeys])),
        pool)
    applied, tail = windows[0]
    n_win = min(tail - applied, lcap)
    per = -(-n_win // 16)                    # entries of a slice
    P = 10 ** 6
    _plant(tl[0], applied, [
        (3, P + 1, 1, 11), (5 * per + 1, P + 1, 1, 12),
        (6 * per - 1, P + 1, 2, 0),
        (7 * per + 10, P + 2, 1, 21), (7 * per + min(per, 2048) - 1, P + 2, 1,
                                         22),
        (0, P + 3, 1, 31), (n_win - 1, P + 3, 1, 32),
        (2 * per + 2047, P + 4, 1, 41), (2 * per + 2048, P + 4, 2, 0),
        (9 * per + 5, INF, 1, 91)])
    ts = tuple(six.SortedIndex(*[a.to(cuda_device) for a in s]) for s in ts)
    tl = tuple(lg.UpdateLog(*[a.to(cuda_device) for a in lo]) for lo in tl)
    wkeys = lg.pending_entries_np(tl[0])[0]
    plants = np.repeat(np.arange(P + 1, P + 5), 4)
    q = np.concatenate([plants, [INF] * 8, rng.choice(wkeys, 4096 - 24)]
                       ).astype(np.int32)
    qt = torch.as_tensor(q, device=cuda_device)
    R = len(ts)
    first = torch.zeros((len(q), R), dtype=torch.int32, device=cuda_device)
    first[:, 0] = 1
    rand = torch.as_tensor(rng.integers(0, 2, (len(q), R)).astype(np.int32),
                           device=cuda_device)
    for label, sel in (("replica 0", first), ("random", rand),
                       ("none", torch.zeros_like(first))):
        got = _launched("backup_probe",
                        lambda: ops.backup_probe(CFG, ts, tl, qt, sel))
        _eq(got, ops.backup_probe_plain(CFG, ts, tl, qt, sel),
            f"cuda backup_probe {label}")
        _eq(_launched("group_probe",
                      lambda: ops.group_probe(CFG, th, ts, tl, qt, sel)),
            ops.group_probe_plain(CFG, th, ts, tl, qt, sel),
            f"cuda group_probe {label}")
        if label == "replica 0":
            a, f = got[0][:16].cpu().numpy(), got[1][:16].cpu().numpy()
            assert a.tolist() == [-1] * 4 + [22] * 4 + [32] * 4 + [-1] * 4
            assert f.tolist() == [0] * 4 + [1] * 8 + [0] * 4
            assert bool(got[1][16:].any())
        if label == "none":
            assert not bool(got[1].any()) and not bool(got[2].any())
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# mamba_scan (the Mamba-1 selective scan of the model path)
# ---------------------------------------------------------------------------
def _scan_inputs(rng, B, S, di, N):
    """The JAX test's inputs (tests/test_kernels.py:124): x, B, C normal,
    dt = 0.05 |normal|, A = -exp(uniform)."""
    return (rng.randn(B, S, di).astype(np.float32),
            (np.abs(rng.randn(B, S, di)) * 0.05).astype(np.float32),
            rng.randn(B, S, N).astype(np.float32),
            rng.randn(B, S, N).astype(np.float32),
            -np.exp(rng.rand(di, N).astype(np.float32)))


@pytest.mark.parametrize("B,S,di,N", [(2, 64, 128, 8), (1, 256, 256, 16),
                                      (3, 32, 384, 4)])
def test_mamba_scan_plain_matches_ref_and_pallas(B, S, di, N):
    """The plain version against ``ref_mamba_scan`` and the Pallas kernel
    in interpret mode, at the JAX test's shapes and tolerance (2e-5: the
    same float32 recurrence, exp and sums in another order)."""
    from repro.kernels.mamba_scan import mamba_scan_kernel
    from repro_torch.kernels import mamba_scan as ms

    ins = _scan_inputs(np.random.RandomState(B * S), B, S, di, N)
    want_ref = np.asarray(jref.ref_mamba_scan(*map(jnp.asarray, ins)))
    want_k = np.asarray(mamba_scan_kernel(
        *map(jnp.asarray, ins), d_block=min(128, di), seq_chunk=min(64, S),
        interpret=True))
    n0 = ms.LAUNCHES["mamba_scan"]
    got = ms.mamba_scan(*map(torch.as_tensor, ins))
    assert ms.LAUNCHES["mamba_scan"] == n0     # the CPU takes the plain path
    assert got.dtype == torch.float32 and got.shape == (B, S, di)
    for want in (want_ref, want_k):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("B,S,di,N", [(1, 1, 8, 1), (2, 65, 40, 65),
                                      (1, 33, 24, 128)])
def test_mamba_scan_plain_edges_match_pallas(B, S, di, N):
    """The plain version, which the kernel is held against on the card,
    equals the Pallas kernel in interpret mode (one grid step of the
    whole S and di) at the kernel's edge shapes: S of 1 and one past a
    chunk, N of 1, 65 and 128; 2e-5 as the JAX test."""
    from repro.kernels.mamba_scan import mamba_scan_kernel
    from repro_torch.kernels import mamba_scan as ms

    ins = _scan_inputs(np.random.RandomState(S + N), B, S, di, N)
    want = mamba_scan_kernel(*map(jnp.asarray, ins), d_block=di,
                             seq_chunk=S, interpret=True)
    got = ms.mamba_scan(*map(torch.as_tensor, ins))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_mamba_scan_plain_bf16_matches_ref():
    """bf16 x, B and C: y comes back in bf16, within one bf16 ulp of the
    reference (the rounding of the same float32 value may land one ulp
    apart when the float32 sums differ in their last bits)."""
    from repro_torch.kernels import mamba_scan as ms

    x, dt, Bs, Cs, A = _scan_inputs(np.random.RandomState(5), 2, 48, 96, 16)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (x, Bs, Cs)]
    want = np.asarray(jref.ref_mamba_scan(jb[0], jnp.asarray(dt), jb[1],
                                          jb[2], jnp.asarray(A)), np.float32)
    tb = [torch.as_tensor(a).to(torch.bfloat16) for a in (x, Bs, Cs)]
    got = ms.mamba_scan(tb[0], torch.as_tensor(dt), tb[1], tb[2],
                        torch.as_tensor(A))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=2e-5)


def test_mamba_scan_cuda_wrapper_refuses():
    """The CUDA wrapper raises on CPU tensors and launches nothing; the
    dtype and contiguity checks come first on the card."""
    from repro_torch.kernels import mamba_scan as ms

    x = torch.zeros((1, 4, 8))
    n0 = ms.LAUNCHES["mamba_scan"]
    with pytest.raises(ValueError, match="CUDA"):
        ms.mamba_scan_cuda(x, x, x[..., :2], x[..., :2], x[0, :, :2].T)
    assert ms.LAUNCHES["mamba_scan"] == n0


def _ulp_bf16(a):
    """One bf16 ulp at each value of ``a`` (float32 tensor)."""
    e = torch.floor(torch.log2(a.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


@pytest.mark.requires_cuda
def test_cuda_mamba_scan_matches_plain(cuda_device):
    """The CUDA kernel against its plain version on the card, float32
    (2e-5, the JAX test's tolerance) and bf16 (one bf16 ulp of the plain
    value, plus 2e-5), at shapes that fill no block evenly: N of 3, 8, 16
    and 64, S not a multiple of the 32-step chunk, di not a multiple of
    the 32-channel block.  Strided B and C views and float64 are
    refused."""
    from repro_torch.kernels import mamba_scan as ms

    rng = np.random.RandomState(3)
    for B, S, di, N in [(2, 64, 128, 8), (1, 300, 200, 16), (3, 33, 40, 3),
                        (1, 70, 96, 64)]:
        ins = [torch.as_tensor(a, device=cuda_device)
               for a in _scan_inputs(rng, B, S, di, N)]
        n0 = ms.LAUNCHES["mamba_scan"]
        got = ms.mamba_scan(*ins)
        assert ms.LAUNCHES["mamba_scan"] == n0 + 1
        want = ms.mamba_scan_plain(*ins)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=2e-5, atol=2e-5)
        x, dt, Bs, Cs, A = ins
        xb, Bb, Cb = (t.to(torch.bfloat16) for t in (x, Bs, Cs))
        got = ms.mamba_scan(xb, dt, Bb, Cb, A).float()
        want = ms.mamba_scan_plain(xb, dt, Bb, Cb, A).float()
        assert bool(((got - want).abs() <= _ulp_bf16(want) + 2e-5).all())
    dbc = torch.zeros((1, 8, 12), device=cuda_device)
    x = torch.zeros((1, 8, 16), device=cuda_device)
    A = -torch.ones((16, 6), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        ms.mamba_scan(x, x, dbc[..., :6], dbc[..., 6:], A)
    with pytest.raises(TypeError):
        ms.mamba_scan(x.double(), x, dbc[..., :6].double().contiguous(),
                      dbc[..., 6:].double().contiguous(), A)
    torch.cuda.synchronize()


def _scan_tol(want, dtype):
    """float32: 2e-5 + 2e-5 |want| (the JAX test's tolerance); bf16 and
    float16: one ulp of the plain value plus 2e-5."""
    if dtype == torch.float32:
        return 2e-5 + 2e-5 * want.abs()
    bits = 7 if dtype == torch.bfloat16 else 10
    e = torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -14)))
    return torch.exp2(e - bits) + 2e-5


SCAN_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# (B, S, di, N): S of 1, of the kernel's 32-step chunk and of two chunks,
# and one either side, di off the 32-channel block, N of 1, 16, 65 and
# 128, B > 1
SCAN_EDGES = [(1, 1, 8, 16), (2, 63, 40, 1), (1, 64, 64, 16),
              (3, 65, 72, 16), (2, 31, 20, 65), (1, 33, 96, 128),
              (2, 32, 33, 65), (4, 1, 3, 128)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,S,di,N", SCAN_EDGES)
def test_cuda_mamba_scan_edges(cuda_device, B, S, di, N):
    """The scan kernel at the edges of its chunks, channel blocks and state
    tiles, in float32, bf16 and float16, against its plain version."""
    from repro_torch.kernels import mamba_scan as ms

    rng = np.random.RandomState(B * 1000 + S + di + N)
    x, dt, Bs, Cs, A = (torch.as_tensor(a, device=cuda_device)
                        for a in _scan_inputs(rng, B, S, di, N))
    for dtype in SCAN_DTYPES:
        xd, Bd, Cd = (t.to(dtype) for t in (x, Bs, Cs))
        n0 = ms.LAUNCHES["mamba_scan"]
        got = ms.mamba_scan(xd, dt, Bd, Cd, A)
        assert ms.LAUNCHES["mamba_scan"] == n0 + 1
        assert got.dtype == dtype and got.shape == (B, S, di)
        got = got.float()
        want = ms.mamba_scan_plain(xd, dt, Bd, Cd, A).float()
        assert bool(((got - want).abs() <= _scan_tol(want, dtype)).all()), \
            (dtype, float((got - want).abs().max()))
    torch.cuda.synchronize()


@pytest.mark.requires_cuda
def test_cuda_mamba_scan_carries_across_many_chunks(cuda_device):
    """S = 4100, 128 chunk carries, with strong decays (dt * A down to
    about -20) beside weak ones, at B = 2, in float32, bf16 and float16,
    against the plain version: the state crosses each chunk's end."""
    from repro_torch.kernels import mamba_scan as ms

    rng = np.random.RandomState(41)
    B, S, di, N = 2, 4100, 72, 16
    x, _, Bs, Cs, _ = _scan_inputs(rng, B, S, di, N)
    dt = (np.abs(rng.randn(B, S, di)) * np.where(
        rng.rand(1, 1, di) < 0.5, 2.0, 0.05)).astype(np.float32)
    A = -np.exp(rng.rand(di, N) * 2).astype(np.float32)
    x, dt, Bs, Cs, A = (torch.as_tensor(a, device=cuda_device)
                        for a in (x, dt, Bs, Cs, A))
    for dtype in SCAN_DTYPES:
        xd, Bd, Cd = (t.to(dtype) for t in (x, Bs, Cs))
        got = ms.mamba_scan(xd, dt, Bd, Cd, A).float()
        want = ms.mamba_scan_plain(xd, dt, Bd, Cd, A).float()
        assert bool(((got - want).abs() <= _scan_tol(want, dtype)).all()), \
            (dtype, float((got - want).abs().max()))
    torch.cuda.synchronize()
