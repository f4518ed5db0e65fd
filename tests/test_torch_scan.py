"""The searches, the SCAN's route and the bitonic network: ``ops.search``
/ ``ops.sorted_search`` (the block form at Q <= 256 and the lane form
above it on the card), ``ops.range_query`` (one launch for a SCAN's lower bound
and its take), ``ops.range_query_stacked`` (the distributed SCAN's G x R
range queries in one launch) and ``ops.sort_pairs``.

On the CPU the port takes the plain versions, held here against the JAX
package's ``range_query`` in interpret mode (the sorted-search Pallas
kernel's lower bound) and on its jnp path.  The CUDA kernels run only on
the card: the ``requires_cuda`` tests hold them against their plain
versions there and skip here.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.histore import scaled as jscaled
from repro.core import sorted_index as jsix
from repro.kernels import ops as jops
from repro_torch.core import kvstore as kv
from repro_torch.core import sorted_index as six
from repro_torch.core import tree
from repro_torch.kernels import ops
from test_torch_kernels import CFG, INF, JCFG, _eq, _launched

MIN = -2 ** 31
CAP = 512
# (lo, hi) of a SCAN: the whole int32 range, one key at -2**31, lo > hi,
# lo past every pool key, lo = key_inf, a window inside the pool, and lo
# just below 2**31 - 2 (a key of some replicas)
BOUNDS = [(MIN, INF), (MIN, MIN), (500, 400), (10 ** 6 + 5, INF),
          (INF, INF), (30000, 200000), (INF - 2, INF)]


def _stacked_sorted(rng, G, R, cap):
    """[R, G] sorted replicas from numpy: replica (0, 0) empty (when there
    are two or more), (R - 1, G - 1) full to cap with the keys -2**31 and
    2**31 - 2 at its ends, the rest random fills of keys in [0, 10**6)
    and sometimes -2**31, -7 and 2**31 - 2.  Returns the port's stacked
    SortedIndex [R, G, cap] and the numpy (keys, addrs, size)."""
    keys = np.full((R, G, cap), INF, np.int32)
    addrs = np.full((R, G, cap), -1, np.int32)
    for r in range(R):
        for g in range(G):
            if (r, g) == (0, 0) and R * G > 1:
                continue
            full = (r, g) == (R - 1, G - 1)
            n = cap if full else int(rng.integers(1, cap))
            pool = rng.choice(10 ** 6, n, replace=False).astype(np.int64)
            if full or rng.random() < 0.5:
                pool[:3] = [MIN, -7, INF - 1]
            ks = np.unique(pool)
            keys[r, g, :len(ks)] = ks
            addrs[r, g, :len(ks)] = rng.integers(0, 10 ** 5, len(ks))
    size = (keys != INF).sum(-1).astype(np.int32)
    ts = six.SortedIndex(torch.as_tensor(keys), torch.as_tensor(addrs),
                         torch.as_tensor(size))
    return ts, (keys, addrs, size)


def _jax_replica(np_state, r, g):
    keys, addrs, size = np_state
    return jsix.SortedIndex(jnp.asarray(keys[r, g]), jnp.asarray(addrs[r, g]),
                            jnp.int32(size[r, g]))


@pytest.mark.parametrize("G", [1, 3, 8])
@pytest.mark.parametrize("R", [1, 2])
def test_range_query_stacked_matches_pallas(G, R):
    """The stacked SCAN (its plain version on the CPU) against the JAX
    package's ``range_query`` of every (group, replica), in interpret mode
    and on its jnp path: each group with its own [lo, hi] of BOUNDS, over
    rounds that give every group every case, at limit 16 and at 600, a
    limit past the 512 slots; and the routed single ``ops.range_query``
    equal to the stacked row."""
    rng = np.random.default_rng(10 * G + R)
    ts, np_state = _stacked_sorted(rng, G, R, CAP)
    jnp_cfg = jscaled(use_kernels="off")
    for k in range(len(BOUNDS)):
        b = [BOUNDS[(g + k) % len(BOUNDS)] for g in range(G)]
        lo = torch.tensor([x for x, _ in b], dtype=torch.int32)
        hi = torch.tensor([y for _, y in b], dtype=torch.int32)
        limit = 16 if k % 2 else 600
        got = ops.range_query_stacked(CFG, ts, lo, hi, limit)
        assert [tuple(t.shape) for t in got] == [(G, R, limit)] * 2 + [(G, R)]
        for g in range(G):
            for r in range(R):
                js = _jax_replica(np_state, r, g)
                row = [t[g, r] for t in got]
                args = (js, jnp.int32(b[g][0]), jnp.int32(b[g][1]), limit)
                label = f"G={G} R={R} g={g} r={r} {b[g]} limit={limit}"
                _eq(row, jops.range_query(JCFG, *args), f"{label} pallas")
                _eq(row, jops.range_query(jnp_cfg, *args), f"{label} jnp")
                _eq(row, ops.range_query(CFG, tree.at(ts, r, g), lo[g],
                                         hi[g], limit), f"{label} single")
    assert int(got[2].sum()) > 0


def _duty_loop(eff, G, R):
    """The distributed SCAN's duty rule as a loop (the JAX op body's)."""
    serve = torch.zeros((G, R), dtype=torch.bool)
    for g in range(G):
        for r in range(R):
            grp = (g - r - 1) % G
            prev = any(bool(eff[(grp + rp + 1) % G]) for rp in range(r))
            serve[g, r] = bool(eff[g]) and not prev
    covered = torch.tensor([any(bool(eff[(g + r + 1) % G]) for r in range(R))
                            for g in range(G)])
    return serve, covered


@pytest.mark.parametrize("G,R", [(1, 1), (1, 3), (3, 2), (8, 2), (5, 4)])
def test_scan_duty_matches_the_loop(G, R):
    """The SCAN's serve mask and coverage, computed as tensors, against
    the per-(server, replica) loop of the JAX op body, on every live/dead
    pattern of up to 5 servers (random ones above): exactly one live
    holder serves each group that has one."""
    rng = np.random.default_rng(G * 10 + R)
    pats = ([np.array([(m >> i) & 1 for i in range(G)], bool)
             for m in range(2 ** G)] if G <= 5
            else [rng.random(G) < 0.6 for _ in range(40)])
    for eff in pats:
        eff_t = torch.as_tensor(eff)
        serve, holders = kv._scan_duty(eff_t, G, R)
        want_serve, want_cov = _duty_loop(eff_t, G, R)
        assert torch.equal(serve, want_serve), eff
        assert torch.equal(eff_t[holders].any(1), want_cov), eff
        for grp in range(G):
            n = sum(bool(serve[(grp + r + 1) % G, r]) for r in range(R))
            assert n == (1 if want_cov[grp] else 0) or G < R, (eff, grp)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernels are CUDA "
                    "C++ built with nvcc and have no CPU mode")
    return torch.device("cuda")


def _index(rng, cap, n, device, edges=True):
    """A sorted replica of cap slots holding n keys (with -2**31, -1, 0
    and 2**31 - 2 among them when ``edges`` and n >= 4)."""
    ks = rng.choice(2 ** 31 - 2, n, replace=False).astype(np.int64)
    if edges and n >= 4:
        ks[:4] = [MIN, -1, 0, INF - 1]
    ks = np.unique(ks)
    keys = np.full(cap, INF, np.int32)
    addrs = np.full(cap, -1, np.int32)
    keys[:len(ks)] = ks
    addrs[:len(ks)] = rng.integers(0, 10 ** 6, len(ks))
    return six.SortedIndex(torch.as_tensor(keys, device=device),
                           torch.as_tensor(addrs, device=device),
                           torch.tensor(len(ks), dtype=torch.int32,
                                        device=device))


def _search_plain(idx, q, fanout):
    """(addr, found int32, n_accesses, pos, lower bound): six.search and
    the descent's unclamped pos."""
    addr, found, acc = six.search(idx, q, fanout)
    pos, _ = six._descent(idx.keys, q, fanout)
    at = pos.clamp(max=idx.keys.shape[0] - 1)
    lb = pos + (idx.keys[at] < q).to(torch.int64)
    return addr, found.to(torch.int32), acc, pos.to(torch.int32), \
        lb.to(torch.int32)


CAPS = [1, 127, 128, 129, 1 << 16, 1 << 20]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cap", CAPS)
def test_cuda_search_matches_plain(cuda_device, cap):
    """The search at Q = 1, 256, 300 and 16384 (the block form to Q =
    256, the lane form above), on full and partly filled replicas, with
    queries -1, 0, 2**31 - 2 and 2**31 - 1 among hits and misses: all
    five outputs of
    ``sorted_search_cuda`` equal to the plain descent's, and the legacy
    entry point's three equal to its plain version; at fanout 4, 16 and
    128, and on a view whose keys are not 16-byte aligned."""
    rng = np.random.default_rng(cap)
    for fanout in (4, 16, 128):
        for n in sorted({cap, max(cap // 3, 1)}):
            idx = _index(rng, cap, n, cuda_device)
            keys = idx.keys[:n].cpu().numpy()
            views = [idx]
            if cap > 1:
                views.append(six.SortedIndex(idx.keys[1:], idx.addrs[1:],
                                             idx.size))
            for Q in (1, 256, 300, 16384):
                q = np.concatenate([[-1, 0, INF - 1, INF],
                                    rng.choice(keys, Q), keys + 1,
                                    rng.integers(MIN, INF, Q)])
                q = torch.as_tensor(rng.permutation(q)[:Q].astype(np.int32),
                                    device=cuda_device)
                if Q == 1:
                    q = torch.tensor([int(keys[len(keys) // 2])],
                                     dtype=torch.int32, device=cuda_device)
                for v in views:
                    label = f"cap={cap} n={n} fanout={fanout} Q={Q}"
                    got = _launched("sorted_search", lambda: (
                        ops.sorted_search_cuda(q, v.keys, v.addrs, fanout)))
                    _eq(got, _search_plain(v, q, fanout), label)
                    leg = _launched("legacy_sorted_search", lambda: (
                        ops.sorted_search(v, q, fanout=fanout)))
                    _eq((leg[0], leg[1].to(torch.int32), leg[2]),
                        ops.legacy_sorted_search_plain(q, v.keys, v.addrs,
                                                       fanout=fanout),
                        f"legacy {label}")
    edge = torch.tensor([-1, 0, INF - 1, INF], dtype=torch.int32,
                        device=cuda_device)
    for Q in (1, 4):
        _eq(ops.sorted_search_cuda(edge[:Q], idx.keys, idx.addrs, 128),
            _search_plain(idx, edge[:Q], 128), f"edges Q={Q}")
    torch.cuda.synchronize()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cap", CAPS)
def test_cuda_backup_probe_descent_matches_plain(cuda_device, cap):
    """The backup probe's finish, whose descent is the lane form's from
    the root (descent_split), on empty log windows so that every selected
    lane descends: two replicas, one of them a view whose keys are not
    16-byte aligned, at fanout 4, 16 and 128, Q = 1, 300 and 16384 with
    queries -1, 0, 2**31 - 2 and 2**31 - 1 among hits and misses and
    random replica selects; equal to ``backup_probe_plain``."""
    from repro_torch.configs.histore import scaled
    from repro_torch.core import log as lg

    rng = np.random.default_rng(cap + 7)
    logs = (lg.create(64, cuda_device), lg.create(64, cuda_device))
    for fanout in (4, 16, 128):
        cfg = scaled(use_kernels="on", fanout=fanout)
        for n in sorted({cap, max(cap // 3, 1)}):
            a = _index(rng, cap + 1, n, cuda_device)
            b = _index(rng, cap + 1, n, cuda_device)
            reps = (six.SortedIndex(a.keys[:cap], a.addrs[:cap], a.size),
                    six.SortedIndex(b.keys[1:], b.addrs[1:], b.size))
            keys = np.concatenate([a.keys[:n].cpu().numpy(),
                                   b.keys[1:n].cpu().numpy()])
            for Q in (1, 300, 16384):
                q = np.concatenate([[-1, 0, INF - 1, INF],
                                    rng.choice(keys, Q), keys + 1,
                                    rng.integers(MIN, INF, Q)])
                q = torch.as_tensor(rng.permutation(q)[:Q].astype(np.int32),
                                    device=cuda_device)
                sel = torch.as_tensor(
                    rng.integers(0, 2, (Q, 2)).astype(np.int32),
                    device=cuda_device)
                got = _launched("backup_probe", lambda: ops.backup_probe(
                    cfg, reps, logs, q, sel))
                _eq(got, ops.backup_probe_plain(cfg, reps, logs, q, sel),
                    f"backup_probe cap={cap} n={n} fanout={fanout} Q={Q}")
    torch.cuda.synchronize()


def _scan_cases(keys):
    """(lo, hi, limit): the int32 edges and windows around the keys."""
    k = [int(x) for x in keys[:: max(len(keys) // 4, 1)]] if len(keys) \
        else [5]
    out = [(MIN, INF, 128), (MIN, MIN, 16), (500, 400, 128),
           (INF - 1, INF, 128), (INF, INF, 16), (0, INF - 2, 3000)]
    for x in k:
        out += [(x, x + 1000, 128), (x - 1, x, 1), (x + 1, INF, 4096)]
    return [tuple(int(np.clip(b, MIN, INF)) for b in c[:2]) + c[2:]
            for c in out]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cap", CAPS)
def test_cuda_range_query_matches_plain(cuda_device, cap):
    """One launch a SCAN: ``ops.range_query`` (lo and hi read on the card)
    equal to sorted_index.range_query on full, partly filled and empty
    replicas, at the edges (lo = -2**31, hi = 2**31 - 1, lo > hi, lo past
    the last key, lo = 2**31 - 1) and at limits that run past cap and past
    the kernel's shared-memory window."""
    rng = np.random.default_rng(cap + 1)
    for n in sorted({cap, max(cap // 3, 1), 0}):
        idx = _index(rng, cap, n, cuda_device)
        for lo, hi, limit in _scan_cases(idx.keys[:n].cpu().numpy()):
            lo_t = torch.tensor(lo, dtype=torch.int32, device=cuda_device)
            hi_t = torch.tensor(hi, dtype=torch.int32, device=cuda_device)
            got = _launched("sorted_search", lambda: ops.range_query(
                CFG, idx, lo_t, hi_t, limit))
            _eq(got, six.range_query(idx, lo_t, hi_t, limit),
                f"cap={cap} n={n} [{lo}, {hi}] limit={limit}")
    torch.cuda.synchronize()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("G,R", [(1, 1), (3, 2), (8, 2), (2, 9)])
def test_cuda_range_query_stacked_matches_plain(cuda_device, G, R):
    """The stacked SCAN, one launch for G x R replicas, against its plain
    version: per-group bounds, the expanded 0-d bounds the client passes
    (stride 0), and [R, G] leaves that are strided views of a larger
    stack."""
    rng = np.random.default_rng(G * 10 + R)
    ts, _ = _stacked_sorted(rng, G, R, 4096)
    ts = six.SortedIndex(*[a.to(cuda_device) for a in ts])
    big, _ = _stacked_sorted(rng, 2 * G, R, 4096)
    big = six.SortedIndex(*[a.to(cuda_device) for a in big])
    view = six.SortedIndex(*[a[:, 1::2] for a in big])
    for k in range(len(BOUNDS)):
        b = [BOUNDS[(g + k) % len(BOUNDS)] for g in range(G)]
        lo = torch.tensor([x for x, _ in b], dtype=torch.int32,
                          device=cuda_device)
        hi = torch.tensor([y for _, y in b], dtype=torch.int32,
                          device=cuda_device)
        one = torch.tensor(b[0][0], dtype=torch.int32, device=cuda_device)
        for label, st, lo_, hi_ in (
                ("per group", ts, lo, hi),
                ("expanded", ts, one.reshape(1).expand(G),
                 hi[:1].expand(G)),
                ("strided view", view, lo, hi)):
            for limit in (128, 3000):
                got = _launched("sorted_search", lambda: (
                    ops.range_query_stacked(CFG, st, lo_, hi_, limit)))
                plain = six.SortedIndex(*[a.contiguous() for a in st])
                _eq(got, ops.range_query_stacked_plain(CFG, plain, lo_, hi_,
                                                       limit),
                    f"G={G} R={R} {label} {b} limit={limit}")
    torch.cuda.synchronize()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("lt", range(0, 18))
def test_cuda_bitonic_sort_matches_plain(cuda_device, lt):
    """The bitonic network at T = 2**lt (1 ... 2**17) and R = 1 and 16,
    keys in [0, 1024) so that ties occur, distinct payloads: keys and
    payloads equal to bitonic_sort_plain's (JAX's network), one launch a
    call."""
    T = 1 << lt
    rng = np.random.default_rng(lt)
    for R in (1, 16):
        k = torch.as_tensor(rng.integers(0, 1024, (R, T)).astype(np.int32),
                            device=cuda_device)
        v = torch.as_tensor(rng.permutation(R * T).astype(np.int32)
                            .reshape(R, T), device=cuda_device)
        got = _launched("bitonic_sort", lambda: ops.sort_pairs(k, v))
        _eq(got, ops.bitonic_sort_plain(k, v), f"sort_pairs [{R}, {T}]")
    torch.cuda.synchronize()
