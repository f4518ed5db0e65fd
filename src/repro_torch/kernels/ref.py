"""Plain PyTorch oracles for every kernel (port of ``repro/kernels/ref.py``,
with its names and signatures).

Each is the straightforward tensor form of what its kernel computes, kept
apart from the dispatch code so the tests can hold both the CUDA kernels
and the routed ops against them.  Integer oracles are bit-exact with the
JAX package's on the same inputs; ``ref_mamba_scan`` agrees to float
tolerance (the same float32 recurrence, sums in another order).
"""
from __future__ import annotations

import torch

from repro_torch.core import log as lg
from repro_torch.core import sorted_index as six

I32 = torch.int32
KEY_INF32 = 2 ** 31 - 1


def ref_hash_probe(bucket, qsig, qfp, sig, fp, addr, *, slots_per_bucket):
    """Oracle for the legacy hash probe: the first (sig, fp) match of each
    query's chain row; a miss costs ceil(occ / S) sub-bucket reads (at
    least 1), with occ the row's nonzero signatures (tombstones count)."""
    bl = bucket.long()
    rows_sig = sig[bl]
    rows_fp = fp[bl]
    rows_addr = addr[bl]
    match = (rows_sig == qsig[:, None]) & (rows_fp == qfp[:, None])
    found = match.any(dim=1)
    off = torch.argmax(match.to(torch.uint8), dim=1)
    out_addr = torch.where(
        found, torch.gather(rows_addr, 1, off[:, None])[:, 0], -1)
    occ = (rows_sig != 0).sum(dim=1)
    S = slots_per_bucket
    acc = torch.where(found, off // S + 1,
                      torch.clamp((occ + S - 1) // S, min=1))
    return out_addr.to(I32), found.to(I32), acc.to(I32)


def ref_sorted_search(queries, keys, addrs, *, fanout=128):
    """Oracle for the legacy sorted search (directory descent semantics):
    (addr or -1, found int32, n_accesses = levels)."""
    cap = keys.shape[0]
    levels = 1
    span = fanout
    while span < cap:
        span *= fanout
        levels += 1
    dev = keys.device
    pos = torch.zeros(queries.shape, dtype=torch.int64, device=dev)
    offs = torch.arange(fanout, dtype=torch.int64, device=dev)
    for li in range(levels):
        stride = fanout ** (levels - 1 - li)
        idx = pos[:, None] + offs[None, :] * stride
        node = keys[torch.clamp(idx, 0, cap - 1)]
        node = torch.where(idx < cap, node, KEY_INF32)
        cnt = (node <= queries[:, None]).sum(dim=1)
        pos = pos + torch.clamp(cnt - 1, min=0) * stride
    at = torch.clamp(pos, max=cap - 1)     # JAX's gather clamps
    found = keys[at] == queries
    out = torch.where(found, addrs[at], -1)
    return (out.to(I32), found.to(I32),
            torch.full(queries.shape, levels, dtype=I32, device=dev))


def ref_pending_lookup(lkeys, laddrs, lops, applied, tail, queries):
    """Oracle for the in-kernel pending-log probe over the [applied, tail)
    ring window, newest entry wins: (hit, op, addr)."""
    cap = lkeys.shape[0]
    seq = applied + torch.arange(cap, dtype=I32, device=lkeys.device)
    idx = (seq % cap).long()
    pv = seq < tail
    pk = torch.where(pv, lkeys[idx], KEY_INF32)
    m = pk[None, :] == queries[:, None]
    hit = m.any(dim=1)
    last = (cap - 1) - torch.argmax(m.flip(1).to(torch.uint8), dim=1)
    op = torch.where(hit, lops[idx][last], 0)
    addr = laddrs[idx][last]
    return hit, op, addr


def ref_backup_probe(cfg, skeys, saddrs, lkeys, laddrs, lops, lwin,
                     queries, rep_sel):
    """Oracle for the backup probe over stacked [R, ...] replicas and
    logs (lwin [R, 2] = applied, tail): ``ops.backup_probe_plain`` on the
    R rows (per replica the pending log, newest wins, else the sorted
    descent; the LAST selected replica answers a lane, with n_accesses =
    levels + 1), found as int32."""
    from repro_torch.kernels import ops

    R = skeys.shape[0]
    sorted_r = [six.SortedIndex(skeys[r], saddrs[r], None) for r in range(R)]
    blogs_r = [lg.UpdateLog(lkeys[r], laddrs[r], lops[r], tail=lwin[r, 1],
                            applied=lwin[r, 0]) for r in range(R)]
    addr, found, acc = ops.backup_probe_plain(cfg, sorted_r, blogs_r,
                                              queries, rep_sel)
    return addr, found.to(I32), acc


def ref_merge(ekeys, eaddrs, bkeys, baddrs, bops):
    """Oracle for the merge, ``sorted_index.merge`` on the arrays: newest
    wins per key, DELETEs (op 2) compact away, op-0 entries are ignored;
    keys past cap are dropped while the size still counts them."""
    out = six.merge(six.SortedIndex(ekeys, eaddrs, None), bkeys, baddrs,
                    bops)
    return out.keys, out.addrs, out.size


def ref_sort_pairs_stable(keys, vals):
    """Oracle for the stable pair sort: rowwise stable sort by key, the
    payload riding the same permutation (index tie-break):
    ``torch.sort(stable=True)`` and a gather."""
    ks, order = torch.sort(keys, dim=1, stable=True)
    return ks, torch.gather(vals, 1, order)


def ref_mamba_scan(x, dt, B_ssm, C_ssm, A):
    """Oracle for the selective scan: a sequential loop over S on the
    [B, di, N] float32 state, y in x's dtype."""
    Bsz, S, di = x.shape
    N = B_ssm.shape[-1]
    f32 = torch.float32
    xf, Bf, Cf = x.to(f32), B_ssm.to(f32), C_ssm.to(f32)
    dt = dt.to(f32)
    h = torch.zeros((Bsz, di, N), dtype=f32, device=x.device)
    y = torch.empty((Bsz, S, di), dtype=x.dtype, device=x.device)
    for t in range(S):
        a = torch.exp(dt[:, t, :, None] * A)                  # [B, di, N]
        b = (dt[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        h = a * h + b
        y[:, t] = (h * Cf[:, t, None, :]).sum(-1).to(x.dtype)
    return y


def ref_bitonic_sort(keys, vals):
    """Oracle for the bitonic sort, as JAX keeps it: a rowwise STABLE
    sort by key.  The network itself is not stable, so only the keys
    (and payloads of unique keys) compare equal to it; the network's
    plain version is ``ops.bitonic_sort_plain``."""
    return ref_sort_pairs_stable(keys, vals)
