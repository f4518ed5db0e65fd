"""Chained bucket hash table as dense tensors (the paper's primary
index), port of ``repro/core/hash_index.py``.

Chains are pre-linked: each logical bucket owns ``max_chain`` contiguous
sub-buckets of ``slots_per_bucket`` slots.  A GET probes sub-bucket
after sub-bucket, so ``n_accesses`` equals the number of 64 B reads the
RDMA client would issue.  Batched inserts replace the paper's RDMA CAS
with a sort-based conflict-free schedule: sort new keys by bucket, rank
within bucket, place the rank-th key at the bucket's rank-th free slot.

``lookup`` is the plain PyTorch version of the CUDA probe kernel
(``kernels/csrc/hash_probe.cu``, which hashes the keys on the card): it
hashes the keys into descriptors and calls ``probe_rows``.  ``rebuild``
and ``replay_pending`` serve recovery: a hash table rebuilt from a
sorted replica, then brought up to its pending log window.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import hashing
from repro_torch.core import log as lg
from repro_torch.core.hashing import I32, next_pow2, pad_pow2
from repro_torch.core.scatter import drop_amax, drop_set
from repro_torch.core.sorted_index import OP_DEL, OP_PUT

TOMBSTONE = -1
BIG = 2 ** 30


class HashIndex(NamedTuple):
    sig: torch.Tensor    # int32 [nb, CS]   0=empty, -1=tombstone
    fp: torch.Tensor     # int32 [nb, CS]
    addr: torch.Tensor   # int32 [nb, CS]
    fill: torch.Tensor   # int32 [nb]  (appended slots incl. tombstones)

    @property
    def n_buckets(self) -> int:
        return self.sig.shape[0]

    @property
    def chain_slots(self) -> int:
        return self.sig.shape[1]


def create(capacity: int, cfg, device) -> HashIndex:
    """Size the table so expected occupancy is cfg.load_factor."""
    cs = cfg.slots_per_bucket * cfg.max_chain
    nb = next_pow2(max(8, int(capacity / (cs * cfg.load_factor) + 1)))
    return HashIndex(
        sig=torch.zeros((nb, cs), dtype=I32, device=device),
        fp=torch.zeros((nb, cs), dtype=I32, device=device),
        addr=torch.full((nb, cs), -1, dtype=I32, device=device),
        fill=torch.zeros((nb,), dtype=I32, device=device),
    )


def descriptors(idx: HashIndex, keys):
    """Probe descriptors (bucket, signature, fingerprint), int32, of the
    plain probe below and of the legacy kernel's dispatch
    (``ops.hash_probe``)."""
    return hashing.descriptors(keys, idx.sig.shape[0])


def _first_true(mask):
    """Index of the first True along dim 1 (0 when none): JAX's argmax
    over a bool row."""
    return torch.argmax(mask.to(torch.uint8), dim=1)


def _match(idx: HashIndex, b, sig, fp):
    """Probe the chain rows of buckets ``b`` for (sig, fp).  Returns
    (found, slot_flat, addr, off)."""
    cs = idx.sig.shape[1]
    bl = b.long()
    match = (idx.sig[bl] == sig[:, None]) & (idx.fp[bl] == fp[:, None])
    found = match.any(dim=1)
    off = _first_true(match)                       # int64
    addr = torch.where(found, idx.addr[bl, off], -1)
    return found, bl * cs + off, addr, off


def _locate(idx: HashIndex, keys):
    """Vectorized probe.  Returns (found, slot_flat, addr, bucket, off,
    sig, fp)."""
    b, sig, fp = descriptors(idx, keys)
    found, slot_flat, addr, off = _match(idx, b, sig, fp)
    return found, slot_flat, addr, b, off, sig, fp


def probe_rows(idx: HashIndex, b, sig, fp, cfg):
    """GET probe from descriptors (bucket, sig, fp).  Returns (addr [Q]
    int32, found [Q] bool, n_accesses [Q] int32).  A hit costs the
    sub-bucket holding the slot; a miss costs every occupied sub-bucket
    (at least 1)."""
    S = cfg.slots_per_bucket
    found, _, addr, off = _match(idx, b, sig, fp)
    occupied = torch.clamp(idx.fill[b.long()], min=1)
    acc_hit = (off // S + 1).to(I32)
    acc_miss = (occupied + S - 1) // S
    n_acc = torch.where(found, acc_hit, acc_miss)
    return addr, found, n_acc


def lookup(idx: HashIndex, keys, cfg):
    """GET probe of ``keys`` (see probe_rows)."""
    return probe_rows(idx, *descriptors(idx, keys), cfg)


def dedupe_last(keys):
    """Mask of entries that are the LAST occurrence of their key.  The
    JAX version's ``lexsort((pos, keys))`` with pos = arange is one
    stable sort by key."""
    k_s, order = torch.sort(keys, stable=True)
    is_last_sorted = torch.cat(
        [k_s[1:] != k_s[:-1],
         torch.ones((1,), dtype=torch.bool, device=keys.device)])
    live = torch.empty_like(is_last_sorted)
    live[order] = is_last_sorted
    return live


def dedupe_last_valid(keys, valid):
    """dedupe_last over the valid lanes of a padded batch: invalid lanes
    get unique placeholder keys (< -1, outside the application key
    space) so they never shadow a valid lane."""
    Q = keys.shape[0]
    ph = -(torch.arange(Q, dtype=keys.dtype, device=keys.device) + 2)
    return dedupe_last(torch.where(valid, keys, ph)) & valid


def insert(idx: HashIndex, keys, addrs, cfg, valid=None):
    """Batched PUT/UPDATE.  Last-wins within the batch; updates in place
    if the key exists, else places at the bucket's first free slot
    (tombstones are reused before the virgin tail).  Returns (idx, ok
    [Q]); ok=False means the chain overflowed.  ``valid=False`` lanes
    are ignored and report ok=True.

    The JAX version argsorts the free-slot map of every bucket; only the
    rows of this batch's buckets are ever read, so only those rows are
    sorted here.  Each row is the same row computation, so the slots
    chosen are identical."""
    nb, cs = idx.sig.shape
    Q = keys.shape[0]
    dev = keys.device
    live = dedupe_last(keys) if valid is None else dedupe_last_valid(
        keys, valid)
    found, slot_flat, _, b, _, sig, fp = _locate(idx, keys)

    # in-place update of existing keys
    upd = found & live
    addr_flat = drop_set(idx.addr, torch.where(upd, slot_flat, BIG), addrs)

    # place new keys: rank within bucket among accepted new entries; the
    # rank-th entry takes the bucket's rank-th free slot
    new = ~found & live
    b_for_sort = torch.where(new, b, nb)          # push non-new to the end
    b_s, order = torch.sort(b_for_sort, stable=True)
    start = torch.searchsorted(b_s, b_s)          # first idx of each run
    rank = torch.arange(Q, device=dev) - start
    b_c = torch.clamp(b_s, 0, nb - 1).long()
    # free-slot rows of the batch's buckets: tombstones (low offsets,
    # reused first) and the virgin tail beyond fill
    virgin = (torch.arange(cs, device=dev)[None, :]
              >= idx.fill[b_c][:, None])
    freeslot = (idx.sig[b_c] == TOMBSTONE) | virgin             # [Q, cs]
    free_order = torch.argsort((~freeslot).to(torch.uint8), dim=1,
                               stable=True)
    nfree = freeslot.sum(dim=1)
    off = free_order.gather(1, torch.clamp(rank, 0, cs - 1)[:, None])[:, 0]
    ok_s = (b_s < nb) & (rank < nfree)
    slot_s = torch.where(ok_s, b_c * cs + off, BIG)
    sig_flat = drop_set(idx.sig, slot_s, sig[order])
    fp_flat = drop_set(idx.fp, slot_s, fp[order])
    addr_flat = drop_set(addr_flat, slot_s, addrs[order])
    # fill still counts the appended prefix (incl. tombstones): reused
    # slots sit below it, virgin placements extend it
    fill = drop_amax(idx.fill, torch.where(ok_s, b_s, nb), off + 1)

    ok = torch.empty_like(ok_s)
    ok[order] = ok_s
    ok = ok | upd | ~live                      # dup-superseded entries: ok
    return HashIndex(sig_flat, fp_flat, addr_flat, fill), ok


def delete(idx: HashIndex, keys, cfg, valid=None):
    """Batched DELETE: tombstone the slot.  ``valid=False`` lanes touch
    nothing and report found=False."""
    found, slot_flat, *_ = _locate(idx, keys)
    if valid is not None:
        found = found & valid
    tgt = torch.where(found, slot_flat, BIG)
    return HashIndex(drop_set(idx.sig, tgt, TOMBSTONE),
                     drop_set(idx.fp, tgt, 0),
                     drop_set(idx.addr, tgt, -1), idx.fill), found


REBUILD_CHUNK = 1 << 16


def rebuild(idx: HashIndex, keys, addrs, cfg, valid) -> HashIndex:
    """``insert(idx, keys, addrs, cfg, valid)`` for valid keys that are
    distinct and absent from ``idx`` (a sorted replica's items into a
    fresh table), in lane-order chunks of REBUILD_CHUNK valid lanes.

    The same slots as the one batch the JAX package inserts: every key is
    new (the fingerprint is a bijection of an int32 key, so no key
    matches another's slot; two int64 keys match only where their bucket,
    signature and fingerprint all collide, about 2^-62 a pair in a
    bucket), and the rank-th new key of a bucket takes
    the bucket's rank-th free slot in slot order, which is where it lands
    when the keys before it come in earlier chunks.  One batch of 2^24
    lanes would build [2^24, chain_slots] intermediates (4 GiB for the
    argsort alone); a chunk builds [REBUILD_CHUNK, chain_slots]."""
    lanes = torch.nonzero(valid).flatten()        # one host sync
    for s in range(0, lanes.shape[0], REBUILD_CHUNK):
        at = lanes[s:s + REBUILD_CHUNK]
        idx, _ = insert(idx, keys[at], addrs[at], cfg)
    return idx


def replay_pending(idx: HashIndex, log, cfg) -> HashIndex:
    """Online-recovery helper: apply a log's pending window to a
    snapshot-built hash table (net effect, last writer wins per key;
    deletes first, then puts, each in the order of the key's first
    pending entry, as the JAX package's dict gives them).  Host-side;
    batches padded to powers of two as the JAX package pads them."""
    k, a, o = lg.pending_entries_np(log)
    live = o != 0
    k, a, o = k[live], a[live], o[live]
    if len(k) == 0:
        return idx
    _, first = np.unique(k, return_index=True)
    _, last_rev = np.unique(k[::-1], return_index=True)
    last = (len(k) - 1 - last_rev)[np.argsort(first, kind="stable")]
    nk, na, no = k[last], a[last], o[last]
    dev = idx.sig.device
    dels = nk[no == OP_DEL]
    if len(dels):
        kp, vm = pad_pow2(dels, 0, dev)
        idx, _ = delete(idx, kp, cfg, vm)
    puts = no == OP_PUT
    if puts.any():
        kp, vm = pad_pow2(nk[puts], 0, dev)
        ap, _ = pad_pow2(na[puts].astype(np.int32), -1, dev)
        idx, _ = insert(idx, kp, ap, cfg, vm)
    return idx


def valid_mask(idx: HashIndex):
    return (idx.sig != 0) & (idx.sig != TOMBSTONE)


def n_items(idx: HashIndex):
    return valid_mask(idx).sum()
