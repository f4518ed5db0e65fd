"""RDMA-verb analogues over G index groups (port of
``repro/core/verbs.py``).

The JAX package runs one group per device under ``shard_map`` and maps
the paper's verbs onto collectives.  Here a ``Comm`` (``comm.py``) does:
over W ranks of a process group each holds L = G / W groups stacked
along a leading [L] axis and the verbs are collectives; on one process
(``Comm.single``, the default) the G groups are stacked on one card and
every collective is tensor indexing on that axis:

  one-sided READ / two-sided SEND -> ``route_build`` (local) +
                      ``Comm.exchange`` (an ``all_to_all``: on one
                      process a transpose of the [G, G, c] exchange
                      buffers) + ``route_return``;
  log replication  -> ``Comm.shift`` (a ``ppermute`` by +s: on one
                      process a roll along the [G] axis).

Routing is capacity-based: each device sends at most ``capacity``
entries to each destination; overflow lanes are reported to the caller,
which retries (the RPC queue-full push-back).
"""
from __future__ import annotations

import torch

from repro_torch.core.hashing import I32


def _rows(D: int, device):
    return torch.arange(D, device=device)[:, None]


def route_build(dest, payloads: dict, n_dev: int, capacity: int):
    """Pack every device's per-query payload rows into its
    [n_dev * capacity, ...] send buffer, bucketed by destination.

    dest: [D, q] destination per query of each of the D stacked devices
    (a value >= n_dev routes nowhere).  payloads: {name: (arr [D, q, ...],
    fill)}.  Returns (buffers {name: [D, n_dev * capacity, ...]}, slot
    [D, q] int32 — each query's position in its device's buffer, kept for
    the return route — and ok [D, q], False on capacity overflow).

    JAX's ``lexsort((pos, dest))`` is one stable sort on ``dest``; the
    rank of a query among its destination's queries is its position
    minus the left ``searchsorted`` of its destination."""
    D, q = dest.shape
    dev = dest.device
    nc = n_dev * capacity
    d_s, order = torch.sort(dest, dim=1, stable=True)
    start = torch.searchsorted(d_s, d_s)
    rank = torch.arange(q, device=dev)[None, :] - start
    ok_s = rank < capacity
    slot_s = torch.where(ok_s, d_s.to(torch.int64) * capacity + rank, nc)
    rows = _rows(D, dev)
    # .at[slot].set(mode="drop") per device: slots >= nc (the overflow
    # sentinel and the lanes routed nowhere) go to one extra row
    flat = torch.where(slot_s < nc, rows * nc + slot_s, D * nc).reshape(-1)
    bufs = {}
    for name, (arr, fill) in payloads.items():
        tail = tuple(arr.shape[2:])
        buf = torch.full((D * nc + 1,) + tail, fill, dtype=arr.dtype,
                         device=dev)
        buf[flat] = arr[rows, order].reshape((D * q,) + tail)
        bufs[name] = buf[:D * nc].reshape((D, nc) + tail)
    slot = torch.empty((D, q), dtype=I32, device=dev)
    slot[rows, order] = slot_s.to(I32)
    ok = torch.empty((D, q), dtype=torch.bool, device=dev)
    ok[rows, order] = ok_s
    return bufs, slot, ok


def route_return(result_bufs: dict, slot, comm):
    """Send per-request results back over ``comm``'s exchange and gather
    each query's answer (slot [L, q]; a slot past the buffer reads a
    zero row)."""
    back = comm.exchange(result_bufs)
    out = {}
    for name, arr in back.items():
        D, n = arr.shape[:2]
        pad = arr.new_zeros((D, 1) + tuple(arr.shape[2:]))
        padded = torch.cat([arr, pad], dim=1)
        out[name] = padded[_rows(D, arr.device),
                           torch.clamp(slot.to(torch.int64), 0, n)]
    return out
