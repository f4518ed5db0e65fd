"""RDMA-verb analogues over G index groups on one device (port of
``repro/core/verbs.py``).

The JAX package runs one group per device under ``shard_map`` and maps
the paper's verbs onto collectives.  Here the G devices' buffers are
stacked along a leading [G] axis of one tensor on one card, and every
collective becomes tensor indexing on that axis:

  one-sided READ / two-sided SEND -> ``route_build`` + ``exchange`` (an
                      ``all_to_all``: a transpose of the [G, G, c]
                      exchange buffers) + ``route_return``;
  log replication  -> ``replicate_shift`` (a ``ppermute`` by +s: a roll
                      along the [G] axis).

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


def exchange(bufs: dict):
    """``all_to_all`` of a dict of [D, D * c, ...] buffers (forward or
    reverse): device d's chunk j goes to device j's chunk d."""
    out = {}
    for name, arr in bufs.items():
        D = arr.shape[0]
        c = arr.shape[1] // D
        tail = tuple(arr.shape[2:])
        out[name] = (arr.reshape((D, D, c) + tail).transpose(0, 1)
                     .reshape(arr.shape))
    return out


def route_return(result_bufs: dict, slot):
    """Send per-request results back and gather each query's answer
    (slot [D, q]; a slot past the buffer reads a zero row)."""
    back = exchange(result_bufs)
    out = {}
    for name, arr in back.items():
        D, n = arr.shape[:2]
        pad = arr.new_zeros((D, 1) + tuple(arr.shape[2:]))
        padded = torch.cat([arr, pad], dim=1)
        out[name] = padded[_rows(D, arr.device),
                           torch.clamp(slot.to(torch.int64), 0, n)]
    return out


def replicate_shift(x, shift: int):
    """``ppermute`` by +shift along the ring of devices: device d's [d]
    slice lands at d + shift (the primary -> backup push).  ``x`` is a
    tensor or a dict of tensors stacked on a leading [D] axis."""
    if isinstance(x, dict):
        return {k: replicate_shift(v, shift) for k, v in x.items()}
    return torch.roll(x, shift, dims=0)
