"""Append-only update log (paper §3.2.2), port of ``repro/core/log.py``.

Each entry is {key, value address, op}; the paper's per-entry
"isApplied" mark is the ``applied`` prefix pointer.  The log is a ring:
capacity bounds the number of pending (appended, unapplied) entries.
``tail`` and ``applied`` are 0-d int32 tensors on the log's device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.hashing import I32, key_dtype, key_inf
from repro_torch.core.scatter import drop_set


class UpdateLog(NamedTuple):
    keys: torch.Tensor     # int32 [cap]
    addrs: torch.Tensor    # int32 [cap]
    ops: torch.Tensor      # int8  [cap]   (0 invalid / 1 PUT / 2 DEL)
    tail: torch.Tensor     # int32 scalar: total appended
    applied: torch.Tensor  # int32 scalar: prefix applied to the sorted index


def create(capacity: int, device, dtype=None) -> UpdateLog:
    return UpdateLog(
        keys=torch.zeros((capacity,), dtype=dtype or key_dtype(),
                         device=device),
        addrs=torch.full((capacity,), -1, dtype=I32, device=device),
        ops=torch.zeros((capacity,), dtype=torch.int8, device=device),
        tail=torch.zeros((), dtype=I32, device=device),
        applied=torch.zeros((), dtype=I32, device=device),
    )


def append(log: UpdateLog, keys, addrs, ops, valid=None) -> tuple:
    """Append a batch.  Returns (log, ok): ok=False entries were rejected
    because the pending window would overflow (engine must drain first)."""
    if valid is None:
        valid = torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    new, ok = append_rows(UpdateLog(*[a[None] for a in log]), keys[None],
                          addrs[None], ops[None], valid[None])
    return UpdateLog(*[a[0] for a in new]), ok[0]


def append_rows(logs: UpdateLog, keys, addrs, ops, valid) -> tuple:
    """``append`` on D logs stacked along a leading axis (leaves [D, cap],
    tail and applied [D]) with one batch per log (keys [D, n]): the same
    row computation for every log at once."""
    D, cap = logs.keys.shape
    dev = logs.keys.device
    offsets = torch.cumsum(valid.to(I32), 1, dtype=I32) - 1
    tail = logs.tail[:, None]
    fits = valid & ((tail - logs.applied[:, None]) + offsets + 1 <= cap)
    rows = torch.arange(D, device=dev)[:, None] * cap
    slot = torch.where(fits, rows + (tail + offsets) % cap, D * cap)
    new = UpdateLog(
        keys=drop_set(logs.keys, slot, keys),
        addrs=drop_set(logs.addrs, slot, addrs),
        ops=drop_set(logs.ops, slot, torch.where(fits, ops, 0)),
        tail=logs.tail + fits.sum(1, dtype=I32),
        applied=logs.applied,
    )
    return new, fits | ~valid


def clear(log: UpdateLog) -> UpdateLog:
    """Empty-like log (same shapes/dtypes)."""
    return UpdateLog(
        keys=torch.zeros_like(log.keys),
        addrs=torch.full_like(log.addrs, -1),
        ops=torch.zeros_like(log.ops),
        tail=torch.zeros_like(log.tail),
        applied=torch.zeros_like(log.applied),
    )


def pending_count(log: UpdateLog):
    return log.tail - log.applied


def pending_lookup(log: UpdateLog, keys):
    """Newest-wins lookup over the pending window [applied, tail).
    Returns (hit [Q] bool, op [Q], addr [Q]): op/addr are the LAST
    pending entry for each hit key."""
    cap = log.keys.shape[0]
    dev = log.keys.device
    seq = log.applied + torch.arange(cap, dtype=I32, device=dev)
    idx = (seq % cap).long()
    pv = seq < log.tail
    pk = torch.where(pv, log.keys[idx], key_inf(log.keys.dtype))
    m = pk[None, :] == keys[:, None]                  # [Q, cap]
    hit = m.any(dim=1)
    last = (cap - 1) - torch.argmax(m.flip(1).to(torch.uint8), dim=1)
    op = torch.where(hit, log.ops[idx][last], 0).to(log.ops.dtype)
    addr = log.addrs[idx][last]
    return hit, op, addr


def pending_entries_np(log: UpdateLog):
    """Host view of the pending window [applied, tail) in append order
    (keys, addrs, ops as numpy)."""
    cap = int(log.keys.shape[0])
    applied, tail = int(log.applied), int(log.tail)
    idx = (applied + np.arange(tail - applied)) % cap
    return (log.keys.cpu().numpy()[idx], log.addrs.cpu().numpy()[idx],
            log.ops.cpu().numpy()[idx])


def take_pending(log: UpdateLog, batch: int):
    """Gather up to ``batch`` oldest pending entries (static shape).
    Returns (keys, addrs, ops(0 for empty), new_log with applied
    advanced)."""
    cap = log.keys.shape[0]
    dev = log.keys.device
    n = torch.clamp(pending_count(log), max=batch)
    ar = torch.arange(batch, dtype=I32, device=dev)
    idx = ((log.applied + ar) % cap).long()
    live = ar < n
    keys = torch.where(live, log.keys[idx], 0)
    addrs = torch.where(live, log.addrs[idx], -1)
    ops = torch.where(live, log.ops[idx], 0).to(torch.int8)
    new = log._replace(applied=log.applied + n)
    return keys, addrs, ops, new
