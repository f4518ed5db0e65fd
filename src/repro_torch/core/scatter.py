"""JAX's ``x.at[idx].set(v, mode="drop")`` and ``.max(v, mode="drop")``
for PyTorch, which raises on an out-of-range index instead of dropping.

The target is copied into a buffer one element longer than it; every
out-of-range lane is sent to that last element, which is then cut off.
The result is a new tensor (a view of the first ``n`` elements), so the
input stays unchanged, as in JAX.  In-range targets must be unique,
which every caller ensures (CUDA's scatter picks an arbitrary writer
among duplicates).
"""
from __future__ import annotations

import torch


def _padded(base):
    flat = base.reshape(-1)
    n = flat.shape[0]
    buf = torch.empty((n + 1,), dtype=base.dtype, device=base.device)
    buf[:n].copy_(flat)
    return buf, n


def _route(idx, n: int):
    idx = idx.to(torch.int64)
    return torch.where((idx >= 0) & (idx < n), idx, n)


def drop_set(base, idx, vals):
    """New tensor equal to ``base`` (viewed flat) with ``flat[idx] = vals``
    where ``0 <= idx < base.numel()``; other lanes are dropped."""
    buf, n = _padded(base)
    vals = torch.as_tensor(vals, dtype=base.dtype, device=base.device)
    buf.index_put_((_route(idx, n),), vals.expand(idx.shape))
    return buf[:n].view(base.shape)


def drop_amax(base, idx, vals):
    """``flat[idx] = max(flat[idx], vals)`` on in-range lanes, as a new
    tensor."""
    buf, n = _padded(base)
    buf.scatter_reduce_(0, _route(idx, n), vals.to(base.dtype), "amax",
                        include_self=True)
    return buf[:n].view(base.shape)


def drop_set_rows(base, rows, vals):
    """New [n, W] tensor equal to ``base`` with ``base[rows] = vals`` where
    ``0 <= rows < n``: JAX's ``x.at[rows].set(vals, mode="drop")`` on
    whole rows.  The rows go into an [n + 1, W] buffer, every
    out-of-range row to its last row, which is cut off."""
    n, W = base.shape
    buf = torch.empty((n + 1, W), dtype=base.dtype, device=base.device)
    buf[:n].copy_(base)
    buf.index_put_((_route(rows, n),), vals.reshape(-1, W).to(base.dtype))
    return buf[:n]
