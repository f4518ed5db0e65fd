"""Key hashing for the hybrid index (port of ``repro/core/hashing.py``).

Keys are int32.  The murmur3 ``fmix32`` mixing is uint32 arithmetic
with wrap-around; PyTorch's uint32 support is thin, so every value is
held in int64 in [0, 2**32) and each product is reduced with
``& 0xFFFFFFFF``.  A product of two such values does not fit in int64,
so the multiply is split into 16-bit halves of the constant.

A slot stores a 31-bit odd signature (never 0 = empty, never -1 =
tombstone) plus an independent 32-bit fingerprint.
"""
from __future__ import annotations

import numpy as np
import torch

I32 = torch.int32
I64 = torch.int64
M32 = 0xFFFFFFFF


def key_dtype() -> torch.dtype:
    """Canonical key dtype: int32 (the JAX package's x32 mode)."""
    return I32


def key_inf(dtype=None) -> int:
    """Max key value, reserved as the 'empty' sentinel of sorted indexes.
    Application keys must be non-negative and < key_inf."""
    return torch.iinfo(dtype or key_dtype()).max


def _mul32(x, c: int):
    """(x * c) mod 2**32 for int64 x in [0, 2**32) and a uint32 constant:
    each partial product stays below 2**48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def fmix32(x):
    """murmur3 finalizer; x: int64 tensor holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def _fmix32_int(x: int) -> int:
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & M32
    return x ^ (x >> 16)


# the high word of an int32 key is 0, so fmix32(hi ^ 0x9E3779B9) is a
# constant and ``hi ^ x`` is ``x``
_H1_SALT = _fmix32_int(0x9E3779B9)


def key_mix(keys):
    """keys: int32 -> (h1, h2), uint32 values held in int64:
    h1 = fmix32(lo ^ fmix32(hi ^ 0x9E3779B9)),
    h2 = fmix32(hi ^ fmix32(lo ^ 0x85EBCA77)), with hi = 0."""
    lo = keys.to(I64) & M32          # the two's-complement bits of the key
    return fmix32(lo ^ _H1_SALT), fmix32(fmix32(lo ^ 0x85EBCA77))


def _to_i32(x):
    """uint32 bits (int64 in [0, 2**32)) -> int32 with two's-complement
    wrap, as ``astype(int32)`` does on a uint32 array."""
    return (x - ((x >> 31) << 32)).to(I32)


def bucket_of(keys, n_buckets: int):
    """n_buckets must be a power of two."""
    h1, _ = key_mix(keys)
    return (h1 & (n_buckets - 1)).to(I32)


def _sig_fp(h1, h2):
    return (((h1 >> 1) | 1) & 0x7FFFFFFF).to(I32), _to_i32(h2)


def sig_fp_of(keys):
    """(signature, fingerprint): sig is positive odd int32 (!=0, !=-1);
    fp takes every int32 value, negative ones included."""
    return _sig_fp(*key_mix(keys))


def descriptors(keys, n_buckets: int):
    """(bucket, sig, fp) from one key mix: ``bucket_of`` and
    ``sig_fp_of`` together."""
    h1, h2 = key_mix(keys)
    return ((h1 & (n_buckets - 1)).to(I32), *_sig_fp(h1, h2))


def owner_group(keys, G: int):
    """Group routing hash of the distributed store, decorrelated from the
    bucket hash: fmix32 of the key's second mix, taken mod G as uint32
    (int32 [...], the JAX package's ``kvstore.owner_group``)."""
    _, h2 = key_mix(keys)
    return (fmix32(h2 ^ 0xA5A5A5A5) % G).to(I32)


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def pad_pow2(arr, fill, device=None):
    """Pad a 1-D host array to the next power of two.  Returns (padded
    tensor, valid mask) on ``device``."""
    arr = np.asarray(arr)
    n = len(arr)
    p = next_pow2(max(n, 1))
    out = np.full((p,), fill, arr.dtype)
    out[:n] = arr
    return (torch.as_tensor(out, device=device),
            torch.as_tensor(np.arange(p) < n, device=device))
