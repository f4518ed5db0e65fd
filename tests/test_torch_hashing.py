"""The port's key hashing held against repro.core.hashing: exact
equality on random int32 keys and the edges (0, key_inf - 1, negative)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as jh
from repro_torch.core import hashing as th


def _keys(seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.integers(0, 2 ** 31 - 1, 20000),
                           [0, 1, 2 ** 31 - 2, -1, -2 ** 31]]).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_key_mix_and_fmix32(seed):
    k = _keys(seed)
    h1, h2 = th.key_mix(torch.as_tensor(k))
    j1, j2 = jh.key_mix(jnp.asarray(k))
    np.testing.assert_array_equal(h1.numpy(), np.asarray(j1).astype(np.int64))
    np.testing.assert_array_equal(h2.numpy(), np.asarray(j2).astype(np.int64))
    x = k.astype(np.int64) & 0xFFFFFFFF
    np.testing.assert_array_equal(
        th.fmix32(torch.as_tensor(x)).numpy(),
        np.asarray(jh.fmix32(jnp.asarray(x.astype(np.uint32)))).astype(
            np.int64))


@pytest.mark.parametrize("nb", [8, 1024, 1 << 21])
def test_bucket_sig_fp(nb):
    k = _keys(nb)
    tk, jk = torch.as_tensor(k), jnp.asarray(k)
    b = th.bucket_of(tk, nb)
    assert b.dtype == torch.int32
    np.testing.assert_array_equal(b.numpy(), np.asarray(jh.bucket_of(jk, nb)))
    sig, fp = th.sig_fp_of(tk)
    jsig, jfp = jh.sig_fp_of(jk)
    np.testing.assert_array_equal(sig.numpy(), np.asarray(jsig))
    np.testing.assert_array_equal(fp.numpy(), np.asarray(jfp))
    assert fp.dtype == torch.int32 and bool((fp < 0).any())
    assert bool((sig > 0).all()) and bool((sig % 2 == 1).all())


def test_small_helpers():
    assert th.key_inf() == int(jh.key_inf()) == 2 ** 31 - 1
    assert th.key_dtype() == torch.int32
    for n in (0, 1, 2, 3, 17, 1024, 1025):
        assert th.next_pow2(n) == jh.next_pow2(n)
    arr = np.array([5, 7, 9], np.int32)
    p, v = th.pad_pow2(arr, -1, device="cpu")
    jp, jv = jh.pad_pow2(arr, -1)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
