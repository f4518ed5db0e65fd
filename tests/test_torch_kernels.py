"""The port's kernel-dispatch surface (repro_torch.kernels.ops) held
against the JAX package's Pallas kernels.

On the CPU the port's ``probe`` / ``search`` / ``range_query`` / ``merge``
take their plain PyTorch versions; the JAX side runs its Pallas kernels
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
from repro.core import sorted_index as jsix
from repro.kernels import ops as jops
from repro_torch.configs.histore import scaled
from repro_torch.core import hash_index as hix
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


@pytest.mark.parametrize("cap,n,m", [(64, 0, 16), (512, 300, 100),
                                     (4096, 3000, 256), (300, 290, 64)])
def test_merge_matches_pallas(cap, n, m):
    """Duplicate keys in the batch (newest wins), DELETEs of present and
    absent keys, op-0 lanes, a non-power-of-two batch, and an overflowing
    apply whose size counts past cap."""
    rng = np.random.default_rng(cap + m)
    keys, js, ts = _sorted_state(rng, cap, n)
    pool = np.concatenate([keys, rng.integers(0, 10 ** 6, 64)]) if n else \
        rng.integers(0, 10 ** 6, 64)
    bk = rng.choice(pool, m).astype(np.int32)
    bk[: m // 4] = bk[m // 4: m // 2]                  # in-batch duplicates
    ba = rng.integers(0, 10 ** 5, m).astype(np.int32)
    bo = rng.choice([0, 1, 1, 2], m).astype(np.int8)
    got = ops.merge(CFG, ts, torch.as_tensor(bk), torch.as_tensor(ba),
                    torch.as_tensor(bo))
    want = jops.merge(JCFG, js, jnp.asarray(bk), jnp.asarray(ba),
                      jnp.asarray(bo))
    _eq(got, want, "merge")


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
        ops.hash_probe_cuda(x, x, x, x[None], x[None], x[None], x[:1], 8)
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
