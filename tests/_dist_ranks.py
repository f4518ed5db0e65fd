"""The rank processes' side of the port's tests over ``torch.distributed``
(``tests/test_torch_dist_ranks.py``, ``tests/test_torch_dist_selftest.py``).

``repro_torch.launch.ranks.spawn`` pickles these functions by name, so
they live in a module that a fresh process imports without JAX: each
takes (rank, world, device, ...), checks what it computes with asserts
(a failed one fails the spawn) and returns plain data.
"""
from __future__ import annotations

import functools
import json
import types
from typing import NamedTuple

import numpy as np
import torch

import _dist_battery as battery
from repro_torch.configs.histore import scaled
from repro_torch.core import kvstore as kv
from repro_torch.core import sorted_index as six
from repro_torch.core import tree, verbs
from repro_torch.core.client import DistributedBackend, HiStoreClient
from repro_torch.core.comm import Comm
from repro_torch.launch import ranks

G = 8


def _same(got, want, label):
    assert got.dtype == want.dtype, (label, got.dtype, want.dtype)
    assert tuple(got.shape) == tuple(want.shape), (label, got.shape,
                                                   want.shape)
    assert torch.equal(got, want), label


class _State(NamedTuple):
    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor


def comm_verbs(rank, world, device, seed):
    """Every verb of a Comm over ``world`` ranks against the one-process
    verb on the same global buffers (random int32, int8 and bool): the
    rank's rows of each answer equal.  Returns the collective counts."""
    comm = ranks.comm(G, device)
    one = Comm.single(G)
    g0, L = comm.g0, comm.L
    loc = comm.loc
    rng = np.random.default_rng(seed)          # the same on every rank
    c = 3
    full = {
        "i": torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31 - 1, (G, G * c),
                                          dtype=np.int32)),
        "b": torch.as_tensor(rng.random((G, G * c)) < 0.5),
        "v": torch.as_tensor(rng.integers(-9, 9, (G, G * c, 2),
                                          dtype=np.int8)),
    }
    mine = {k: loc(x) for k, x in full.items()}
    # exchange and the route back
    want = one.exchange(full)
    for k, x in comm.exchange(mine).items():
        _same(x, loc(want[k]), f"exchange {k}")
    slot = torch.as_tensor(rng.integers(0, G * c + 2, (G, 5), dtype=np.int32))
    want = verbs.route_return(full, slot, one)
    for k, x in verbs.route_return(mine, loc(slot), comm).items():
        _same(x, loc(want[k]), f"route_return {k}")
    # every shift the op bodies use: 1, r + 1, G - 1, (G - (r + 1)) % G,
    # and the whole ring
    shifts = sorted(set(range(G + 1)) | {(G - (r + 1)) % G for r in range(3)}
                    | {-1, 2 * G + 3})
    for s in shifts:
        got = comm.shift(mine, s)
        for k, x in one.shift(full, s).items():
            _same(got[k], loc(x), f"shift {s} {k}")
    # all_gather along the group axis, 0 or 1
    x = torch.as_tensor(rng.integers(0, 100, (3, G, 4), dtype=np.int32))
    _same(comm.all_gather(x[:, g0:g0 + L], 1), x, "all_gather axis 1")
    _same(comm.all_gather(loc(full["b"])), full["b"], "all_gather bool")
    _same(comm.lanes(comm.rows(torch.arange(4 * G))), torch.arange(4 * G),
          "rows -> lanes")
    # one group's state from its owner
    st = _State(full["i"], full["b"][:, 0], full["v"])
    for g in range(G):
        for got, want in zip(comm.group_leaves(_State(*map(loc, st)), g),
                             tree.at(st, g)):
            _same(got, want, f"group_leaves {g}")
    # host decisions agreed
    assert int(comm.agree(rank, "max")) == world - 1
    assert int(comm.agree(rank, "min")) == 0
    assert int(comm.agree(torch.tensor(rank + 1), "sum")) == \
        world * (world + 1) // 2
    v = comm.agree(torch.as_tensor(np.arange(G) == rank))
    assert v.tolist() == [int(g < world) for g in range(G)]
    return {k: dict(v) for k, v in comm.stats.items()}


def refused(rank, world, device):
    """The work not ported across ranks raises, naming it."""
    comm = ranks.comm(G, device)
    cfg = scaled(log_capacity=64, async_apply_batch=32)
    be = DistributedBackend(G, cfg, 64, device=device, comm=comm)
    out = {}
    for name, call in (("start_ticker", be.start_ticker),
                       ("fail_data_server", lambda: be.fail_data_server(1)),
                       ("sever_data_server", lambda: be.sever_data_server(1)),
                       ("recover_data_server",
                        lambda: be.recover_data_server(1))):
        try:
            call()
        except NotImplementedError as e:
            out[name] = str(e)
        else:
            raise AssertionError(f"{name} ran over {world} ranks")
    return out


def fail_on_rank_one(rank, world, device):
    if rank == 1:
        raise ValueError("rank one fails")
    return rank


def rank_env(comm, device):
    """The battery's env for the port over ``comm``'s ranks (its control
    plane calls bound to the comm)."""
    def own(keys):
        k = torch.as_tensor(np.asarray(keys).astype(np.int32))
        return kv.owner_group(k, G).numpy()

    bound = types.SimpleNamespace(**{
        name: functools.partial(getattr(kv, name), comm=comm)
        for name in ("fail_server", "recover_server", "parity_report")})
    return types.SimpleNamespace(
        G=G, scaled=scaled, kv=bound,
        create=lambda cap, cfg: kv.create(G, cap, cfg, device, comm),
        make_ops=lambda cfg, capacity_q, scan_limit: kv.make_ops(
            cfg, G, capacity_q, scan_limit, comm),
        make_client=lambda cfg, cap, capacity_q, scan_limit, **kw:
            HiStoreClient(DistributedBackend(
                G, cfg, cap, capacity_q=capacity_q, scan_limit=scan_limit,
                device=device, comm=comm), **kw),
        arr=lambda a: torch.as_tensor(a, device=device), own=own,
        directory_levels=six.directory_levels,
        hash_fill=lambda st, g: comm.group_leaves(st.hash, g).fill.numpy())


def battery_vs_jax(rank, world, device, npz):
    """``_dist_battery.run`` over the ranks, every op output, client
    answer and gathered store leaf held bit for bit (dtype too) against
    JAX's 8-device mesh (the ``.npz`` at ``npz``).  Returns the number of
    arrays and answers compared on this rank."""
    comm = ranks.comm(G, device)
    rec, stores = battery.run(rank_env(comm, device))
    with np.load(npz) as z:
        want = {k: z[k] for k in z.files}
    n = 0
    for k, v in rec.items():
        w = want[f"rec/{k}"]
        if v.dtype.kind == "U":
            assert json.loads(str(v)) == json.loads(str(w)), k
        else:
            assert v.dtype == w.dtype and v.shape == w.shape, (k, v.dtype,
                                                                w.dtype)
            np.testing.assert_array_equal(v, w, err_msg=k)
        n += 1
    assert sorted(rec) == sorted(k[4:] for k in want if k.startswith("rec/"))
    for name, st in stores.items():
        got = {}
        battery.leaves(kv.gathered(st, comm), name, got)
        assert sorted(got) == sorted(k for k in want
                                     if k.startswith(f"{name}/leaf/"))
        for k, v in got.items():
            assert v.dtype == want[k].dtype, (k, v.dtype, want[k].dtype)
            np.testing.assert_array_equal(v, want[k], err_msg=k)
            n += 1
    return n


def probe_case(device):
    """A store of G = 8 groups with server 5 failed and a GET chunk's
    exchange buffers rk [8, 8 c] that reach every probe path (hash hits,
    misses, the degraded lanes' replica and log windows): (cfg, store,
    rk) on ``device``."""
    cfg = scaled(log_capacity=256, async_apply_batch=64)
    ops = kv.make_ops(cfg, G, capacity_q=32)
    st = kv.create(G, 512, cfg, "cpu")
    rng = np.random.default_rng(11)
    keys = rng.choice(10 ** 6, 8 * 32, replace=False).astype(np.int32) + 1
    vals = torch.zeros((keys.size, cfg.value_words), dtype=torch.int32)
    ok = torch.ones((keys.size,), dtype=torch.bool)
    st, *_ = ops["put"](st, torch.as_tensor(keys), vals, ok)
    st = ops["apply"](st)
    st = kv.fail_server(st, 5)
    more = torch.as_tensor(keys[:128] + 7)
    st, *_ = ops["put"](st, more, vals[:128], ok[:128])
    q = torch.as_tensor(np.concatenate([keys[::2], keys[:64] + 7,
                                        keys[:64] + 9]).astype(np.int32))
    q = q.reshape(G, -1)                 # each server's lanes
    rk, _, _ = kv.get_exchange(st, q, torch.ones_like(q, dtype=torch.bool),
                               G, 32)
    return cfg, _to(st, device), rk.to(device)


def _to(x, device):
    if hasattr(x, "_fields"):
        return type(x)(*[_to(v, device) for v in x])
    return x.to(device)


def rows_of(store, g0, L):
    """The stacked (hash, bsorted, blog) of groups g0 .. g0 + L - 1."""
    h = type(store.hash)(*[x[g0:g0 + L] for x in store.hash])
    s = type(store.bsorted)(*[x[:, g0:g0 + L] for x in store.bsorted])
    b = type(store.blog)(*[x[:, g0:g0 + L] for x in store.blog])
    return h, s, b
