"""The port's verbs on the stacked [G] axis (repro_torch.core.verbs) held
against the JAX package's, on the CPU.

``route_build`` is per device in JAX: each row of the port's stacked
call must equal JAX's call on that row, bit for bit, overflow lanes and
lanes routed nowhere included.  The collectives run in JAX under
``jax.vmap(..., axis_name="kv")``, which gives ``all_to_all`` and
``ppermute`` their meaning over the mapped axis on one device.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import verbs as jverbs
from repro_torch.core import verbs
from repro_torch.core.comm import Comm


def _payloads(rng, D, q, W):
    keys = rng.integers(0, 2 ** 31 - 1, (D, q)).astype(np.int32)
    vals = rng.integers(-5, 10 ** 6, (D, q, W)).astype(np.int32)
    flag = rng.integers(0, 2, (D, q)).astype(bool)
    return {"k": (keys, 7), "v": (vals, 0), "f": (flag, False)}


@pytest.mark.parametrize("D,q,capacity", [(1, 16, 8), (4, 24, 3),
                                          (8, 64, 2), (8, 40, 16),
                                          (3, 30, 4)])
def test_route_build_matches_jax_per_device(D, q, capacity):
    """Every row against JAX's route_build on that row: destinations in
    [0, D] (D routes nowhere), overflow past ``capacity`` per
    destination."""
    rng = np.random.default_rng(D * 100 + q + capacity)
    dest = rng.integers(0, D + 1, (D, q)).astype(np.int32)
    dest[0, : capacity + 2] = 0                    # overflow on row 0
    pay = _payloads(rng, D, q, 3)
    bufs, slot, ok = verbs.route_build(
        torch.as_tensor(dest),
        {n: (torch.as_tensor(a), f) for n, (a, f) in pay.items()},
        D, capacity)
    assert slot.dtype == torch.int32 and ok.dtype == torch.bool
    assert not bool(ok[0].all())
    for d in range(D):
        jb, js, jo = jverbs.route_build(
            jnp.asarray(dest[d]),
            {n: (jnp.asarray(a[d]), f) for n, (a, f) in pay.items()},
            D, capacity)
        np.testing.assert_array_equal(slot[d].numpy(), np.asarray(js))
        np.testing.assert_array_equal(ok[d].numpy(), np.asarray(jo))
        for n in pay:
            assert bufs[n].dtype == getattr(torch, str(jb[n].dtype))
            np.testing.assert_array_equal(bufs[n][d].numpy(),
                                          np.asarray(jb[n]), err_msg=n)


def _vmapped(fn):
    return jax.vmap(fn, axis_name="kv")


@pytest.mark.parametrize("D,c", [(1, 4), (2, 3), (8, 5)])
def test_exchange_and_route_return_match_jax(D, c):
    rng = np.random.default_rng(D + c)
    a = rng.integers(-9, 9, (D, D * c)).astype(np.int32)
    b = rng.integers(-9, 9, (D, D * c, 3)).astype(np.int32)
    one = Comm.single(D)
    got = one.exchange({"a": torch.as_tensor(a), "b": torch.as_tensor(b)})
    want = _vmapped(lambda x, y: jverbs.exchange({"a": x, "b": y}, "kv"))(
        jnp.asarray(a), jnp.asarray(b))
    for n in ("a", "b"):
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))
    # the return route gathers by slot, a slot past the buffer reads 0
    slot = rng.integers(0, D * c + 3, (D, 7)).astype(np.int32)
    got = verbs.route_return({"a": torch.as_tensor(a),
                              "b": torch.as_tensor(b)},
                             torch.as_tensor(slot), one)
    want = _vmapped(lambda x, y, s: jverbs.route_return({"a": x, "b": y}, s,
                                                        "kv"))(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(slot))
    for n in ("a", "b"):
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))


@pytest.mark.parametrize("D", [1, 3, 8])
@pytest.mark.parametrize("shift", [1, 2, 7])
def test_replicate_shift_matches_jax(D, shift):
    rng = np.random.default_rng(D * 10 + shift)
    x = rng.integers(-9, 9, (D, 6)).astype(np.int32)
    m = rng.integers(0, 2, (D, 6)).astype(bool)
    one = Comm.single(D)
    got = one.shift({"x": torch.as_tensor(x), "m": torch.as_tensor(m)},
                    shift)
    want = _vmapped(lambda u, v: jverbs.replicate_shift({"x": u, "m": v},
                                                        shift, "kv"))(
        jnp.asarray(x), jnp.asarray(m))
    for n in ("x", "m"):
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))
    np.testing.assert_array_equal(
        one.shift(torch.as_tensor(x), shift).numpy(),
        np.roll(x, shift, axis=0))


def test_routed_round_trip():
    """route_build -> exchange -> route_return brings every routed lane's
    own payload back (the identity server), zeros for the rest."""
    rng = np.random.default_rng(3)
    D, q, cap = 4, 20, 4
    dest = torch.as_tensor(rng.integers(0, D + 1, (D, q)).astype(np.int32))
    keys = torch.as_tensor(rng.integers(1, 10 ** 6, (D, q)).astype(np.int32))
    bufs, slot, ok = verbs.route_build(dest, {"k": (keys, 0)}, D, cap)
    one = Comm.single(D)
    back = verbs.route_return(one.exchange(bufs), slot, one)["k"]
    routed = ok & (dest < D)
    assert torch.equal(back[routed], keys[routed])
    assert not bool(back[~routed].any())
