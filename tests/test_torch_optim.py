"""The port's AdamW (repro_torch.optim.adamw) held against the JAX
package's on the CPU: three steps over a random tree of bf16 and float32
leaves (nested dicts, a list and a tuple), with the global-norm clip
active (gradients of norm ~60 against clip_norm 1) and inactive (norm
~0.06).

Tolerance.  The two packages do the same float32 operations one by one
(JAX runs eagerly here, so XLA fuses nothing), but a leaf's sum of
squares adds its elements in another order, so the global norm may
differ in its last bits: it is held within NORM_RTOL (4 float32 ulps).
Unclipped, the norm goes nowhere, and every parameter, m and v is held
bit for bit.  Clipped, the gradients are scaled by 1 / norm, so the
difference reaches m and v (float32, STATE_TOL: a few ulps after three
steps) and the parameters: float32 within STATE_TOL, bf16 within one
bf16 ulp (a rounding that lands the other way).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro_torch.optim import adamw
from repro_torch.pytree import leaves

NORM_RTOL = 4 * 2.0 ** -23
STATE_TOL = dict(rtol=1e-5, atol=1e-8)
BF16_ULP = dict(rtol=2.0 ** -7, atol=0)
SHAPES = {"w": ((16, 8), "bf16"), "b": ((8,), "f32"),
          "blocks": [{"wq": ((3, 8, 8), "bf16"), "scale": ((8,), "f32")},
                     {"wq": ((3, 8, 8), "bf16"), "scale": ((8,), "f32")}],
          "head": (((8, 4), "f32"), ((5,), "bf16"))}


def _draw(rng, scale):
    def one(spec):
        shape, dt = spec
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        return a.astype(ml_dtypes.bfloat16) if dt == "bf16" else a
    return jax.tree.map(one, SHAPES, is_leaf=lambda x: isinstance(x, tuple)
                        and isinstance(x[1], str))


def _torch(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _jbits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


def _agree(got, want, gscale, tol):
    if gscale < 1.0:              # unclipped: bit for bit
        np.testing.assert_array_equal(_bits(got), _jbits(want))
    else:
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("gscale", [1.0, 1e-3], ids=["clipped", "unclipped"])
def test_adamw_matches_jax_bit_for_bit(gscale):
    rng = np.random.default_rng(0)
    params = _draw(rng, 0.5)
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(_torch, params)
    js, ts = jadamw.adamw_init(jp), adamw.adamw_init(tp)
    clipped = []
    for step in range(3):
        grads = _draw(rng, gscale)
        jp, js, jn = jadamw.adamw_update(jp, jax.tree.map(jnp.asarray, grads),
                                         js, lr=1e-2)
        tp, ts, tn = adamw.adamw_update(tp, jax.tree.map(_torch, grads), ts,
                                        lr=1e-2)
        np.testing.assert_allclose(tn.numpy(), np.asarray(jn),
                                   rtol=NORM_RTOL, atol=0)
        clipped.append(float(tn) > 1.0)
        for x, y in zip(leaves(tp), jax.tree.leaves(jp)):
            bf = np.asarray(y).dtype == ml_dtypes.bfloat16
            assert x.dtype == (torch.bfloat16 if bf else torch.float32)
            _agree(x, y, gscale, BF16_ULP if bf else STATE_TOL)
        for k in ("m", "v"):
            for x, y in zip(leaves(ts[k]), jax.tree.leaves(js[k])):
                assert x.dtype == torch.float32
                _agree(x, y, gscale, STATE_TOL)
        assert ts["step"].dtype == torch.int32
        assert int(ts["step"]) == int(js["step"]) == step + 1
    assert all(clipped) if gscale == 1.0 else not any(clipped)


def test_global_norm_and_tree_order():
    """The leaves go in JAX's tree order (dicts by sorted key) on a tree
    built in unsorted order, and the global norm agrees with JAX's."""
    rng = np.random.default_rng(1)
    tree = {"z": rng.standard_normal((7, 3)).astype(np.float32),
            "a": [rng.standard_normal((5,)).astype(np.float32),
                  {"y": rng.standard_normal((2, 2)).astype(np.float32),
                   "b": rng.standard_normal((9,)).astype(np.float32)}]}
    want = jadamw.global_norm(jax.tree.map(jnp.asarray, tree))
    got = adamw.global_norm(jax.tree.map(_torch, tree))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=NORM_RTOL, atol=0)
    assert [x.shape for x in leaves(jax.tree.map(_torch, tree))] == [
        np.shape(x) for x in jax.tree.leaves(tree)]
