"""The port's training substrate (repro_torch.data, optim.compression,
checkpoint) held against the JAX package on the CPU.

The data stream and the compression are numpy / float32 arithmetic that
both packages do the same way, so they are held bit for bit.  The
compressed all-reduce runs in JAX under ``shard_map`` on 8 forced host
devices (an Auto mesh, in a subprocess, since a process that imported
JAX keeps its device count), and in the port over a stacked [8, ...]
rank axis: bit for bit as well.  The JAX side runs un-jitted, as its own
``compress`` does in tests/test_train_substrate.py: under ``jax.jit``
XLA contracts the residual's multiply-subtract, ``gf - q * scale``, into
one fused multiply-add, which moves its last bit.  Checkpoints go both ways, each package
restoring the other's files exactly, with float32, bf16 and int32
leaves.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jck
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.data.pipeline import make_batch as jmake_batch
from repro.optim import compression as jcomp
from repro_torch.checkpoint import checkpoint as ck
from repro_torch.data.pipeline import SyntheticLM, make_batch
from repro_torch.optim import compression as comp

ROOT = Path(__file__).resolve().parents[1]


def _bits(a):
    """An array's bits, for bit-equality (bf16 as uint16)."""
    if torch.is_tensor(a):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        a = a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def assert_bits(got, want, label=""):
    g, w = _bits(got), _bits(want)
    assert g.dtype == w.dtype and g.shape == w.shape, label
    np.testing.assert_array_equal(g, w, err_msg=label)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("embed_dim", [0, 24], ids=["token", "embed"])
@pytest.mark.parametrize("seed,step", [(0, 0), (3, 7), (11, 123456)])
def test_synthetic_lm_bit_equal(seed, step, embed_dim):
    """Tokens, targets (the -1 pad) and embeds equal JAX's bit for bit;
    make_batch puts them on the device and casts the embeds as JAX's
    numpy cast to bf16 does."""
    args = (256, 32, 4, seed, embed_dim)
    want, got = JSyntheticLM(*args).batch(step), SyntheticLM(*args).batch(step)
    assert set(got) == set(want)
    for k in want:
        assert_bits(got[k], want[k], k)
    assert (got["targets"][:, -1] == -1).all()
    tb = make_batch(SyntheticLM(*args), step, device="cpu",
                    dtype=torch.bfloat16)
    jb = jmake_batch(JSyntheticLM(*args), step, dtype=jnp.bfloat16)
    for k in jb:
        assert_bits(tb[k], np.asarray(jb[k]), k)


def test_make_batch_defaults_to_the_card():
    """No device named: the card, which this machine lacks."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_batch(SyntheticLM(16, 4, 1), 0)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------
def test_compress_decompress_ef_state_bit_equal():
    rng = np.random.default_rng(0)
    for dtype in (np.float32, ml_dtypes.bfloat16):
        g = (rng.standard_normal((64, 32)) * 0.01).astype(dtype)
        err = (rng.standard_normal((64, 32)) * 1e-4).astype(np.float32)
        gt = (torch.from_numpy(g.view(np.int16)).view(torch.bfloat16)
              if dtype is ml_dtypes.bfloat16 else torch.from_numpy(g))
        for _ in range(3):
            jq, js, jerr = jcomp.compress(jnp.asarray(g), jnp.asarray(err))
            q, s, new = comp.compress(gt, torch.from_numpy(err))
            assert_bits(q, np.asarray(jq), "q")
            assert_bits(s, np.asarray(js), "scale")
            assert_bits(new, np.asarray(jerr), "err")
            assert_bits(comp.decompress(q, s),
                        np.asarray(jcomp.decompress(jq, js)), "decompress")
            err = np.asarray(jerr)
    tree = {"a": torch.ones((3, 2), dtype=torch.bfloat16),
            "b": [torch.ones(5)]}
    ef = comp.ef_state(tree)
    jef = jcomp.ef_state({"a": jnp.ones((3, 2), jnp.bfloat16),
                          "b": [jnp.ones(5)]})
    for x, y in zip([ef["a"], ef["b"][0]], jax.tree.leaves(jef)):
        assert_bits(x, np.asarray(y))


def test_compression_error_feedback_converges():
    """JAX's test_compression_error_feedback_converges, on the port."""
    rng = np.random.RandomState(0)
    g_true = torch.from_numpy(rng.randn(64, 32).astype(np.float32)) * 0.01
    err = torch.zeros_like(g_true)
    acc_q = torch.zeros_like(g_true)
    acc_t = torch.zeros_like(g_true)
    for _ in range(50):
        q, scale, err = comp.compress(g_true, err)
        acc_q = acc_q + comp.decompress(q, scale)
        acc_t = acc_t + g_true
    rel = float((acc_q - acc_t).abs().max() / acc_t.abs().max())
    assert rel < 0.01, rel
    assert q.dtype == torch.int8


JAX_ALLREDUCE = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.optim.compression import dp_allreduce_compressed
from repro.sharding.smap import shard_map

src, out = sys.argv[1], sys.argv[2]
z = dict(np.load(src))
mesh = jax.make_mesh((8,), ("data",),
                     axis_types=(jax.sharding.AxisType.Auto,))

def body(g, h, e, f):
    o, ne = dp_allreduce_compressed({"g": g[0], "h": h[0]},
                                    {"g": e[0], "h": f[0]}, "data")
    return o["g"][None], o["h"][None], ne["g"][None], ne["h"][None]

fn = shard_map(body, mesh, (P("data"),) * 4, (P("data"),) * 4)
res = {}
g, h, e, f = z["g"], z["h"], z["e"], z["f"]
for it in range(3):      # error feedback carried over three rounds
    og, oh, e, f = fn(g, h, e, f)
    res.update({f"og{it}": og, f"oh{it}": oh, f"e{it}": e, f"f{it}": f})
np.savez(out, **{k: np.asarray(v) for k, v in res.items()})
"""


def test_dp_allreduce_compressed_matches_shard_map(tmp_path):
    """Two leaves (one all-zero, whose scale takes the 1e-12 floor),
    8 ranks, three rounds of error feedback: the port's stacked
    all-reduce equals JAX's shard_map bit for bit."""
    rng = np.random.default_rng(1)
    src = {"g": (rng.standard_normal((8, 32, 16)) * 0.01).astype(np.float32),
           "h": np.zeros((8, 7), np.float32),
           "e": np.zeros((8, 32, 16), np.float32),
           "f": np.zeros((8, 7), np.float32)}
    np.savez(tmp_path / "in.npz", **src)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-c", JAX_ALLREDUCE,
                        str(tmp_path / "in.npz"), str(tmp_path / "out.npz")],
                       capture_output=True, text=True, cwd=ROOT, env=env,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    want = dict(np.load(tmp_path / "out.npz"))
    grads = {"g": torch.from_numpy(src["g"]), "h": torch.from_numpy(src["h"])}
    err = {"g": torch.from_numpy(src["e"]), "h": torch.from_numpy(src["f"])}
    for it in range(3):
        out, err = comp.dp_allreduce_compressed(grads, err)
        assert_bits(out["g"], want[f"og{it}"], f"round {it} g")
        assert_bits(out["h"], want[f"oh{it}"], f"round {it} h")
        assert_bits(err["g"], want[f"e{it}"], f"round {it} err g")
        assert_bits(err["h"], want[f"f{it}"], f"round {it} err h")
    ref = src["g"].mean(0)
    rel = np.abs(out["g"][0].numpy() - ref).max() / np.abs(ref).max()
    assert rel < 0.05, rel      # elastic_selftest's bound on one round


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def _tree(rng):
    f32 = rng.standard_normal((2, 3)).astype(np.float32)
    bf = rng.standard_normal((4,)).astype(ml_dtypes.bfloat16)
    i32 = rng.integers(-2 ** 31, 2 ** 31 - 1, (2,)).astype(np.int32)
    step = np.int32(17)
    return {"a": f32, "b": {"c": bf}, "t": (i32,), "s": [step]}


def _port(tree):
    """The JAX test tree as the port holds it: tensors, bf16 by bits."""
    def conv(a):
        a = np.asarray(a)
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())
    return jax.tree.map(conv, tree)


def test_checkpoint_port_to_jax(tmp_path):
    """The port writes; JAX's restore_checkpoint reads every leaf back
    bit for bit, dtypes included; the file names, keys and manifest are
    JAX's."""
    tree = _tree(np.random.default_rng(0))
    ck.save_checkpoint(tmp_path / "t", 5, _port(tree))
    jck.save_checkpoint(tmp_path / "j", 5, jax.tree.map(jnp.asarray, tree))
    for d in ("t", "j"):
        assert sorted(p.name for p in (tmp_path / d).iterdir()) == [
            "manifest.json", "manifest_00000005.json", "step_00000005.npz"]
    mt = json.loads((tmp_path / "t" / "manifest.json").read_text())
    mj = json.loads((tmp_path / "j" / "manifest.json").read_text())
    assert mt == mj
    with np.load(tmp_path / "t" / "step_00000005.npz") as zt, \
            np.load(tmp_path / "j" / "step_00000005.npz") as zj:
        assert zt.files == zj.files
        for k in zj.files:
            assert_bits(zt[k], zj[k], k)
    assert jck.latest_step(tmp_path / "t") == 5
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(
        np.shape(x), np.asarray(x).dtype), tree)
    back = jck.restore_checkpoint(tmp_path / "t", 5, like)
    for x, y in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert_bits(np.asarray(y), np.asarray(x))


def test_checkpoint_jax_to_port(tmp_path):
    """JAX writes; the port's restore_checkpoint gives tensors with every
    leaf's bits and dtype, a like tree of torch dtypes or meta tensors
    taking the place of JAX's ShapeDtypeStructs."""
    tree = _tree(np.random.default_rng(1))
    jck.save_checkpoint(tmp_path, 3, jax.tree.map(jnp.asarray, tree))
    jck.save_checkpoint(tmp_path, 9, jax.tree.map(jnp.asarray, tree))
    assert ck.latest_step(tmp_path) == 9
    assert ck.latest_step(tmp_path / "none") is None
    port = _port(tree)
    like = jax.tree.map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device="meta"), port)
    back = ck.restore_checkpoint(tmp_path, 9, like, device="cpu")
    for x, y in zip(jax.tree.leaves(port), jax.tree.leaves(back)):
        assert y.device.type == "cpu"
        assert_bits(y, x)


def test_checkpoint_port_roundtrip_and_async_snapshot(tmp_path):
    """The port's own round trip, and the async writer's snapshot: a
    tensor written in place after save() returns does not reach the
    file."""
    tree = _port(_tree(np.random.default_rng(2)))
    w = ck.AsyncCheckpointer(tmp_path)
    want = tree["a"].clone()
    w.save(4, tree)
    tree["a"].add_(1.0)             # the next step writes in place
    w.wait()
    like = jax.tree.map(lambda t: t, tree)
    back = ck.restore_checkpoint(tmp_path, 4, like, device="cpu")
    assert_bits(back["a"], want)
    assert_bits(back["b"]["c"], tree["b"]["c"])
    assert not list(tmp_path.glob(".tmp_*"))
