"""The port's GPipe pipeline (repro_torch.train.pipeline) held against the
JAX package's, and the port's elastic self-test.

The JAX side runs in a subprocess on 4 host devices with an Auto
"stage" mesh (this jax's default Explicit axes fail in its shard_map,
ROADMAP.md section C): ``pipeline_apply`` and one
``make_pipeline_train_step`` step of JAX's self-test's toy pipeline (S =
4 stages of tanh(x @ p), M = 8 microbatches of 4 x 16).  The port runs
the same inputs on its stacked stage axis: the outputs within rtol = atol
= 2e-5 (JAX's own tolerance against serial application), the stepped
parameters and the loss within the same.  This file imports no JAX, so
its card tests run where only PyTorch is installed.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.train import elastic_selftest as st
from repro_torch.train.pipeline import make_pipeline_train_step, pipeline_apply

ROOT = Path(__file__).resolve().parents[1]
S, M, MB, D = 4, 8, 4, 16
LR = 0.1
TOL = dict(rtol=2e-5, atol=2e-5)

JAX_SIDE = r"""
import sys
import jax
import jax.numpy as jnp
import numpy as np
from repro.train.pipeline import (AXIS, make_pipeline_train_step,
                                  pipeline_apply)

S, M, MB, D, LR = 4, 8, 4, 16, 0.1
mesh = jax.make_mesh((S,), (AXIS,),
                     axis_types=(jax.sharding.AxisType.Auto,))
rng = np.random.RandomState(0)
w = rng.randn(S, D, D).astype(np.float32) * np.float32(D ** -0.5)
x = rng.randn(M, MB, D).astype(np.float32)
tgt = rng.randn(M, MB, D).astype(np.float32)


def stage_fn(p, x):
    return jnp.tanh(x @ p)


y = pipeline_apply(stage_fn, jnp.asarray(w), jnp.asarray(x), mesh)
step = make_pipeline_train_step(
    stage_fn, lambda out, t: jnp.mean((out - t) ** 2), mesh, lr=LR)
w1, loss = step(jnp.asarray(w), jnp.asarray(x), jnp.asarray(tgt))
np.savez(sys.argv[1], w=w, x=x, tgt=tgt, y=np.asarray(y),
         w1=np.asarray(w1), loss=np.asarray(loss))
"""


@pytest.fixture(scope="module")
def jax4(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax4") / "pipe.npz"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-c", JAX_SIDE, str(path)],
                       capture_output=True, text=True, cwd=ROOT, env=env,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    with np.load(path) as z:
        return {k: torch.from_numpy(z[k]) for k in z.files}


def stage_fn(p, x):
    return torch.tanh(x @ p)


def loss_fn(out, t):
    return torch.mean((out - t) ** 2)


def test_pipeline_apply_matches_jax_and_serial(jax4):
    y = pipeline_apply(stage_fn, jax4["w"], jax4["x"])
    torch.testing.assert_close(y, jax4["y"], **TOL)
    ref = jax4["x"]
    for s in range(S):
        ref = torch.tanh(ref @ jax4["w"][s])
    torch.testing.assert_close(y, ref, **TOL)


def test_pipeline_train_step_matches_jax(jax4):
    step = make_pipeline_train_step(stage_fn, loss_fn, lr=LR)
    w1, loss = step(jax4["w"], jax4["x"], jax4["tgt"])
    torch.testing.assert_close(w1, jax4["w1"], **TOL)
    torch.testing.assert_close(loss, jax4["loss"], **TOL)


def test_pipeline_params_as_a_tree():
    """A tree of stacked parameters (a dict here) steps as one tensor
    does: the schedule reads the stage count off the leaves."""
    rng = np.random.RandomState(2)
    w = torch.tensor(rng.randn(S, D, D) * D ** -0.5, dtype=torch.float32)
    b = torch.tensor(rng.randn(S, D) * 0.1, dtype=torch.float32)
    x = torch.tensor(rng.randn(M, MB, D), dtype=torch.float32)
    y = pipeline_apply(lambda p, h: torch.tanh(h @ p["w"] + p["b"]),
                       {"w": w, "b": b}, x)
    ref = x
    for s in range(S):
        ref = torch.tanh(ref @ w[s] + b[s])
    torch.testing.assert_close(y, ref, **TOL)


def test_pipeline_of_model_blocks_matches_serial():
    """The stages of chip_smoke.py's full-width run at tiny width: four of
    the model's own AttnBlocks through ``functional_call`` under vmap,
    the outputs and every parameter gradient equal to serial
    application."""
    from repro_torch.configs.tiny import tiny_config
    from repro_torch.models.transformer import AttnBlock

    cfg = tiny_config("musicgen-large")
    gen = torch.Generator().manual_seed(0)
    blocks = [AttnBlock(cfg, ("attn", "mlp"), gen, "cpu") for _ in range(S)]
    names = [k for k, _ in blocks[0].named_parameters()]
    params = {k: torch.stack([dict(b.named_parameters())[k] for b in blocks])
              .requires_grad_(True) for k in names}
    positions = torch.arange(16)[None]

    def block_fn(p, x):
        return torch.func.functional_call(blocks[0], p,
                                          (cfg, x, positions))[0]

    x = torch.randn((M, 1, 16, cfg.d_model), generator=gen)
    y = pipeline_apply(block_fn, params, x)
    g = torch.autograd.grad(y.square().sum(), list(params.values()))
    ref = []
    for m in range(M):
        h = x[m]
        for s in range(S):
            h = block_fn({k: v[s] for k, v in params.items()}, h)
        ref.append(h)
    ref = torch.stack(ref)
    g_ref = torch.autograd.grad(ref.square().sum(), list(params.values()))
    torch.testing.assert_close(y, ref, **TOL)
    for a, b in zip(g, g_ref):
        torch.testing.assert_close(a, b, **TOL)


@pytest.mark.parametrize("check", ["check_elastic", "check_pipeline",
                                   "check_compressed_dp",
                                   "check_moe_smap_parity",
                                   "check_decode_hint_parity"])
def test_elastic_selftest_cpu(check):
    getattr(st, check)(torch.device("cpu"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the pipeline and the "
                    "self-test on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.requires_cuda
def test_cuda_pipeline_matches_cpu(cuda_device):
    rng = np.random.RandomState(0)
    w = torch.tensor(rng.randn(S, D, D) * D ** -0.5, dtype=torch.float32)
    x = torch.tensor(rng.randn(M, MB, D), dtype=torch.float32)
    tgt = torch.tensor(rng.randn(M, MB, D), dtype=torch.float32)
    step = make_pipeline_train_step(stage_fn, loss_fn, lr=LR)
    w_cpu, l_cpu = step(w, x, tgt)
    w_gpu, l_gpu = step(w.to(cuda_device), x.to(cuda_device),
                        tgt.to(cuda_device))
    torch.testing.assert_close(w_gpu.cpu(), w_cpu, **TOL)
    torch.testing.assert_close(l_gpu.cpu(), l_cpu, **TOL)


@pytest.mark.requires_cuda
def test_cuda_elastic_selftest(cuda_device, capsys):
    assert st.main(["--device", "cuda"]) == 0
    assert "ELASTIC-SELFTEST-OK" in capsys.readouterr().out
