"""The port's whole trainer (repro_torch.train.trainer) held against the
JAX package's on the CPU at tiny musicgen-large, float32.

Both trainers resume from one step-0 checkpoint that JAX's
``save_checkpoint`` wrote from JAX's ``init_params`` and ``adamw_init``:
JAX's ``train()`` on a 1-device Auto mesh (this jax's default Explicit
axes fail in its sharded step, ROADMAP.md section C), the port's on a
copy of the directory.  Their histories and their step-4 checkpoints
are held within tests/_train_parity.py's tolerances; m and v within
STATE_TOL of each leaf's largest magnitude (the gradients' float32
noise, as GRAD_TOL).  The port's crash and resume is held bit for bit
against its uninterrupted run.
"""
from __future__ import annotations

import shutil

import jax
import numpy as np
import pytest
import torch

from _train_parity import LR, METRIC_TOL, PARAM_ATOL, PARAM_OUTLIERS
from repro.checkpoint import checkpoint as jck
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.configs.tiny import tiny_config as jtiny
from repro.models import transformer as jtr
from repro.optim.adamw import adamw_init as jadamw_init
from repro.train.trainer import train as jtrain
from repro_torch import convert
from repro_torch.checkpoint import checkpoint as ck
from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.tiny import tiny_config
from repro_torch.train.trainer import train

ARCH = "musicgen-large"
SHAPE = ShapeSpec("tiny", 32, 4, "train")
STATE_TOL = 5e-5


def _auto_mesh():
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(
        jax.sharding.AxisType.Auto,) * 2)


def _load(path, step):
    with np.load(path / f"step_{step:08d}.npz") as z:
        return {k: z[k] for k in z.files}


def test_trainer_matches_jax_from_one_checkpoint(tmp_path):
    jcfg, cfg = jtiny(ARCH), tiny_config(ARCH)
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(0))
    jck.save_checkpoint(tmp_path / "jax", 0,
                        {"params": jp, "opt": jadamw_init(jp)})
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    kw = dict(steps=4, ckpt_every=2, lr=LR, log_every=1)
    jout = jtrain(jcfg, _auto_mesh(), JShapeSpec("tiny", 32, 4, "train"),
                  ckpt_dir=tmp_path / "jax", **kw)
    out = train(cfg, SHAPE, ckpt_dir=tmp_path / "port", device="cpu", **kw)
    jh, th = jout["history"], out["history"]
    assert [h["step"] for h in th] == [h["step"] for h in jh] == [0, 1, 2, 3]
    for a, b in zip(th, jh):
        assert set(a) == set(b)
        for k in ("loss", "ce", "aux", "grad_norm"):
            np.testing.assert_allclose(a[k], b[k], err_msg=f"{a['step']} {k}",
                                       **METRIC_TOL)
    for step in (2, 4):
        assert ck.latest_step(tmp_path / "port") == 4
        jz, tz = _load(tmp_path / "jax", step), _load(tmp_path / "port", step)
        assert list(tz) == list(jz)
        diffs = []
        for k in jz:
            assert tz[k].dtype == jz[k].dtype and tz[k].shape == jz[k].shape, k
            if k.startswith("params/"):
                diffs.append(np.abs(tz[k] - jz[k]).ravel())
            elif k == "opt/step":
                assert int(tz[k]) == int(jz[k]) == step
            else:
                np.testing.assert_allclose(
                    tz[k], jz[k], rtol=0,
                    atol=STATE_TOL * max(np.abs(jz[k]).max(), 1e-30),
                    err_msg=k)
        d = np.concatenate(diffs)
        assert d.max() <= 2 * LR * step and (
            (d > PARAM_ATOL).mean() <= PARAM_OUTLIERS), (step, d.max())


def test_crash_resume_is_the_uninterrupted_run(tmp_path, capsys):
    """Crash at step 3 after a checkpoint at 2; the restart resumes at 2
    (history from step 2), the loss goes down from there as in JAX's
    test_train_loss_goes_down_and_restart_resumes, and every parameter
    and AdamW leaf equals an uninterrupted run's bit for bit."""
    cfg = tiny_config(ARCH)
    with pytest.raises(RuntimeError, match="injected failure at step 3"):
        train(cfg, SHAPE, steps=10, ckpt_dir=tmp_path / "a", ckpt_every=2,
              lr=LR, fail_at=3, log_every=1, device="cpu")
    assert ck.latest_step(tmp_path / "a") == 2
    out = train(cfg, SHAPE, steps=8, ckpt_dir=tmp_path / "a", ckpt_every=4,
                lr=LR, log_every=1, device="cpu")
    hist = out["history"]
    assert hist[0]["step"] == 2 and hist[-1]["step"] == 7
    losses = [h["loss"] for h in hist]
    assert all(np.isfinite(losses)), losses
    assert min(losses[1:]) < losses[0], losses
    assert all(h["wall_s"] >= 0 for h in hist)
    printed = capsys.readouterr().out
    assert "[train] step=2 loss=" in printed and "gnorm=" in printed
    ref = train(cfg, SHAPE, steps=8, lr=LR, log_every=100, device="cpu")
    assert ref["history"][-1]["loss"] == losses[-1]
    for a, b in ((convert.param_tree(out["model"], cfg),
                  convert.param_tree(ref["model"], cfg)),
                 (out["opt"], ref["opt"])):
        for x, y in zip(jax.tree.leaves(convert.stack_tree(a)),
                        jax.tree.leaves(convert.stack_tree(b))):
            assert torch.equal(x, y)
    assert sorted(int(p.stem.split("_")[1]) for p in
                  (tmp_path / "a").glob("step_*.npz")) == [2, 4, 8]
