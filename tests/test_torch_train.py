"""The port's training step (repro_torch.train.step, optim.adamw,
convert.param_tree / params_to_numpy) held against the JAX package on
the CPU at tiny sizes: the dense family (musicgen-large, mistral-nemo-12b,
gemma3-27b's local/global pattern, internvl2-76b's embed frontend) and
Mamba-1 (falcon-mamba-7b, ``ssm_impl="jnp"``); the tolerances are
tests/_train_parity.py's.  The other families are
tests/test_torch_train_families.py.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _family_parity import model_pair
from _train_parity import check_train_parity
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.data.pipeline import SyntheticLM, make_batch
from repro_torch.optim.adamw import adamw_init
from repro_torch.pytree import leaves
from repro_torch.train import step as tstep


@pytest.mark.parametrize("arch", ["musicgen-large", "mistral-nemo-12b",
                                  "gemma3-27b", "internvl2-76b",
                                  "falcon-mamba-7b"])
def test_loss_grads_and_steps_match_jax(arch):
    check_train_parity(arch)


def test_remat_gives_the_same_gradients():
    """remat="unit" (each layer checkpointed) and "none" give the same
    loss and gradients bit for bit on the CPU: the recompute repeats
    the forward's operations exactly."""
    out = []
    for remat in ("unit", "none"):
        _, cfg, _, model = model_pair("gemma3-27b", remat=remat)
        ds = SyntheticLM(cfg.vocab_size, 32, 2, seed=2)
        loss, _, grads = tstep.value_and_grad(
            cfg, model, make_batch(ds, 0, device="cpu"))
        out.append([loss] + leaves(grads))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_params_to_numpy_inverts_params_from_numpy():
    """The way back gives JAX's tree: the same paths, shapes, dtypes and
    values, the scanned stages restacked; the AdamW state round-trips."""
    jcfg, cfg, jp, model = model_pair("gemma3-27b")
    back = convert.params_to_numpy(model, cfg)
    want = jax.tree_util.tree_flatten_with_path(jp)
    got = jax.tree_util.tree_flatten_with_path(back)
    assert want[1] == got[1]
    for (path, w), (_, g) in zip(want[0], got[0]):
        assert g.dtype == np.asarray(w).dtype, path
        np.testing.assert_array_equal(g, np.asarray(w))
    rng = np.random.default_rng(0)
    jo = {"m": jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), back), "v": jax.tree.map(lambda a: rng.random(
            a.shape).astype(np.float32), back), "step": np.int32(5)}
    opt = convert.opt_from_numpy(jo, model, cfg)
    assert opt["step"].dtype == torch.int32 and int(opt["step"]) == 5
    rt = convert.opt_to_numpy(opt)
    assert jax.tree.structure(rt) == jax.tree.structure(jo)
    for a, b in zip(jax.tree.leaves(rt), jax.tree.leaves(jo)):
        np.testing.assert_array_equal(a, b)


def test_ignored_targets_drop_out():
    """Targets of -1 leave both the sum and the count: the loss over a
    batch with half its targets -1 is JAX's, and with every target -1
    it is 0 (sum / max(n_valid, 1))."""
    jcfg, cfg, jp, model = model_pair("musicgen-large")
    b = SyntheticLM(cfg.vocab_size, 32, 2, seed=4).batch(0)
    b["targets"][:, ::2] = -1
    for tg in (b["targets"], np.full_like(b["targets"], -1)):
        bb = dict(b, targets=tg)
        jl, _ = jstep.loss_fn(jcfg, jp, {k: jnp.asarray(v)
                                         for k, v in bb.items()})
        with torch.no_grad():
            tl, _ = tstep.loss_fn(cfg, model, {k: torch.as_tensor(v)
                                               for k, v in bb.items()})
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5,
                                   atol=1e-6)
    assert float(tl) == 0.0


def test_fused_scan_refuses_training_in_both_packages():
    """ssm_impl="pallas": JAX's grad fails inside the kernel's jvp; the
    port raises a ValueError that says why, from loss_fn, train_step and
    train, and does not switch to the chunked scan."""
    jcfg, cfg, jp, model = model_pair("falcon-mamba-7b", ssm_impl="pallas")
    b = SyntheticLM(cfg.vocab_size, 32, 2).batch(0)
    with pytest.raises(Exception):
        jax.grad(lambda p: jstep.loss_fn(
            jcfg, p, {k: jnp.asarray(v) for k, v in b.items()})[0])(jp)
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    with pytest.raises(ValueError, match="forward-only"):
        tstep.loss_fn(cfg, model, tb)
    opt = adamw_init(convert.param_tree(model, cfg))
    with pytest.raises(ValueError, match="forward-only"):
        tstep.train_step(cfg, model, opt, tb)
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.train.trainer import train
    with pytest.raises(ValueError, match="forward-only"):
        train(cfg, ShapeSpec("t", 32, 2, "train"), steps=1, device="cpu")
