"""Shared helper of tests/test_torch_train.py and
tests/test_torch_train_families.py: one tiny config's loss, gradients
and three training steps, the port against the JAX package on the CPU.

JAX's side is its ``value_and_grad`` of ``loss_fn`` and its
``adamw_update`` (``train_step`` is their composition), each jitted once
and called three times; the port's is ``train/step.py``.  Both start from
the weights JAX's ``init_params`` draws (``params_from_numpy``); the
port's gradients and parameters come back through ``params_to_numpy``.

Tolerances, float32 throughout (every tiny config is float32):
  * loss, ce, aux and the grad norm: METRIC_TOL.  The two packages sum
    in other orders; the measured gaps are below 1e-6 relative.
  * each gradient leaf: within GRAD_TOL of the leaf's largest
    magnitude.  The measured worst gap is 8e-6 (tiny zamba2).
  * parameters after each step: every element within 2 * lr * steps,
    and all but PARAM_OUTLIERS of them within PARAM_ATOL.  AdamW's first
    steps move an element by about lr * sign(gradient) whatever the
    gradient's size, so an element whose gradient is within float32
    noise of zero may step the other way in the other package (at most
    2 * lr a step); every other element agrees to float32 noise.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from _family_parity import model_pair
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.data.pipeline import SyntheticLM, make_batch
from repro_torch.optim.adamw import adamw_init
from repro_torch.pytree import leaves
from repro_torch.train import step as tstep

METRIC_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = 5e-5
PARAM_ATOL = 1e-5
PARAM_OUTLIERS = 1e-3
SEQ, BATCH, STEPS, LR = 32, 2, 3, 3e-3


def check_train_parity(arch, **kw):
    jcfg, cfg, jp, model = model_pair(arch, **kw)
    ds = SyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=1,
                     embed_dim=cfg.d_model if cfg.frontend == "embed" else 0)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: jstep.loss_fn(jcfg, p, b), has_aux=True))
    upd = jax.jit(lambda p, g, o: jadamw.adamw_update(p, g, o, lr=LR))
    jo = jadamw.adamw_init(jp)
    opt = adamw_init(convert.param_tree(model, cfg))
    for step in range(STEPS):
        jb = {k: jnp.asarray(v) for k, v in ds.batch(step).items()}
        batch = make_batch(ds, step, device="cpu")
        (jl, jm), jg = vg(jp, jb)
        if step == 0:
            loss, m, grads = tstep.value_and_grad(cfg, model, batch)
            np.testing.assert_allclose(float(loss), float(jl), **METRIC_TOL)
            for k in ("ce", "aux"):
                np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                           err_msg=k, **METRIC_TOL)
            flat = jax.tree_util.tree_flatten_with_path(jg)[0]
            got = [g.numpy() for g in leaves(convert.stack_tree(grads))]
            assert len(got) == len(flat)
            for (path, want), g in zip(flat, got):
                want = np.asarray(want)
                np.testing.assert_allclose(
                    g, want, rtol=0,
                    atol=GRAD_TOL * max(np.abs(want).max(), 1e-30),
                    err_msg=f"grad {jax.tree_util.keystr(path)}")
        jp, jo, jn = upd(jp, jg, jo)
        model, opt, m = tstep.train_step(cfg, model, opt, batch, lr=LR)
        for k, want in (("loss", jl), ("ce", jm["ce"]), ("aux", jm["aux"]),
                        ("grad_norm", jn)):
            np.testing.assert_allclose(float(m[k]), float(want),
                                       err_msg=f"step {step} {k}",
                                       **METRIC_TOL)
        assert int(opt["step"]) == int(jo["step"]) == step + 1
        got = leaves(convert.params_to_numpy(model, cfg))
        want = [np.asarray(x) for x in jax.tree.leaves(jp)]
        diff = np.concatenate([np.abs(g - w).ravel()
                               for g, w in zip(got, want)])
        assert diff.max() <= 2 * LR * (step + 1), (step, diff.max())
        assert (diff > PARAM_ATOL).mean() <= PARAM_OUTLIERS, (
            step, (diff > PARAM_ATOL).sum(), diff.size)
    return jcfg, cfg
