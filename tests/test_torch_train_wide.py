"""The first AdamW steps at musicgen-large's full width (d_model 2048,
32 heads, d_ff 8192, vocab 2048; one layer, float32, seq 64, batch 2,
lr 3e-4), the port against the JAX package's ``train_step`` on the CPU.

At this width the loss rises over the first steps in both packages (JAX
has no warm-up, and AdamW's first step moves every element by about lr,
a rank-one change of some 40% of a matrix's spectral norm at 2048 x
8192): the port's loss and grad norm agree with JAX's within
tests/_train_parity.py's METRIC_TOL at each step, and both show the
rise.  This is why chip_smoke.py's full-width phase checks that its loss
is finite and near ln V at step 0, and checks the loss's fall on a run
at examples/train_lm_torch.py's size instead.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from _train_parity import METRIC_TOL
from repro.configs import get_config as jget_config
from repro.models import transformer as jtr
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM, make_batch
from repro_torch.optim.adamw import adamw_init
from repro_torch.train import step as tstep

LR = 3e-4


def test_full_width_first_steps_match_jax():
    kw = dict(n_layers=1, dtype="float32", attn_q_block=64,
              attn_kv_block=64)
    jcfg = jget_config("musicgen-large").scaled(**kw)
    cfg = get_config("musicgen-large").scaled(**kw)
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(0))
    model = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                      "cpu")
    ds = SyntheticLM(cfg.vocab_size, 64, 2, seed=0)
    step = jax.jit(lambda p, o, b: jstep.train_step(jcfg, p, o, b, lr=LR))
    jo, opt = jadamw.adamw_init(jp), adamw_init(convert.param_tree(model,
                                                                   cfg))
    jl, tl = [], []
    for i in range(2):
        jp, jo, jm = step(jp, jo, {k: jnp.asarray(v)
                                   for k, v in ds.batch(i).items()})
        model, opt, m = tstep.train_step(
            cfg, model, opt, make_batch(ds, i, device="cpu"), lr=LR)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       err_msg=f"step {i} {k}", **METRIC_TOL)
        jl.append(float(jm["loss"]))
        tl.append(float(m["loss"]))
    assert jl[1] > jl[0] and tl[1] > tl[0], (jl, tl)
