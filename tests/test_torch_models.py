"""The port's model path (repro_torch.configs, models, serving.serve_step,
convert) held against the JAX package at tiny sizes on the CPU.

The same weights go to both sides: JAX's ``init_params`` draws them, and
``convert.params_from_numpy`` carries them across.  Inputs come from numpy
with a seed.  Float tolerance 5e-4 (rtol and atol), as
tests/test_kernels.py:155 uses for the model path: the two sides sum in
other orders; the measured gaps are about 1e-6.  With
``ssm_impl="pallas"`` the JAX side runs its kernel in interpret mode, the
port the kernel's plain version (the CUDA kernel runs only on the card).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as jget_config
from repro.configs import layer_plan as jlayer_plan
from repro.configs.tiny import tiny_config as jtiny
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models import transformer as jtr
from repro.serving.serve_step import prefill as jprefill
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config, layer_plan
from repro_torch.configs.base import SHAPES
from repro_torch.configs.tiny import tiny_config
from repro_torch.models import layers, ssm
from repro_torch.models import transformer as tr
from repro_torch.serving import serve_step as ss

TOL = dict(rtol=5e-4, atol=5e-4)
ARCH = "falcon-mamba-7b"


def _np(a):
    return np.asarray(a, np.float32)


def _close(got, want, label=""):
    np.testing.assert_allclose(got.detach().float().numpy(), _np(want),
                               err_msg=label, **TOL)


@pytest.fixture(scope="module")
def tiny():
    """(JAX cfg, port cfg, JAX params, port Model) at tiny falcon-mamba:
    float32, 2 layers, d_model 64, state 8, chunk 8."""
    jcfg, cfg = jtiny(ARCH), tiny_config(ARCH)
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(0))
    model = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                      "cpu")
    return jcfg, cfg, jp, model


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_configs_match_jax(arch):
    """Every field and default, layer_specs and layer_plan equal JAX's,
    for the full config and its tiny twin."""
    assert ARCH_IDS == J_ARCH_IDS
    for j, t in ((jget_config(arch), get_config(arch)),
                 (jtiny(arch), tiny_config(arch))):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.layer_specs() == j.layer_specs()
        assert ([dataclasses.astuple(s) for s in layer_plan(t)]
                == [dataclasses.astuple(s) for s in jlayer_plan(j)])
        assert str(t.param_dtype).split(".")[-1] == str(j.param_dtype)


def test_config_helpers_match_jax():
    from repro.configs.base import SHAPES as JSHAPES
    j, t = jget_config(ARCH), get_config(ARCH)
    assert ({k: dataclasses.astuple(v) for k, v in SHAPES.items()}
            == {k: dataclasses.astuple(v) for k, v in JSHAPES.items()})
    opts = "ssm_impl=pallas,ssm_chunk=64,remat=none,zero1=false,norm_eps=1e-6"
    assert (dataclasses.asdict(t.with_opts(opts))
            == dataclasses.asdict(j.with_opts(opts)))
    assert t.subquadratic and t.param_dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def test_rmsnorm_embedding_logits_match_jax(tiny):
    jcfg, cfg, jp, model = tiny
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    scale = rng.standard_normal(cfg.d_model).astype(np.float32) * 0.1
    _close(layers.rmsnorm(torch.as_tensor(scale), torch.as_tensor(x),
                          cfg.norm_eps),
           jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                           jcfg.norm_eps), "rmsnorm")
    tok = rng.integers(0, cfg.vocab_size, (2, 7))
    _close(layers.embed_lookup(model.embed, torch.as_tensor(tok)),
           jlayers.embed_lookup(jp["embed"], jnp.asarray(tok)), "embed")
    got = layers.logits_from_hidden(cfg, model, torch.as_tensor(x))
    assert got.dtype == torch.float32
    _close(got, jlayers.logits_from_hidden(jcfg, jp, jnp.asarray(x)),
           "logits (tied)")
    head = rng.standard_normal((cfg.d_model, cfg.vocab_size)).astype(
        np.float32)
    ucfg, ujcfg = (c.scaled(tie_embeddings=False) for c in (cfg, jcfg))
    model.lm_head = torch.as_tensor(head)
    try:
        _close(layers.logits_from_hidden(ucfg, model, torch.as_tensor(x)),
               jlayers.logits_from_hidden(ujcfg, {"lm_head": {
                   "table": jnp.asarray(head)}}, jnp.asarray(x)),
               "logits (lm_head)")
    finally:
        del model.lm_head


def test_rope_and_mlp_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 3, 16)).astype(np.float32)
    pos = np.arange(6)[None].repeat(2, 0)
    _close(layers.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 1e4),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4), "rope")
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.2
         for k, s in (("wi", (16, 32)), ("wg", (16, 32)), ("wo", (32, 16)))}
    h = rng.standard_normal((2, 5, 16)).astype(np.float32)
    _close(layers.mlp_apply({k: torch.as_tensor(v) for k, v in p.items()},
                            torch.as_tensor(h)),
           jlayers.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(h)), "mlp")
    g = torch.Generator().manual_seed(0)
    w = layers.mlp_init(g, 16, 32, torch.bfloat16, "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in w.items()} == {
        "wi": ((16, 32), torch.bfloat16), "wg": ((16, 32), torch.bfloat16),
        "wo": ((32, 16), torch.bfloat16)}


# ---------------------------------------------------------------------------
# the Mamba-1 mixer
# ---------------------------------------------------------------------------
def _mixer(jp, model, layer=0):
    return (jax.tree.map(lambda a: a[layer], jp["stages"][0][0]["mixer"]),
            model.layers[layer].mixer)


@pytest.mark.parametrize("impl", ["jnp", "pallas", "stub"])
@pytest.mark.parametrize("B,S", [(2, 32), (1, 8), (3, 5)])
def test_mamba1_apply_matches_jax(tiny, impl, B, S):
    jcfg, cfg, jp, model = tiny
    jm, tm = _mixer(jp, model, 1)
    u = np.random.default_rng(S).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    want = jssm.mamba1_apply(jcfg.scaled(ssm_impl=impl), jm, jnp.asarray(u))
    _close(ssm.mamba1_apply(cfg.scaled(ssm_impl=impl), tm, torch.as_tensor(u)),
           want, f"mamba1_apply {impl}")


def test_mamba1_apply_raises_where_jax_raises(tiny):
    """The chunked scan needs S % min(ssm_chunk, S) == 0; the Pallas
    kernel S and d_inner multiples of 128 (or at most 128)."""
    jcfg, cfg, jp, model = tiny
    jm, tm = _mixer(jp, model)
    for impl, S, chunk in (("jnp", 12, 8), ("pallas", 130, 8)):
        u = np.zeros((1, S, cfg.d_model), np.float32)
        with pytest.raises(Exception):
            jssm.mamba1_apply(jcfg.scaled(ssm_impl=impl, ssm_chunk=chunk), jm,
                              jnp.asarray(u))
        with pytest.raises(ValueError):
            ssm.mamba1_apply(cfg.scaled(ssm_impl=impl, ssm_chunk=chunk), tm,
                             torch.as_tensor(u))
    # both run where the rules hold: S = 12 with chunk 4, S = 12 <= 128
    u = np.random.default_rng(2).standard_normal(
        (1, 12, cfg.d_model)).astype(np.float32)
    for impl in ("jnp", "pallas"):
        c = dict(ssm_impl=impl, ssm_chunk=4)
        _close(ssm.mamba1_apply(cfg.scaled(**c), tm, torch.as_tensor(u)),
               jssm.mamba1_apply(jcfg.scaled(**c), jm, jnp.asarray(u)), impl)


def test_mamba1_decode_matches_jax(tiny):
    jcfg, cfg, jp, model = tiny
    jm, tm = _mixer(jp, model)
    rng = np.random.default_rng(3)
    jc = jssm.mamba1_cache_init(jcfg, 3)
    tc = ssm.mamba1_cache_init(cfg, 3, "cpu")
    for t in range(6):
        u = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
        jy, jc = jssm.mamba1_decode(jcfg, jm, jnp.asarray(u), jc)
        ty, tc = ssm.mamba1_decode(cfg, tm, torch.as_tensor(u), tc)
        _close(ty, jy, f"decode step {t}")
        for k in ("conv", "ssm"):
            _close(tc[k], jc[k], f"cache {k} step {t}")


def test_mamba1_decode_steps_equal_apply(tiny):
    """S decode steps from a zero cache give mamba1_apply's outputs."""
    jcfg, cfg, jp, model = tiny
    _, tm = _mixer(jp, model)
    u = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32))
    full = ssm.mamba1_apply(cfg, tm, u)
    c = ssm.mamba1_cache_init(cfg, 2, "cpu")
    for t in range(16):
        y, c = ssm.mamba1_decode(cfg, tm, u[:, t:t + 1], c)
        torch.testing.assert_close(y[:, 0], full[:, t], **TOL)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_apply_model_and_prefill_match_jax(tiny, impl):
    jcfg, cfg, jp, model = tiny
    jcfg, cfg = jcfg.scaled(ssm_impl=impl), cfg.scaled(ssm_impl=impl)
    tok = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 32))
    jh, jaux = jtr.apply_model(jcfg, jp, {"tokens": jnp.asarray(tok)})
    h, aux = tr.apply_model(cfg, model, {"tokens": torch.as_tensor(tok)})
    _close(h, jh, "hidden")
    assert float(aux) == float(jaux) == 0.0
    got = ss.prefill(cfg, model, {"tokens": torch.as_tensor(tok)})
    assert got.shape == (2, cfg.vocab_size) and got.dtype == torch.float32
    _close(got, jprefill(jcfg, jp, {"tokens": jnp.asarray(tok)}), "prefill")
    torch.testing.assert_close(
        tr.hidden_to_logits(cfg, model, h[:, -1:])[:, 0], got)


def test_decode_step_matches_jax(tiny):
    """A few serve steps from a fresh cache, then from a cache carried
    across with cache_from_numpy."""
    jcfg, cfg, jp, model = tiny
    rng = np.random.default_rng(6)
    jc = jtr.init_cache(jcfg, 3, 64)
    tc = ss.make_cache(cfg, 3, 64, device="cpu")
    step = ss.make_serve_step(cfg)
    for t in range(8):
        if t == 4:
            tc = convert.cache_from_numpy(jax.tree.map(np.asarray, jc), cfg,
                                          "cpu")
        inp = {"tokens": rng.integers(0, cfg.vocab_size, (3, 1)),
               "pos": np.full((3,), t, np.int32)}
        jl, jc = jtr.decode_step(jcfg, jp, jc,
                                 {k: jnp.asarray(v) for k, v in inp.items()})
        tl, tc = step(model, tc, {k: torch.as_tensor(v)
                                  for k, v in inp.items()})
        _close(tl, jl, f"decode logits step {t}")
    for layer, jl in zip(tc, convert.cache_from_numpy(
            jax.tree.map(np.asarray, jc), cfg, "cpu")):
        for k in ("conv", "ssm"):
            torch.testing.assert_close(layer[k], jl[k], **TOL)


def test_prefill_equals_decoding_the_prompt(tiny):
    """prefill's last-position logits equal the decode logits after the
    prompt fed token by token from a zero cache (the two entry points of
    the slice agree)."""
    _, cfg, _, model = tiny
    tok = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 24)))
    want = ss.prefill(cfg.scaled(ssm_impl="pallas"), model, {"tokens": tok})
    c = tr.init_cache(cfg, 2, 64, device="cpu")
    for t in range(24):
        logits, c = tr.decode_step(cfg, model, c, {
            "tokens": tok[:, t:t + 1], "pos": torch.full((2,), t)})
    torch.testing.assert_close(logits, want, **TOL)


def test_params_from_numpy_unstacks_the_scanned_stage(tiny):
    jcfg, cfg, jp, model = tiny
    assert [s.kind for s in layer_plan(cfg)] == ["scan"]
    assert tr.count_params(model) == jtr.count_params(jp)
    for r, block in enumerate(model.layers):
        for k, a in jp["stages"][0][0]["mixer"].items():
            np.testing.assert_array_equal(block.mixer[k].numpy(),
                                          np.asarray(a[r]))
        np.testing.assert_array_equal(
            block.ln1.numpy(), np.asarray(jp["stages"][0][0]["ln1"]["scale"][r]))
    assert not any(p.requires_grad for p in model.parameters())


def test_params_from_numpy_bf16_bits():
    """bf16 leaves carry across bit for bit."""
    jcfg = jtiny(ARCH, dtype="bfloat16")
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(1))
    model = convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                      tiny_config(ARCH, dtype="bfloat16"),
                                      "cpu")
    assert model.embed.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        model.embed.view(torch.int16).numpy(),
        np.asarray(jp["embed"]["table"]).view(np.int16))
    assert model.layers[1].mixer["A_log"].dtype == torch.float32


def test_model_init_shapes_match_jax():
    """The port's own initialiser builds JAX's shapes and dtypes (its
    numbers differ: another generator)."""
    jcfg, cfg = jtiny(ARCH, dtype="bfloat16"), tiny_config(ARCH,
                                                           dtype="bfloat16")
    jshape = jax.eval_shape(lambda k: jtr.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    g = torch.Generator().manual_seed(0)
    model = tr.init_params(cfg, g, device="cpu")
    a = convert.params_from_numpy(
        jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jshape), cfg,
        "cpu")
    assert ({k: (tuple(v.shape), v.dtype) for k, v in a.state_dict().items()}
            == {k: (tuple(v.shape), v.dtype)
                for k, v in model.state_dict().items()})
    again = tr.Model(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(x, y) for x, y in zip(model.parameters(),
                                                 again.parameters()))


def test_unported_layers_raise():
    """No family is left unported (zamba2's Mamba-2 and shared block,
    ROADMAP.md A3.2; deepseek-v2-lite's MLA and the MoE of it and kimi-k2,
    A3.3): every config's tiny twin builds with JAX's parameter count,
    and its init_cache, apply_model and decode_step answer with JAX's
    shapes.  What raises is what JAX raises on: a layer spec it does not
    know (ValueError in its _block_init)."""
    for arch in J_ARCH_IDS:
        jcfg, cfg = jtiny(arch), tiny_config(arch)
        model = tr.Model(cfg, device="cpu")
        jshape = jax.eval_shape(lambda k: jtr.init_params(jcfg, k),
                                jax.random.PRNGKey(0))
        assert tr.count_params(model) == jtr.count_params(jshape), arch
        cache = tr.init_cache(cfg, 2, 8, device="cpu")
        want = convert.cache_from_numpy(
            jax.tree.map(np.asarray, jtr.init_cache(jcfg, 2, 8)), cfg, "cpu")
        assert (jax.tree.map(lambda t: (tuple(t.shape), t.dtype), cache)
                == jax.tree.map(lambda t: (tuple(t.shape), t.dtype), want))
        if cfg.frontend == "token":
            inp = {"tokens": torch.zeros((2, 8), dtype=torch.int64)}
        else:
            inp = {"embeds": torch.zeros((2, 8, cfg.d_model))}
        h, aux = tr.apply_model(cfg, model, inp)
        assert h.shape == (2, 8, cfg.d_model) and aux.shape == ()
        step = {k: v[:, :1] for k, v in inp.items()}
        step["pos"] = torch.zeros((2,), dtype=torch.int32)
        logits, _ = tr.decode_step(cfg, model, cache, step)
        assert logits.shape == (2, cfg.vocab_size)
    bad = "rnn"
    with pytest.raises(ValueError):
        jtr.init_params(jtiny(ARCH, mamba_version=0, attn_kind=bad),
                        jax.random.PRNGKey(0))
    for fn in (lambda c: tr.Model(c, device="cpu"),
               lambda c: tr.init_cache(c, 2, 8, device="cpu")):
        with pytest.raises(ValueError, match="unknown layer spec"):
            fn(tiny_config(ARCH, mamba_version=0, attn_kind=bad))


def test_entry_points_default_to_cuda():
    """Model, init_params, init_cache and params_from_numpy run on the
    card unless a device is named; here there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tiny_config(ARCH)
    for fn in (lambda: tr.Model(cfg), lambda: tr.init_params(cfg),
               lambda: tr.init_cache(cfg, 2, 8),
               lambda: convert.params_from_numpy({}, cfg)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn()
