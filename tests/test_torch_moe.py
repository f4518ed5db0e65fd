"""The port's MLA and MoE (repro_torch.models.attention's MLA half,
repro_torch.models.moe, the MLA and MoE ``AttnBlock``s, convert.py's
nested leaves and caches) and the two MoE configs, deepseek-v2-lite-16b
(MLA + MoE) and kimi-k2-1t-a32b (GQA + MoE), held against the JAX package
on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and
the port's; whole models take JAX's ``init_params`` weights through
``convert.params_from_numpy``.  float32 tolerance: rtol and atol 1e-5
for a function (the sides sum the same products in other orders; the
measured gaps are at most 1.6e-6 on outputs up to 5), 1e-4 for a whole
model, its decode steps and its engine (measured at most 4.3e-6).  The
aux loss is JAX's within 1e-6.  The bf16 MoE case ties router rows on
purpose: the chosen experts and the aux loss must be JAX's exactly, the
output within 2 bf16 ulps (rtol and atol 1.6e-2; the sides round the
same float32 sums, in other orders, to bf16).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _family_parity import (assert_tree_close, check_engines_match,
                            model_pair, port_cache, prompt_end_logits,
                            run_engines)
from repro.configs import get_config as jget_config
from repro.configs.tiny import tiny_config as jtiny
from repro.models import attention as jat
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro.serving.serve_step import prefill as jprefill
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.tiny import tiny_config
from repro_torch.models import attention as at
from repro_torch.models import moe
from repro_torch.models import transformer as tr
from repro_torch.serving import serve_step as ss

DEEPSEEK, KIMI, ZAMBA = ("deepseek-v2-lite-16b", "kimi-k2-1t-a32b",
                         "zamba2-7b")
TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=1.6e-2, atol=1.6e-2)
# the parameter counts of the full configs (kimi-k2 on its first 2 of 61
# layers: the dense layer and one MoE layer), by JAX's init_params
FULL_COUNTS = {ZAMBA: (None, 7309292112),
               DEEPSEEK: (None, 15708450304),
               KIMI: (2, 19923635200)}


def _close(got, want, label="", tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), err_msg=label,
                               **tol)


def _port(tree):
    """A JAX leaf tree as tensors on the CPU, a norm's {"scale"} leaf as
    its tensor (the port's layout)."""
    if isinstance(tree, dict):
        if set(tree) == {"scale"}:
            return _port(tree["scale"])
        return {k: _port(v) for k, v in tree.items()}
    return convert._tensor(np.asarray(tree), "cpu")


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------
def _mla(seed=0, **kw):
    jcfg, cfg = jtiny(DEEPSEEK, **kw), tiny_config(DEEPSEEK, **kw)
    jp = jat.attn_init(jcfg, jax.random.PRNGKey(seed), "mla")
    return jcfg, cfg, jp, _port(jp)


@pytest.mark.parametrize("impl,kw", [
    ("flash", {}), ("block_skip", {"attn_block_skip": True}),
    ("naive", {"attn_impl": "naive", "v_head_dim": 24}),
    ("flash-vd24", {"v_head_dim": 24})])
def test_mla_apply_matches_jax(impl, kw):
    """MLA's prefill under the flash path (qk width 24, v width 16), the
    block-skip path and the naive oracle (which needs v width = qk
    width, as JAX's reshape does)."""
    jcfg, cfg, jp, tp = _mla(**kw)
    x = np.random.default_rng(1).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(32), (2, 32)).copy()
    want = jat.mla_apply(jcfg, jp, jnp.asarray(x), jnp.asarray(pos))
    got = at.mla_apply(cfg, tp, torch.as_tensor(x), torch.as_tensor(pos))
    _close(got, want, f"mla_apply {impl}")


def test_mla_decode_matches_jax():
    """20 decode steps into a cache of 12 positions, three rows at
    different positions (the ring wraps): the output and the cache
    ({ckv, k_rope, pos}) after every step equal JAX's."""
    jcfg, cfg, jp, tp = _mla(seed=2)
    jc = jat.mla_cache_init(jcfg, 3, 12)
    tc = at.mla_cache_init(cfg, 3, 12, "cpu")
    rng = np.random.default_rng(3)
    for t in range(20):
        x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
        pos = np.array([t, t + 3, 2 * t], np.int32)
        jy, jc = jat.mla_decode(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                                jc)
        ty, tc = at.mla_decode(cfg, tp, torch.as_tensor(x),
                               torch.as_tensor(pos), tc)
        _close(ty, jy, f"decode step {t}")
        assert_tree_close(tc, _port(jc), TOL, f"cache step {t}")


def test_mla_decode_steps_equal_apply():
    """S absorbed decode steps from an empty cache give the decompressed
    prefill's outputs."""
    _, cfg, _, tp = _mla(seed=4)
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32))
    full = at.mla_apply(cfg, tp, x, torch.arange(24).expand(2, 24))
    c = at.mla_cache_init(cfg, 2, 24, "cpu")
    for t in range(24):
        y, c = at.mla_decode(cfg, tp, x[:, t:t + 1], torch.full((2,), t), c)
        torch.testing.assert_close(y[:, 0], full[:, t], **TOL)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
def _moe(arch=DEEPSEEK, seed=3, **kw):
    jcfg, cfg = jtiny(arch, **kw), tiny_config(arch, **kw)
    jp = jmoe.moe_init(jcfg, jax.random.PRNGKey(seed))
    return jcfg, cfg, jp, _port(jp)


def _jax_keep(jcfg, jp, x):
    """JAX's kept-slot mask in its sorted order, by its own ops."""
    T = x.shape[0] * x.shape[1]
    xf = x.reshape(T, -1)
    probs = jax.nn.softmax(
        (xf @ jp["router"].astype(x.dtype)).astype(jnp.float32), -1)
    _, eidx = jax.lax.top_k(probs, jcfg.top_k)
    e_flat = eidx.reshape(-1)
    e_s = e_flat[jnp.argsort(e_flat)]
    counts = jnp.zeros((jcfg.n_experts,), jnp.int32).at[e_flat].add(1)
    rank = jnp.arange(T * jcfg.top_k) - (jnp.cumsum(counts) - counts)[e_s]
    return np.asarray(rank < jmoe._capacity(jcfg, T)), np.asarray(eidx)


@pytest.mark.parametrize("arch,kw", [
    (DEEPSEEK, {}), (DEEPSEEK, {"capacity_factor": 0.3}),
    (DEEPSEEK, {"n_shared_experts": 0}), (KIMI, {}),
    (KIMI, {"capacity_factor": 0.5})])
def test_moe_apply_matches_jax(arch, kw):
    """The output, the aux loss, the chosen experts and the kept slots:
    no drops at the default capacity, slots dropped at a small
    capacity_factor, with and without shared experts."""
    jcfg, cfg, jp, tp = _moe(arch, **kw)
    x = np.random.default_rng(0).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)
    jy, jaux = jmoe.moe_apply(jcfg, jp, jnp.asarray(x))
    ty, taux = moe.moe_apply(cfg, tp, torch.as_tensor(x))
    _close(ty, jy, f"moe {arch} {kw}")
    assert abs(float(taux) - float(jaux)) <= 1e-6
    keep, eidx = _jax_keep(jcfg, jp, jnp.asarray(x))
    _, _, teidx, _ = moe.route(cfg, tp, torch.as_tensor(x).reshape(64, -1))
    np.testing.assert_array_equal(teidx.numpy(), eidx)
    C = moe._capacity(cfg, 64)
    assert C == jmoe._capacity(jcfg, 64)
    tkeep = moe.dispatch_plan(cfg, teidx, C)[3]
    np.testing.assert_array_equal(tkeep.numpy(), keep)
    assert bool(keep.all()) == ("capacity_factor" not in kw)


def test_moe_ties_pick_jax_experts():
    """bf16, the router's columns 4 and 6 copies of column 1 and 7 of 2,
    so router rows tie: the lower expert first among equal
    probabilities (jax.lax.top_k's rule, which torch.topk does not
    promise), the same drops, JAX's aux loss, the output within 2 bf16
    ulps."""
    jcfg, cfg, jp, _ = _moe(dtype="bfloat16")
    r = np.array(jp["router"])
    r[:, 4] = r[:, 6] = r[:, 1]
    r[:, 7] = r[:, 2]
    jp["router"] = jnp.asarray(r)
    tp = _port(jp)
    x = np.random.default_rng(0).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x, jnp.bfloat16), torch.as_tensor(x).bfloat16()
    keep, eidx = _jax_keep(jcfg, jp, jx)
    _, probs, teidx, _ = moe.route(cfg, tp, tx.reshape(64, -1))
    top2 = torch.sort(probs, dim=-1, descending=True).values[:, :3]
    assert int((top2[:, 1] == top2[:, 2]).sum()) > 0     # ties at the cut
    np.testing.assert_array_equal(teidx.numpy(), eidx)
    tkeep = moe.dispatch_plan(cfg, teidx, moe._capacity(cfg, 64))[3]
    np.testing.assert_array_equal(tkeep.numpy(), keep)
    jy, jaux = jmoe.moe_apply(jcfg, jp, jx)
    ty, taux = moe.moe_apply(cfg, tp, tx)
    assert ty.dtype == torch.bfloat16
    assert float(taux) == float(jaux)
    _close(ty, np.asarray(jy.astype(jnp.float32)), "bf16 moe", BF16_TOL)


def test_moe_combine_adds_in_jax_order(monkeypatch):
    """The combine uses no index_add_ or scatter_add (whose order on the
    card is not fixed): with both made to raise, moe_apply answers, and
    its float32 sums equal a per-token loop over the sorted slots."""
    def refuse(*a, **k):
        raise AssertionError("an order-free scatter add")

    for name in ("index_add_", "index_add", "scatter_add_", "scatter_add"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch, "index_add", refuse)
    monkeypatch.setattr(torch, "scatter_add", refuse)
    _, cfg, _, tp = _moe(n_shared_experts=0)
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (1, 16, cfg.d_model)).astype(np.float32))
    y, _ = moe.moe_apply(cfg, tp, x)
    xf = x.reshape(16, -1)
    _, _, eidx, gate = moe.route(cfg, tp, xf)
    want = torch.zeros_like(xf)
    for t in range(16):
        for j in torch.argsort(eidx[t]).tolist():       # ascending expert
            e = int(eidx[t, j])
            h = xf[t] @ tp["e_wi"][e]
            g = xf[t] @ tp["e_wg"][e]
            want[t] = want[t] + ((h * torch.nn.functional.silu(g))
                                 @ tp["e_wo"][e]) * gate[t, j]
    torch.testing.assert_close(y.reshape(16, -1), want, **TOL)


# ---------------------------------------------------------------------------
# the two MoE configs end to end
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=[DEEPSEEK, KIMI])
def moe_model(request):
    return model_pair(request.param, seed=1)


def test_moe_model_matches_jax(moe_model):
    """apply_model's hidden states and its aux loss (the MoE layers'
    sum), prefill, then 12 decode steps from a fresh cache, the cache
    carried across from JAX's at step 6, the last caches equal."""
    jcfg, cfg, jp, model = moe_model
    assert tr.count_params(model) == jtr.count_params(jp)
    assert [(b.mla, b.moe) for b in model.layers] == [
        (s[0] == "mla", s[1] == "moe") for s in cfg.layer_specs()]
    tok = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 32))
    jh, jaux = jtr.apply_model(jcfg, jp, {"tokens": jnp.asarray(tok)})
    h, aux = tr.apply_model(cfg, model, {"tokens": torch.as_tensor(tok)})
    _close(h, jh, f"{cfg.name} hidden", MODEL_TOL)
    assert float(jaux) > 0 and abs(float(aux) - float(jaux)) <= 1e-6
    _close(ss.prefill(cfg, model, {"tokens": torch.as_tensor(tok)}),
           jprefill(jcfg, jp, {"tokens": jnp.asarray(tok)}), "prefill",
           MODEL_TOL)
    jc = jtr.init_cache(jcfg, 2, 16)
    tc = tr.init_cache(cfg, 2, 16, device="cpu")
    for t in range(12):
        if t == 6:
            tc = port_cache(jc, cfg)
        inp = {"tokens": tok[:, t:t + 1], "pos": np.array([t, t + 2],
                                                          np.int32)}
        jl, jc = jtr.decode_step(jcfg, jp, jc, {k: jnp.asarray(v)
                                                for k, v in inp.items()})
        tl, tc = tr.decode_step(cfg, model, tc, {k: torch.as_tensor(v)
                                                 for k, v in inp.items()})
        assert tl.dtype == torch.float32 and tl.shape == (2, cfg.vocab_size)
        _close(tl, jl, f"{cfg.name} decode step {t}", MODEL_TOL)
    for i, (a, b) in enumerate(zip(tc, port_cache(jc, cfg))):
        assert_tree_close(a, b, MODEL_TOL, f"layer {i}")


@pytest.mark.parametrize("arch", [DEEPSEEK, KIMI])
def test_moe_cache_and_init_shapes_match_jax(arch):
    """init_cache gives JAX's per-layer caches (MLA {ckv, k_rope, pos},
    GQA {k, v, pos}); the port's own initialiser builds JAX's shapes and
    dtypes (bf16; the router float32)."""
    jcfg, cfg = jtiny(arch), tiny_config(arch)
    for seq_len in (4, 32):
        want = port_cache(jtr.init_cache(jcfg, 3, seq_len), cfg)
        got = tr.init_cache(cfg, 3, seq_len, device="cpu")
        for i, (a, b) in enumerate(zip(got, want)):
            assert_tree_close(a, b, MODEL_TOL, f"layer {i}")
    jcfg, cfg = jtiny(arch, dtype="bfloat16"), tiny_config(
        arch, dtype="bfloat16")
    jshape = jax.eval_shape(lambda k: jtr.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    a = convert.params_from_numpy(
        jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jshape), cfg,
        "cpu")
    b = tr.Model(cfg, device="cpu")
    assert ({k: (tuple(v.shape), v.dtype) for k, v in a.state_dict().items()}
            == {k: (tuple(v.shape), v.dtype)
                for k, v in b.state_dict().items()})
    assert b.layers[1].ffn["router"].dtype == torch.float32


@pytest.mark.parametrize("arch", [ZAMBA, DEEPSEEK, KIMI])
def test_full_param_counts_match_jax(arch):
    """The full configs' parameter counts (kimi-k2 on 2 layers, the depth
    chip_smoke.py serves): the port's Model, built on the meta device,
    against jax.eval_shape over JAX's init_params, and the figure pinned
    here."""
    n_layers, count = FULL_COUNTS[arch]
    cfg, jcfg = get_config(arch), jget_config(arch)
    if n_layers:
        cfg, jcfg = cfg.scaled(n_layers=n_layers), jcfg.scaled(
            n_layers=n_layers)
    model = tr.Model(cfg, device="meta", generator=torch.Generator())
    jshape = jax.eval_shape(lambda k: jtr.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    assert tr.count_params(model) == jtr.count_params(jshape) == count


def test_unknown_layer_spec_raises():
    """A mixer JAX's _block_init does not know raises ValueError there
    and here."""
    from repro.models.transformer import _block_init
    cfg = tiny_config(DEEPSEEK)
    with pytest.raises(ValueError):
        _block_init(jtiny(DEEPSEEK), jax.random.PRNGKey(0), ("rnn", "mlp"))
    with pytest.raises(ValueError, match="unknown layer spec"):
        tr._block(cfg, ("rnn", "mlp"), torch.Generator(), "cpu")


# ---------------------------------------------------------------------------
# the serving engine on tiny deepseek
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def engines():
    return run_engines(DEEPSEEK)


def test_deepseek_engine_matches_jax(engines):
    """The port's and JAX's ServingEngine on tiny deepseek over the same
    requests: equal stats, tokens, slots and free lists, every step's
    logits and the final caches within 1e-4."""
    check_engines_match(engines, MODEL_TOL)


def test_deepseek_slot_reuse_starts_clean(engines):
    """MLA's compressed cache carries nothing over: a request in a slot
    the first wave freed gets a fresh prefill's logits after its prompt,
    in JAX's engine and the port's.  The prefill runs with
    capacity_factor = n_experts / top_k, so that no slot is dropped:
    decode (3 tokens, capacity 8) never drops one, and with drops the
    prefill computes another function, in JAX too."""
    e = engines
    reused = 0
    for r in e["reqs"][:len(e["first"])]:
        slot, got = prompt_end_logits(e["tlog"], r.rid, len(r.prompt))
        _, want = prompt_end_logits(e["jlog"], r.rid, len(r.prompt))
        n = len(r.prompt)
        one = dict(attn_q_block=n, attn_kv_block=n,
                   capacity_factor=e["cfg"].n_experts / e["cfg"].top_k)
        tok = [r.prompt]
        pre = ss.prefill(e["cfg"].scaled(**one), e["model"],
                         {"tokens": torch.as_tensor(tok)})[0].numpy()
        jpre = np.asarray(jprefill(e["jcfg"].scaled(**one), e["jp"],
                                   {"tokens": jnp.asarray(tok)}))[0]
        np.testing.assert_allclose(want, jpre, **MODEL_TOL)  # JAX's answer
        np.testing.assert_allclose(got, pre, **MODEL_TOL)
        reused += r.rid >= e["te"].B
    assert reused == 2
