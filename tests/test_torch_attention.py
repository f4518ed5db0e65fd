"""The port's dense attention family (repro_torch.models.attention, the
AttnBlock of models/transformer.py, convert.py's dense leaves) held
against the JAX package on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and
the port's.  float32 tolerance: rtol 1e-5, atol 1e-5 (the two sides sum
the same products in other orders; the measured gaps are below 5e-6).
The bf16 case is held within 2 bf16 ulps of the output (rtol and atol
1.6e-2): the sides round the same float32 probabilities to bf16 before
P @ V, and an exp one float32 ulp apart can round one bf16 ulp apart.
The bf16 model's pieces are bit-equal to JAX's run op by op; its whole
stack, which JAX compiles, is held to a stated relative 2-norm error.
Query heads share a key head in groups of G = H // Hkv, tested at G of
1, 2 and 4, since a wrong head order passes wherever G = 1.  The whole
model runs for each of the six dense configs at ``tiny_config`` sizes,
their weights drawn by JAX's ``init_params`` and carried across by
``convert.params_from_numpy``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.tiny import tiny_config as jtiny
from repro.models import attention as jat
from repro.models import transformer as jtr
from repro_torch import convert
from repro_torch.configs import layer_plan
from repro_torch.configs.tiny import tiny_config
from repro_torch.models import attention as at
from repro_torch.models import transformer as tr

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=1.6e-2, atol=1.6e-2)
DENSE = ["mistral-nemo-12b", "command-r-35b", "gemma3-27b",
         "mistral-large-123b", "internvl2-76b", "musicgen-large"]
GROUPS = [1, 2, 4]                 # G = H // Hkv, with H = 4


def _close(got, want, label="", tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), err_msg=label,
                               **tol)


def _qkv(seed, B, Sq, Skv, G, H=4, hd=16, hdv=None, dtype=np.float32):
    rng = np.random.default_rng(seed)
    hdv = hdv or hd
    q = rng.standard_normal((B, Sq, H, hd)).astype(dtype)
    k = rng.standard_normal((B, Skv, H // G, hd)).astype(dtype)
    v = rng.standard_normal((B, Skv, H // G, hdv)).astype(dtype)
    return q, k, v


def _both(*arrays):
    """(JAX arrays, torch tensors) of the same numpy arrays."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.as_tensor(a) for a in arrays])


# ---------------------------------------------------------------------------
# the attention functions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("qb,kvb", [(8, 8), (8, 4), (4, 8), (64, 64)])
def test_flash_causal_matches_jax(G, qb, kvb):
    """Causal flash attention, with blocks of q and kv equal and not (the
    port leaves out the q blocks a kv block cannot reach) and one block
    covering the whole sequence."""
    j, t = _both(*_qkv(G * 10 + qb, 2, 32, 32, G))
    want = jat.flash_attention(*j, causal=True, q_block=qb, kv_block=kvb)
    got = at.flash_attention(*t, causal=True, q_block=qb, kv_block=kvb)
    assert got.shape == (2, 32, 4, 16) and got.dtype == torch.float32
    _close(got, want, f"flash causal G={G} qb={qb} kvb={kvb}")


@pytest.mark.parametrize("G", GROUPS)
def test_flash_rect_with_stats_matches_jax(G):
    """Non-causal attention of 16 queries over 32 keys (the rectangle of
    the divide-and-conquer path), with the online-softmax stats, and a
    value width other than the key width."""
    j, t = _both(*_qkv(G, 2, 16, 32, G, hdv=8))
    want = jat.flash_attention(*j, causal=False, q_block=8, kv_block=8,
                               return_stats=True)
    got = at.flash_attention(*t, causal=False, q_block=8, kv_block=8,
                             return_stats=True)
    assert got[1].shape == got[2].shape == (2, 16, 4 // G, G)
    for name, g, w in zip(("out", "m", "l"), got, want):
        _close(g, w, f"rect {name} G={G}")


@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("S,leaf", [(64, 16), (32, 16), (16, 16)])
def test_causal_divide_conquer_matches_jax(G, S, leaf):
    j, t = _both(*_qkv(S + G, 2, S, S, G))
    want = jat.causal_divide_conquer(*j, q_block=8, leaf=leaf,
                                     return_stats=True)
    got = at.causal_divide_conquer(*t, q_block=8, leaf=leaf,
                                   return_stats=True)
    for name, g, w in zip(("out", "m", "l"), got, want):
        _close(g, w, f"divide-conquer {name} G={G} S={S}")


def test_merge_two_matches_jax():
    j, t = _both(*_qkv(3, 2, 16, 16, 2))
    jparts = [jat.flash_attention(*j, causal=c, q_block=8, kv_block=8,
                                  return_stats=True) for c in (True, False)]
    tparts = [at.flash_attention(*t, causal=c, q_block=8, kv_block=8,
                                 return_stats=True) for c in (True, False)]
    want = jat._merge_two(*jparts[0], *jparts[1], jnp.float32)
    got = at._merge_two(*tparts[0], *tparts[1], torch.float32)
    for name, g, w in zip(("out", "m", "l"), got, want):
        _close(g, w, f"merge {name}")


@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("window,qb", [(8, 8), (5, 8), (8, 4), (40, 8),
                                       (1, 8)])
def test_flash_window_matches_jax(G, window, qb):
    """Sliding-window attention: windows a multiple of the block and
    not, one wider than the sequence, one of a single key."""
    j, t = _both(*_qkv(window + G, 2, 32, 32, G))
    want = jat.flash_attention(*j, window=window, q_block=qb)
    got = at.flash_attention(*t, window=window, q_block=qb)
    _close(got, want, f"window {window} G={G} qb={qb}")


@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("window", [0, 6])
def test_naive_attention_matches_jax(G, window):
    j, t = _both(*_qkv(G + window, 2, 24, 24, G))
    want = jat._naive_attention(*j, window)
    got = at._naive_attention(*t, window)
    _close(got, want, f"naive window {window} G={G}")
    # the flash path computes the same function
    flash = at.flash_attention(*t, window=window, q_block=8, kv_block=8)
    torch.testing.assert_close(flash, got, **TOL)


def test_flash_bf16_matches_jax():
    """bf16 inputs, the casts at JAX's points: the scores and P @ V summed
    in float32, P and each output rounded to bf16 (2 bf16 ulps)."""
    q, k, v = _qkv(11, 2, 32, 32, 2)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.as_tensor(a).to(torch.bfloat16) for a in (q, k, v))
    for kw in (dict(causal=True), dict(window=8),
               dict(causal=False, return_stats=True)):
        want = jat.flash_attention(jq, jk, jv, q_block=8, kv_block=8, **kw)
        got = at.flash_attention(tq, tk, tv, q_block=8, kv_block=8, **kw)
        if kw.get("return_stats"):
            (got, gm, gl), (want, wm, wl) = got, want
            _close(gm, wm, "bf16 m")
            _close(gl, wl, "bf16 l", BF16_TOL)
        assert got.dtype == torch.bfloat16
        _close(got, np.asarray(want.astype(jnp.float32)), f"bf16 {kw}",
               BF16_TOL)


def test_block_not_dividing_raises_on_both_sides():
    """flash_attention reshapes into blocks with no padding: where JAX's
    reshape fails (Sq % q_block != 0, or Skv % kv_block), the port raises
    too."""
    for Sq, Skv, qb, kvb in ((12, 12, 8, 8), (16, 12, 8, 8)):
        j, t = _both(*_qkv(0, 1, Sq, Skv, 2))
        with pytest.raises(Exception):
            jat.flash_attention(*j, causal=False, q_block=qb, kv_block=kvb)
        with pytest.raises(ValueError, match="not a multiple"):
            at.flash_attention(*t, causal=False, q_block=qb, kv_block=kvb)
    j, t = _both(*_qkv(0, 1, 12, 12, 2))
    with pytest.raises(Exception):
        jat.flash_attention(*j, window=4, q_block=8)
    with pytest.raises(ValueError, match="not a multiple"):
        at.flash_attention(*t, window=4, q_block=8)


def test_score_chunks_change_no_bit(monkeypatch):
    """The q blocks of a kv step go in chunks of SCORE_ELEMS scores; a
    chunk of one q block gives the same bits as one chunk for all."""
    _, t = _both(*_qkv(5, 2, 32, 32, 2))
    whole = [at.flash_attention(*t, q_block=8, kv_block=8),
             at.flash_attention(*t, window=8, q_block=8)]
    monkeypatch.setattr(at, "SCORE_ELEMS", 1)
    for w, kw in zip(whole, (dict(kv_block=8), dict(window=8))):
        assert torch.equal(at.flash_attention(*t, q_block=8, **kw), w)


# ---------------------------------------------------------------------------
# the GQA block: prefill and decode
# ---------------------------------------------------------------------------
def _cfgs(G, **kw):
    kw = dict(n_kv_heads=4 // G, **kw)
    return (jtiny("mistral-nemo-12b", **kw),
            tiny_config("mistral-nemo-12b", **kw))


def _mixer(cfg, seed):
    """A mixer's weights as numpy, drawn at the config's shapes."""
    rng = np.random.default_rng(seed)
    D, H, Hkv, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
    shapes = dict(wq=(D, H * hd), wk=(D, Hkv * hd), wv=(D, Hkv * hd),
                  wo=(H * hd, D))
    return {k: (rng.standard_normal(s) * s[0] ** -0.5).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("impl,window", [
    ("flash", 0), ("block_skip", 0), ("naive", 0), ("flash", 8),
    ("naive", 8)])
def test_gqa_apply_matches_jax(G, impl, window):
    kw = ({"attn_block_skip": True} if impl == "block_skip" else
          {"attn_impl": impl})
    jcfg, cfg = _cfgs(G, **kw)
    p = _mixer(cfg, G)
    x = np.random.default_rng(G + 1).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(32), (2, 32))
    want = jat.gqa_apply(jcfg, {k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), jnp.asarray(pos), window=window)
    got = at.gqa_apply(cfg, {k: torch.as_tensor(v) for k, v in p.items()},
                       torch.as_tensor(x), torch.as_tensor(pos),
                       window=window)
    _close(got, want, f"gqa_apply {impl} window {window} G={G}")


@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("window", [0, 8])
def test_gqa_decode_matches_jax(G, window):
    """20 decode steps into a cache of 12 positions (with window 8, a ring
    of 8 slots that wraps twice), three rows at different positions: the
    output and the cache ({k, v, pos}) after every step equal JAX's."""
    jcfg, cfg = _cfgs(G)
    p = _mixer(cfg, 10 + G)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    jc = jat.gqa_cache_init(jcfg, 3, 12, window=window)
    tc = at.gqa_cache_init(cfg, 3, 12, "cpu", window=window)
    assert tc["k"].shape == tuple(jc["k"].shape) == (
        3, 8 if window else 12, 4 // G, 16)
    rng = np.random.default_rng(20 + G)
    for t in range(20):
        x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
        pos = np.array([t, t + 3, 2 * t], np.int32)
        jy, jc = jat.gqa_decode(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                                jc, window=window)
        ty, tc = at.gqa_decode(cfg, tp, torch.as_tensor(x),
                               torch.as_tensor(pos), tc, window=window)
        _close(ty, jy, f"decode step {t} G={G} window {window}")
        for k in ("k", "v"):
            _close(tc[k], jc[k], f"cache {k} step {t}")
        assert tc["pos"].dtype == torch.int32
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("window", [0, 8])
def test_gqa_decode_steps_equal_apply(window):
    """S decode steps from an empty cache give gqa_apply's outputs (the
    ring of a local layer wraps at step 8)."""
    _, cfg = _cfgs(2)
    tp = {k: torch.as_tensor(v) for k, v in _mixer(cfg, 3).items()}
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32))
    full = at.gqa_apply(cfg, tp, x, torch.arange(24).expand(2, 24),
                        window=window)
    c = at.gqa_cache_init(cfg, 2, 24, "cpu", window=window)
    for t in range(24):
        y, c = at.gqa_decode(cfg, tp, x[:, t:t + 1], torch.full((2,), t), c,
                             window=window)
        torch.testing.assert_close(y[:, 0], full[:, t], **TOL)


def test_mla_raises():
    """MLA is ported (ROADMAP.md A3.3): ``attn_init(..., "mla")`` builds
    JAX's leaves (``kv_norm`` the norm's tensor) and the flash path
    matches JAX's; what raises is what JAX raises on, the naive oracle
    where the value width (16) is not the key width (24), since both
    reshape the output to the key width (tests/test_torch_moe.py holds
    the rest of MLA)."""
    jcfg, cfg = (jtiny("deepseek-v2-lite-16b"),
                 tiny_config("deepseek-v2-lite-16b"))
    jp = jat.attn_init(jcfg, jax.random.PRNGKey(0), "mla")
    tp = at.attn_init(cfg, torch.Generator().manual_seed(0), "cpu", "mla")
    assert ({k: tuple(v.shape) for k, v in tp.items()}
            == {k: tuple((v["scale"] if k == "kv_norm" else v).shape)
                for k, v in jp.items()})
    tp = {k: torch.as_tensor(np.array(v["scale"] if k == "kv_norm" else v))
          for k, v in jp.items()}
    x = np.random.default_rng(0).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16), (2, 16)).copy()
    _close(at.mla_apply(cfg, tp, torch.as_tensor(x), torch.as_tensor(pos)),
           jat.mla_apply(jcfg, jp, jnp.asarray(x), jnp.asarray(pos)), "mla")
    naive = dict(attn_impl="naive")
    with pytest.raises(TypeError):
        jat.mla_apply(jcfg.scaled(**naive), jp, jnp.asarray(x),
                      jnp.asarray(pos))
    with pytest.raises(RuntimeError):
        at.mla_apply(cfg.scaled(**naive), tp, torch.as_tensor(x),
                     torch.as_tensor(pos))


# ---------------------------------------------------------------------------
# the whole model, each dense config
# ---------------------------------------------------------------------------
def _inputs(cfg, rng, B, S):
    if cfg.frontend == "token":
        return {"tokens": rng.integers(0, cfg.vocab_size, (B, S))}
    return {"embeds": rng.standard_normal((B, S, cfg.d_model)).astype(
        np.float32)}


def _dense(arch, **kw):
    jcfg, cfg = jtiny(arch, **kw), tiny_config(arch, **kw)
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(1))
    model = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                      "cpu")
    return jcfg, cfg, jp, model


@pytest.mark.parametrize("arch", DENSE)
def test_dense_model_matches_jax(arch):
    """apply_model's hidden states, then 12 decode steps from a fresh
    cache (a gemma3 local layer's ring of 8 wraps), the cache carried
    across from JAX's at step 6 (cache_from_numpy), the last caches
    equal."""
    jcfg, cfg, jp, model = _dense(arch)
    assert tr.count_params(model) == jtr.count_params(jp)
    assert hasattr(model, "embed") == (cfg.frontend == "token"
                                       or cfg.tie_embeddings)
    assert hasattr(model, "lm_head") == (not cfg.tie_embeddings)
    rng = np.random.default_rng(2)
    inp = _inputs(cfg, rng, 2, 32)
    jh, jaux = jtr.apply_model(jcfg, jp, {k: jnp.asarray(v)
                                          for k, v in inp.items()})
    h, aux = tr.apply_model(cfg, model, {k: torch.as_tensor(v)
                                         for k, v in inp.items()})
    _close(h, jh, f"{arch} hidden")
    assert float(aux) == float(jaux) == 0.0
    jc = jtr.init_cache(jcfg, 2, 16)
    tc = tr.init_cache(cfg, 2, 16, device="cpu")
    for t in range(12):
        if t == 6:
            tc = convert.cache_from_numpy(jax.tree.map(np.asarray, jc), cfg,
                                          "cpu")
        step = {k: v[:, t:t + 1] for k, v in inp.items()}
        step["pos"] = np.array([t, t + 2], np.int32)
        jl, jc = jtr.decode_step(jcfg, jp, jc, {k: jnp.asarray(v)
                                                for k, v in step.items()})
        tl, tc = tr.decode_step(cfg, model, tc, {k: torch.as_tensor(v)
                                                 for k, v in step.items()})
        assert tl.dtype == torch.float32 and tl.shape == (2, cfg.vocab_size)
        _close(tl, jl, f"{arch} decode step {t}")
    want = convert.cache_from_numpy(jax.tree.map(np.asarray, jc), cfg, "cpu")
    assert len(want) == len(tc) == cfg.n_layers
    for i, (a, b) in enumerate(zip(tc, want)):
        assert set(a) == set(b) == {"k", "v", "pos"}
        assert a["k"].shape == b["k"].shape
        torch.testing.assert_close(a["k"], b["k"], **TOL)
        torch.testing.assert_close(a["v"], b["v"], **TOL)
        assert torch.equal(a["pos"], b["pos"]), f"layer {i} pos"


def test_gemma3_layers_unstack_repeat_major():
    """gemma3's (local x 3, attn) pattern is one scan stage of 4 positions
    repeated twice: layer r * 4 + i takes repeat r of position i, and its
    window follows its spec."""
    jcfg, cfg, jp, model = _dense("gemma3-27b")
    (st,) = layer_plan(cfg)
    assert st.kind == "scan" and len(st.pattern) == 4 and st.n_rep == 2
    specs = cfg.layer_specs()
    for r in range(st.n_rep):
        for i, spec in enumerate(st.pattern):
            block = model.layers[r * 4 + i]
            assert specs[r * 4 + i] == spec
            assert block.window == (cfg.sliding_window if spec[0] == "local"
                                    else 0)
            src = jp["stages"][0][i]
            for g in ("mixer", "ffn"):
                for k, a in src[g].items():
                    np.testing.assert_array_equal(
                        getattr(block, g)[k].numpy(), np.asarray(a[r]))
            for n in ("ln1", "ln2"):
                np.testing.assert_array_equal(
                    getattr(block, n).numpy(), np.asarray(src[n]["scale"][r]))


def test_dense_cache_shapes_match_jax():
    """init_cache gives JAX's {k, v, pos} per layer: a local layer's ring
    min(window, seq_len) slots, a global layer's seq_len, tags -1."""
    jcfg, cfg = jtiny("gemma3-27b"), tiny_config("gemma3-27b")
    for seq_len in (4, 32):
        want = convert.cache_from_numpy(
            jax.tree.map(np.asarray, jtr.init_cache(jcfg, 3, seq_len)), cfg,
            "cpu")
        got = tr.init_cache(cfg, 3, seq_len, device="cpu")
        for a, b in zip(got, want):
            for k in ("k", "v", "pos"):
                assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])


@pytest.mark.parametrize("arch", ["gemma3-27b", "internvl2-76b"])
def test_dense_init_shapes_match_jax(arch):
    """The port's own initialiser builds JAX's shapes and dtypes (bf16;
    its numbers differ: another generator)."""
    jcfg, cfg = jtiny(arch, dtype="bfloat16"), tiny_config(arch,
                                                           dtype="bfloat16")
    jshape = jax.eval_shape(lambda k: jtr.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    a = convert.params_from_numpy(
        jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jshape), cfg,
        "cpu")
    model = tr.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    assert ({k: (tuple(v.shape), v.dtype) for k, v in a.state_dict().items()}
            == {k: (tuple(v.shape), v.dtype)
                for k, v in model.state_dict().items()})


def test_dense_bf16_model_matches_jax():
    """tiny mistral-nemo in bf16, the same weights bit for bit.  Layer
    0's pieces, JAX's run op by op: the norm, the GQA mixer (flash and
    sliding-window) and the MLP give the same bits.  The whole model: JAX
    compiles its layer stack (``lax.scan``), and XLA's fusions leave out
    bf16 roundings that the op-by-op port keeps, so most hidden values
    sit an ulp or two apart; held to a relative 2-norm error of 2e-2
    (about two bf16 ulps; measured 8.3e-3)."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers

    jcfg, cfg, jp, model = _dense("mistral-nemo-12b", dtype="bfloat16")
    tok = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 32))
    pos = np.broadcast_to(np.arange(32), (2, 32)).copy()
    lp = jax.tree.map(lambda a: a[0], jp["stages"][0][0])
    blk = model.layers[0]
    jx = jlayers.embed_lookup(jp["embed"], jnp.asarray(tok))
    tx = layers.embed_lookup(model.embed, torch.as_tensor(tok))
    jh = jlayers.rmsnorm(lp["ln1"], jx, jcfg.norm_eps)
    th = layers.rmsnorm(blk.ln1, tx, cfg.norm_eps)
    pieces = [(th, jh)]
    for w in (0, 8):
        pieces.append((at.gqa_apply(cfg, blk.mixer, th, torch.as_tensor(pos),
                                    window=w),
                       jat.gqa_apply(jcfg, lp["mixer"], jh, jnp.asarray(pos),
                                     window=w)))
    pieces.append((layers.mlp_apply(blk.ffn, th),
                   jlayers.mlp_apply(lp["ffn"], jh)))
    for i, (got, want) in enumerate(pieces):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(
            want.astype(jnp.float32)), f"piece {i}")
    jh, _ = jtr.apply_model(jcfg, jp, {"tokens": jnp.asarray(tok)})
    h, _ = tr.apply_model(cfg, model, {"tokens": torch.as_tensor(tok)})
    assert h.dtype == torch.bfloat16
    a, b = h.float().numpy(), np.asarray(jh.astype(jnp.float32))
    assert np.linalg.norm(a - b) <= 2e-2 * np.linalg.norm(b)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the model on the card "
                    "against the same model on the CPU")
    return torch.device("cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "gemma3-27b"])
def test_cuda_dense_model_matches_cpu(cuda_device, arch):
    """The tiny dense model on the card against the same weights on the
    CPU, float32 with TF32 off: prefill and 12 decode steps."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tiny_config(arch)
    cpu = tr.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu = tr.Model(cfg, device=cuda_device)
    gpu.load_state_dict(cpu.state_dict())
    tok = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 32)))
    h_c, _ = tr.apply_model(cfg, cpu, {"tokens": tok})
    h_g, _ = tr.apply_model(cfg, gpu, {"tokens": tok.to(cuda_device)})
    torch.testing.assert_close(h_g.cpu(), h_c, rtol=1e-4, atol=1e-4)
    cc = tr.init_cache(cfg, 2, 16, device="cpu")
    cg = tr.init_cache(cfg, 2, 16, device=cuda_device)
    for t in range(12):
        inp = {"tokens": tok[:, t:t + 1], "pos": torch.full((2,), t)}
        lc, cc = tr.decode_step(cfg, cpu, cc, inp)
        lg, cg = tr.decode_step(cfg, gpu, cg, {
            k: v.to(cuda_device) for k, v in inp.items()})
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
