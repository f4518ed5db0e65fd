"""The port's Mamba-2 mixer and zamba2's weight-tied shared block
(repro_torch.models.ssm's Mamba-2 half, ``Mamba2Block`` and
``SharedBlock`` of models/transformer.py, convert.py's nested leaves and
caches) held against the JAX package on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and
the port's; whole models take JAX's ``init_params`` weights through
``convert.params_from_numpy``.  float32 tolerance: rtol and atol 1e-5
for a mixer (the sides sum the same products in other orders; the
measured gaps are at most 1.1e-6 on outputs up to 4), 1e-4 for a whole
model, its decode steps and its engine (measured at most 7.4e-6).  The
B/C groups serve H // G consecutive heads each, tested at G = 1 and at
G = 2 with 8 heads a group, since a wrong head order passes at G = 1.
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
from repro.configs.tiny import tiny_config as jtiny
from repro.models import ssm as jssm
from repro.models import transformer as jtr
from repro.serving.serve_step import prefill as jprefill
from repro_torch import convert
from repro_torch.configs import layer_plan
from repro_torch.configs.tiny import tiny_config
from repro_torch.models import ssm
from repro_torch.models import transformer as tr
from repro_torch.serving import serve_step as ss

ARCH = "zamba2-7b"
TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
GROUPS = [1, 2]


def _close(got, want, label="", tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), err_msg=label,
                               **tol)


def _mixer(G, seed=0):
    """(JAX cfg, port cfg, JAX mixer params, the port's copy) at tiny
    zamba2 with G groups: d_inner 128, 16 heads of 8, state 8."""
    jcfg, cfg = jtiny(ARCH, ssm_groups=G), tiny_config(ARCH, ssm_groups=G)
    jp = jssm.mamba2_init(jcfg, jax.random.PRNGKey(seed))
    tp = {k: torch.as_tensor(np.array(v["scale"] if isinstance(v, dict)
                                      else v)) for k, v in jp.items()}
    return jcfg, cfg, jp, tp


@pytest.fixture(scope="module")
def zamba():
    """Tiny zamba2: float32, 7 layers (layers 2 and 5 call the shared
    block), d_model 64, 16 SSD heads in 2 groups, chunk 8."""
    return model_pair(ARCH)


# ---------------------------------------------------------------------------
# the SSD and the Mamba-2 mixer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("G", GROUPS)
def test_ssd_chunk_matches_jax(G):
    """One chunk in matmul form from a nonzero entering state: the output
    and the state it hands on."""
    rng = np.random.default_rng(G)
    B, T, H, P, N = 2, 8, 4, 3, 5
    arrays = [rng.standard_normal(s).astype(np.float32) for s in (
        (B, H, P, N), (B, T, H, P), (B, T, G, N), (B, T, G, N))]
    a_log = -np.abs(rng.standard_normal((B, T, H))).astype(np.float32)
    dt = np.abs(rng.standard_normal((B, T, H))).astype(np.float32)
    arrays += [a_log, dt]
    want = jssm._ssd_chunk(*[jnp.asarray(a) for a in arrays])
    got = ssm._ssd_chunk(*[torch.as_tensor(a) for a in arrays])
    for name, g, w in zip(("y", "h_out"), got, want):
        _close(g, w, f"{name} G={G}")


@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("B,S", [(2, 8), (2, 32), (1, 40), (3, 5)])
def test_mamba2_apply_matches_jax(G, B, S):
    """One chunk (S = 8), many chunks (32, 40: the carry across 4 and 5
    chunks) and a sequence shorter than a chunk (5)."""
    jcfg, cfg, jp, tp = _mixer(G)
    u = np.random.default_rng(S + G).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    _close(ssm.mamba2_apply(cfg, tp, torch.as_tensor(u)),
           jssm.mamba2_apply(jcfg, jp, jnp.asarray(u)), f"G={G} S={S}")


def test_mamba2_chunk_passes_change_no_bit(monkeypatch):
    """The [n, T, T, H] terms go in passes of at most SSD_ELEMS elements;
    a pass of one chunk gives the same bits as one pass for all."""
    _, cfg, _, tp = _mixer(2)
    u = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32))
    whole = ssm.mamba2_apply(cfg, tp, u)
    monkeypatch.setattr(ssm, "SSD_ELEMS", 1)
    assert torch.equal(ssm.mamba2_apply(cfg, tp, u), whole)


def test_mamba2_apply_raises_where_jax_raises():
    """S must be a multiple of min(ssm_chunk, S); Mamba-2 ignores
    ``ssm_impl`` (JAX's does too)."""
    jcfg, cfg, jp, tp = _mixer(2)
    u = np.zeros((1, 12, cfg.d_model), np.float32)
    with pytest.raises(Exception):
        jssm.mamba2_apply(jcfg, jp, jnp.asarray(u))
    with pytest.raises(ValueError, match="not a multiple"):
        ssm.mamba2_apply(cfg, tp, torch.as_tensor(u))
    u = torch.as_tensor(np.random.default_rng(6).standard_normal(
        (1, 16, cfg.d_model)).astype(np.float32))
    base = ssm.mamba2_apply(cfg, tp, u)
    for impl in ("pallas", "stub"):
        assert torch.equal(ssm.mamba2_apply(cfg.scaled(ssm_impl=impl), tp, u),
                           base)


@pytest.mark.parametrize("G", GROUPS)
def test_mamba2_decode_matches_jax(G):
    """Six steps from a zero cache, three rows: the output and every
    cache leaf after each step."""
    jcfg, cfg, jp, tp = _mixer(G, seed=1)
    jc = jssm.mamba2_cache_init(jcfg, 3)
    tc = ssm.mamba2_cache_init(cfg, 3, "cpu")
    rng = np.random.default_rng(10 + G)
    for t in range(6):
        u = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
        jy, jc = jssm.mamba2_decode(jcfg, jp, jnp.asarray(u), jc)
        ty, tc = ssm.mamba2_decode(cfg, tp, torch.as_tensor(u), tc)
        _close(ty, jy, f"decode step {t} G={G}")
        assert set(tc) == set(jc) == {"conv_x", "conv_B", "conv_C", "ssm"}
        for k in jc:
            _close(tc[k], jc[k], f"cache {k} step {t}")


@pytest.mark.parametrize("G", GROUPS)
def test_mamba2_decode_steps_equal_apply(G):
    """S decode steps from a zero cache give mamba2_apply's outputs (two
    chunks of 8)."""
    _, cfg, _, tp = _mixer(G, seed=2)
    u = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32))
    full = ssm.mamba2_apply(cfg, tp, u)
    c = ssm.mamba2_cache_init(cfg, 2, "cpu")
    for t in range(16):
        y, c = ssm.mamba2_decode(cfg, tp, u[:, t:t + 1], c)
        torch.testing.assert_close(y[:, 0], full[:, t], **TOL)


# ---------------------------------------------------------------------------
# tiny zamba2 end to end
# ---------------------------------------------------------------------------
def test_zamba2_model_matches_jax(zamba):
    """apply_model's hidden states and aux (none: no MoE), prefill, then
    12 decode steps from a fresh cache, the cache carried across from
    JAX's at step 6, the last caches equal leaf by leaf ({"mamba",
    "shared"} on the shared layers)."""
    jcfg, cfg, jp, model = zamba
    tok = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 32))
    jh, jaux = jtr.apply_model(jcfg, jp, {"tokens": jnp.asarray(tok)})
    h, aux = tr.apply_model(cfg, model, {"tokens": torch.as_tensor(tok)})
    _close(h, jh, "hidden", MODEL_TOL)
    assert float(aux) == float(jaux) == 0.0
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
        _close(tl, jl, f"decode step {t}", MODEL_TOL)
    for i, (a, b) in enumerate(zip(tc, port_cache(jc, cfg))):
        assert_tree_close(a, b, MODEL_TOL, f"layer {i}")


def test_zamba2_shared_block_is_tied(zamba):
    """One SharedBlock on the model, JAX's params["shared"] bit for bit,
    counted once (count_params equals JAX's); the shared layers are those
    of the spec; the scanned stage (mamba2, mamba2, mamba2+shared) x 2
    unstacks repeat-major."""
    jcfg, cfg, jp, model = zamba
    assert tr.count_params(model) == jtr.count_params(jp)
    assert isinstance(model.shared, tr.SharedBlock)
    n_shared = sum(p.numel() for p in model.shared.parameters())
    n_layers = sum(p.numel() for p in model.layers.parameters())
    assert tr.count_params(model) == (n_shared + n_layers
                                      + model.embed.numel()
                                      + model.lm_head.numel() + cfg.d_model)
    for k in ("ln1", "ln2"):
        np.testing.assert_array_equal(getattr(model.shared, k).numpy(),
                                      np.asarray(jp["shared"][k]["scale"]))
    for g in ("attn", "mlp"):
        for k, a in jp["shared"][g].items():
            np.testing.assert_array_equal(getattr(model.shared, g)[k].numpy(),
                                          np.asarray(a))
    specs = cfg.layer_specs()
    assert [b.calls_shared for b in model.layers] == [
        s[0] == "mamba2+shared" for s in specs] == [
        False, False, True, False, False, True, False]
    st = layer_plan(cfg)[0]
    assert st.kind == "scan" and st.n_rep == 2 and len(st.pattern) == 3
    for r in range(2):
        for i in range(3):
            block = model.layers[r * 3 + i]
            src = jp["stages"][0][i]["mixer"]
            np.testing.assert_array_equal(block.mixer["norm"].numpy(),
                                          np.asarray(src["norm"]["scale"][r]))
            np.testing.assert_array_equal(block.mixer["in_x"].numpy(),
                                          np.asarray(src["in_x"][r]))
    assert not any(p.requires_grad for p in model.parameters())


def test_zamba2_cache_shapes_match_jax():
    """init_cache gives JAX's per-layer caches: Mamba-2's {conv_x, conv_B,
    conv_C, ssm}, a shared layer's {"mamba": those, "shared": {k, v, pos}
    of seq_len slots}, position tags -1."""
    jcfg, cfg = jtiny(ARCH), tiny_config(ARCH)
    for seq_len in (4, 32):
        want = port_cache(jtr.init_cache(jcfg, 3, seq_len), cfg)
        got = tr.init_cache(cfg, 3, seq_len, device="cpu")
        for i, (a, b) in enumerate(zip(got, want)):
            assert_tree_close(a, b, MODEL_TOL, f"layer {i}")
        assert got[2]["shared"]["k"].shape == (3, seq_len, 4, 16)


def test_zamba2_init_shapes_match_jax():
    """The port's own initialiser builds JAX's shapes and dtypes (bf16;
    its numbers differ: another generator)."""
    jcfg, cfg = jtiny(ARCH, dtype="bfloat16"), tiny_config(
        ARCH, dtype="bfloat16")
    jshape = jax.eval_shape(lambda k: jtr.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    a = tr.Model(cfg, device="cpu")
    b = convert.params_from_numpy(
        jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jshape), cfg,
        "cpu")
    assert ({k: (tuple(v.shape), v.dtype) for k, v in a.state_dict().items()}
            == {k: (tuple(v.shape), v.dtype)
                for k, v in b.state_dict().items()})


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def engines():
    return run_engines(ARCH)


def test_zamba2_engine_matches_jax(engines):
    """The port's and JAX's ServingEngine on tiny zamba2 over the same
    requests: equal stats, tokens, slots and free lists, every step's
    logits and the final caches within 1e-4."""
    check_engines_match(engines, MODEL_TOL)


def test_zamba2_slot_reuse_keeps_the_mamba_state(engines):
    """The reference's quirk (ROADMAP.md §C), pinned for Mamba-2: a
    request admitted to a slot the first wave freed starts from the
    previous request's conv and ssm state, in JAX's engine and the
    port's alike, so its logits after its prompt differ from a fresh
    prefill's; the shared attention's ring carries nothing over (its
    stale entries are overwritten or masked), and a fresh slot matches
    the prefill."""
    e = engines
    fresh = reused = 0
    for r in e["reqs"]:
        if r.rid >= len(e["first"]):
            continue
        slot, got = prompt_end_logits(e["tlog"], r.rid, len(r.prompt))
        jslot, want = prompt_end_logits(e["jlog"], r.rid, len(r.prompt))
        assert slot == jslot
        np.testing.assert_allclose(got, want, **MODEL_TOL)
        # the prompt as one SSD chunk and one attention block (its length
        # need not divide by 8)
        tok, n = [r.prompt], len(r.prompt)
        one = dict(ssm_chunk=n, attn_q_block=n, attn_kv_block=n)
        pre = ss.prefill(e["cfg"].scaled(**one), e["model"],
                         {"tokens": torch.as_tensor(tok)})[0].numpy()
        jpre = np.asarray(jprefill(e["jcfg"].scaled(**one), e["jp"],
                                   {"tokens": jnp.asarray(tok)}))[0]
        np.testing.assert_allclose(pre, jpre, **MODEL_TOL)
        if r.rid < e["te"].B:
            np.testing.assert_allclose(got, pre, **MODEL_TOL)
            fresh += 1
        else:
            assert np.abs(got - pre).max() > 1e-2
            assert np.abs(want - jpre).max() > 1e-2     # JAX's answer
            reused += 1
    assert fresh == 3 and reused == 2
    # the shared attention alone: a ring left by a longer request (tags up
    # to 19) gives a new request decoding from position 0 the outputs of
    # an empty ring
    cfg, shared = e["cfg"], e["model"].shared
    rng = np.random.default_rng(11)
    old, new = (torch.as_tensor(rng.standard_normal(
        (n, 1, 1, cfg.d_model)).astype(np.float32)) for n in (20, 10))
    stale = tr.init_cache(cfg, 1, 32, device="cpu")[2]["shared"]
    for t in range(20):
        _, stale = shared.decode(cfg, old[t], torch.tensor([t]), stale)
    clean = tr.init_cache(cfg, 1, 32, device="cpu")[2]["shared"]
    for t in range(10):
        y0, clean = shared.decode(cfg, new[t], torch.tensor([t]), clean)
        y1, stale = shared.decode(cfg, new[t], torch.tensor([t]), stale)
        assert torch.equal(y0, y1), f"step {t}"
