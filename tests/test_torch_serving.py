"""The port's ServingEngine held against the JAX ServingEngine on the CPU,
at tiny falcon-mamba (float32, 2 layers, d_model 64) with the same weights
(``convert.params_from_numpy``) and the same prompts.

Both engines run the same requests: a first run of 5 requests over 3
slots (the last 2 admitted to slots freed by the first wave), then a
second run with 2 prompts of the first run again (prefix-reuse hits) and
a new one.  They must give equal ``stats`` and an equal page directory
(the hash arrays and every sorted replica of ``engine.directory``, the
free list) and per-step logits within 5e-4 (rtol and atol, the model
path's tolerance; the measured gaps are about 1e-6), captured by wrapping
``_step``.  At this size the greedy tokens are all 0, so the tokens alone
would test nothing.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.configs.tiny import tiny_config as jtiny
from repro.core import hash_index as jhix
from repro.core import sorted_index as jsix
from repro.models import transformer as jtr
from repro.serving import engine as jeng
from repro_torch import convert
from repro_torch.configs.tiny import tiny_config
from repro_torch.core import hash_index as hix
from repro_torch.core import sorted_index as six
from repro_torch.serving import engine as eng
from repro_torch.serving import serve_step as ss

ARCH = "falcon-mamba-7b"
TOL = dict(rtol=5e-4, atol=5e-4)
ENGINE = dict(batch_slots=3, max_len=64, page_size=8)


def _requests(seed=0):
    """(first run, second run): lists of (prompt, max_new)."""
    rng = np.random.default_rng(seed)
    first = [(rng.integers(1, 256, int(n)).tolist(), int(m))
             for n, m in zip(rng.integers(6, 21, 5), rng.integers(6, 13, 5))]
    second = [first[0], first[3],
              (rng.integers(1, 256, 9).tolist(), 8)]
    return first, second


def _record(e, to_np):
    """Wrap ``e._step``: per step, {slot: (rid, pos)} before the step and
    the logits it returned."""
    log, step = [], e._step

    def wrapped(p, c, i):
        who = {s: (r.rid, r.pos) for s, r in enumerate(e.slots)
               if r is not None}
        logits, c = step(p, c, i)
        log.append((who, to_np(logits)))
        return logits, c

    e._step = wrapped
    return log


def _drive(e, first, second):
    for prompt, m in first:
        e.submit(prompt, max_new=m)
    e.run()
    stats1 = dict(e.stats)
    for prompt, m in second:
        e.submit(prompt, max_new=m)
    e.run()
    return stats1


@pytest.fixture(scope="module")
def engines():
    jcfg, cfg = jtiny(ARCH), tiny_config(ARCH)
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(0))
    model = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                      "cpu")
    je = jeng.ServingEngine(jcfg, jp, **ENGINE)
    te = eng.ServingEngine(cfg, model, device="cpu", **ENGINE)
    jlog = _record(je, lambda a: np.asarray(a, np.float32))
    tlog = _record(te, lambda a: a.numpy())
    first, second = _requests()
    js1 = _drive(je, first, second)
    ts1 = _drive(te, first, second)
    return dict(je=je, te=te, jlog=jlog, tlog=tlog, js1=js1, ts1=ts1,
                cfg=cfg, model=model, first=first)


def test_keys_match_jax():
    assert (eng.PAGE_BITS, eng._PREFIX_MOD) == (jeng.PAGE_BITS,
                                                jeng._PREFIX_MOD)
    for seq, page in ((0, 0), (3, 7), (1000, 4095)):
        assert eng.page_key(seq, page) == jeng.page_key(seq, page)
    for prompt in ([1, 2, 3], [5, 6, 7, 8], list(range(40))):
        assert eng.prefix_key(prompt) == jeng.prefix_key(prompt)
    assert 0 <= eng.prefix_key(list(range(40))) < 2 ** 31 - 1


def test_stats_match_jax(engines):
    e = engines
    assert e["ts1"] == e["js1"]
    assert e["te"].stats == e["je"].stats
    s = e["te"].stats
    assert s["prefix_hits"] == 2 and s["index_scans"] >= 8
    assert s["pages_freed"] >= s["pages_registered"] > 0
    assert not e["te"].queue and all(r is None for r in e["te"].slots)


def test_directory_matches_jax(engines):
    """The page directory: the hash arrays, every sorted replica's items,
    the value slots and the free list, equal to JAX's."""
    je, te = engines["je"], engines["te"]
    jg, tg = je.directory, te.directory
    for f in ("sig", "fp", "addr", "fill"):
        np.testing.assert_array_equal(getattr(tg.hash, f).numpy(),
                                      np.asarray(getattr(jg.hash, f)), f)
    assert int(hix.n_items(tg.hash)) == int(jhix.n_items(jg.hash))
    for r, srt in enumerate(tg.sorted):
        jitems = jsix.items(jax.tree.map(lambda a: a[r], jg.sorted))
        for got, want in zip(six.items(srt), jitems):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(te.client.backend.vals.numpy(),
                                  np.asarray(je.client.backend.vals))
    assert te.free_pages == je.free_pages


def test_directory_drains():
    """The checks of tests/test_serving_engine.py:27-38 on the port: every
    page is freed through the release SCANs, the free list is whole
    again, the hash holds at most the prefix keys."""
    cfg = tiny_config(ARCH)
    from repro_torch.models.transformer import init_params
    te = eng.ServingEngine(cfg, init_params(cfg, device="cpu"),
                           device="cpu", **ENGINE)
    te.submit(list(range(1, 9)), max_new=16)     # 8 + 16 = 3 pages
    free_before = len(te.free_pages)
    te.run()
    s = te.stats
    assert s["pages_registered"] >= 2 and s["index_scans"] >= 1
    assert s["pages_freed"] >= s["pages_registered"]
    assert len(te.free_pages) == free_before
    assert int(hix.n_items(te.directory.hash)) <= 1


def test_step_logits_match_jax(engines):
    """Every decode step's logits, the slots reused by the first run's
    second wave included; the same slots held the same requests."""
    jlog, tlog = engines["jlog"], engines["tlog"]
    assert len(tlog) == len(jlog) == engines["te"].stats["decode_steps"]
    for i, ((jw, jl), (tw, tl)) in enumerate(zip(jlog, tlog)):
        assert tw == jw
        np.testing.assert_allclose(tl, jl, err_msg=f"step {i}", **TOL)


def _prompt_end_logits(log, rid, n_prompt):
    """The logits of the step that fed request rid's last prompt token,
    and its slot."""
    for who, logits in log:
        for slot, (r, pos) in who.items():
            if r == rid and pos == n_prompt - 1:
                return slot, logits[slot]
    raise AssertionError(f"request {rid} never fed its prompt's end")


def test_slot_reuse_keeps_the_previous_state(engines):
    """The reference's quirk, mirrored: a request admitted to a freed slot
    starts from the previous request's conv and ssm state, so its logits
    after its prompt differ from a fresh prefill of that prompt, in both
    engines alike; a request in a fresh slot matches the prefill."""
    e = engines
    cfg, model = e["cfg"].scaled(ssm_impl="pallas"), e["model"]
    fresh, reused = 0, 0
    for rid, (prompt, _) in enumerate(e["first"]):
        slot, got = _prompt_end_logits(e["tlog"], rid, len(prompt))
        jslot, want = _prompt_end_logits(e["jlog"], rid, len(prompt))
        assert slot == jslot
        np.testing.assert_allclose(got, want, **TOL)
        pre = ss.prefill(cfg, model, {"tokens": torch.as_tensor([prompt])})
        pre = pre[0].numpy()
        if rid < ENGINE["batch_slots"]:
            np.testing.assert_allclose(got, pre, **TOL)
            fresh += 1
        else:
            assert np.abs(got - pre).max() > 1e-2
            reused += 1
    assert fresh == 3 and reused == 2


def test_engine_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tiny_config(ARCH)
    from repro_torch.models.transformer import init_params
    model = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eng.ServingEngine(cfg, model, **ENGINE)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ss.make_cache(cfg, 2, 8)


def test_caches_match_jax(engines):
    """After both runs the engines' decode caches agree (shapes, dtypes
    and values)."""
    jc, tc = engines["je"].cache, engines["te"].cache
    flat = convert.cache_from_numpy(jax.tree.map(np.asarray, jc),
                                    engines["cfg"], "cpu")
    assert len(flat) == len(tc)
    for a, b in zip(flat, tc):
        for k in ("conv", "ssm"):
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
            torch.testing.assert_close(b[k], a[k], **TOL)
