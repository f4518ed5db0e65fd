"""The port's examples (examples/*_torch.py) run on the CPU and held
against the JAX package's.

* ``quickstart_torch``: the JAX quickstart's lines, up to the metrics
  text, apart from the hot-path line (which names the port's route).
* ``serve_kv_cache_torch``: the JAX example's lines; then both engines
  serve the example's two waves with the same weights (JAX's
  ``init_params`` carried across by ``convert.params_from_numpy``):
  equal ``stats``, greedy tokens and slots, and every decode step's
  float32 logits within 1e-4 (rtol and atol; the measured gaps are at
  most 4e-6, on logits up to 4).  The second wave's requests run in
  slots the first wave freed: for attention caches JAX's answer is that
  a reused slot starts clean (every stale entry is overwritten or
  masked), and the port must give the same.
* ``histore_cluster_torch``: its lines (bit-equality with the JAX
  example is tests/test_torch_dist_selftest.py's).
* ``train_lm_torch``: a few steps on the CPU at a small size, then a
  second run that resumes from the first one's checkpoint; the lines
  keep the format of ``examples/train_lm.py``'s (which fails on this
  jax: its ``make_local_mesh`` gives Explicit axes, ROADMAP.md section
  C); trainer parity is tests/test_torch_trainer.py's.
"""
from __future__ import annotations

import contextlib
import importlib.util
import io
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.tiny import tiny_config as jtiny
from repro.models import transformer as jtr
from repro.serving import engine as jeng
from repro.serving.serve_step import prefill as jprefill
from repro_torch import convert
from repro_torch.serving import engine as eng
from repro_torch.serving import serve_step as ss

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return buf.getvalue().splitlines(), out


def test_quickstart_lines_match_jax():
    jlines, _ = _lines(_load("quickstart").main)
    lines, _ = _lines(_load("quickstart_torch").main, device="cpu")
    assert lines[0] == "index hot path: torch (use_kernels=auto, device=cpu)"
    assert lines[-1] == "quickstart OK"
    end = jlines.index("--- client.metrics_text() ---")
    assert lines[1:end + 1] == jlines[1:end + 1]
    assert any(x.startswith("degraded GET hits=") for x in lines)


def test_quickstart_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for name in ("quickstart_torch", "serve_kv_cache_torch",
                 "histore_cluster_torch", "train_lm_torch"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _lines(_load(name).main, *([[]] if name == "train_lm_torch"
                                       else []))


def test_serve_kv_cache_lines_match_jax():
    """The port's example (its own seeded weights) prints the JAX
    example's lines: the stats do not depend on the weights."""
    jlines, _ = _lines(_load("serve_kv_cache").main)
    lines, _ = _lines(_load("serve_kv_cache_torch").main, device="cpu")
    assert lines == jlines
    assert lines[-1] == "serving example OK"


def test_train_lm_example_runs_and_resumes(tmp_path):
    small = ["--d-model", "64", "--n-layers", "2", "--seq-len", "32",
             "--batch", "4", "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    main = _load("train_lm_torch").main
    lines, out = _lines(main, ["--steps", "6"] + small)
    assert re.fullmatch(r"model: \d+\.\dM params, device=cpu", lines[0])
    # examples/train_lm.py's f-strings: the trainer's [train] line, then
    # the loss over the logged steps
    train_line = r"\[train\] step=(\d+) loss=\d+\.\d{4} gnorm=\d+\.\d{3}"
    assert [int(re.fullmatch(train_line, x)[1]) for x in lines[1:-1]] == [
        0, 5]
    assert re.fullmatch(r"loss: \d+\.\d{3} -> \d+\.\d{3} over steps 0\.\.5",
                        lines[-1])
    lines, out = _lines(main, ["--steps", "12"] + small)
    assert [int(re.fullmatch(train_line, x)[1]) for x in lines[1:-1]] == [
        10, 11]                           # resumed at 6, not restarted
    assert lines[-1].endswith("over steps 10..11")
    assert sorted(p.name for p in tmp_path.glob("step_*.npz")) == [
        "step_00000006.npz", "step_00000012.npz"]


def test_cluster_example_runs():
    lines, client = _lines(_load("histore_cluster_torch").main, device="cpu")
    assert lines[-1] == "cluster example OK"
    assert "parity=True" in lines[-2]
    assert client.backend.G == 8


def _record(e, to_np):
    """Wrap ``e._step``: per step, {slot: (rid, pos)} before it and the
    logits it returned."""
    log, step = [], e._step

    def wrapped(p, c, i):
        who = {s: (r.rid, r.pos) for s, r in enumerate(e.slots)
               if r is not None}
        logits, c = step(p, c, i)
        log.append((who, to_np(logits)))
        return logits, c

    e._step = wrapped
    return log


@pytest.fixture(scope="module")
def engines():
    ex = _load("serve_kv_cache_torch")
    cfg = ex.config()
    jcfg = jtiny("mistral-nemo-12b", d_model=128, n_layers=4)
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(0))
    model = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                      "cpu")
    je = jeng.ServingEngine(jcfg, jp, **ex.ENGINE)
    te = eng.ServingEngine(cfg, model, device="cpu", **ex.ENGINE)
    jlog = _record(je, lambda a: np.asarray(a, np.float32))
    tlog = _record(te, lambda a: a.numpy())
    jsteps, jreqs = ex.serve(je)
    steps, reqs = ex.serve(te)
    return dict(ex=ex, cfg=cfg, jcfg=jcfg, jp=jp, model=model, je=je, te=te,
                jlog=jlog, tlog=tlog, jsteps=jsteps, steps=steps,
                jreqs=jreqs, reqs=reqs)


def test_engine_stats_and_tokens_match_jax(engines):
    e = engines
    assert e["steps"] == e["jsteps"] == 33
    assert e["te"].stats == e["je"].stats
    assert e["te"].stats["prefix_hits"] == 2
    assert [r.tokens for r in e["reqs"]] == [r.tokens for r in e["jreqs"]]
    assert [r.slot for r in e["reqs"]] == [r.slot for r in e["jreqs"]]
    assert all(r.done and len(r.tokens) == e["ex"].MAX_NEW
               for r in e["reqs"])
    assert e["te"].free_pages == e["je"].free_pages
    # the greedy tokens are not all one token (else they would test little)
    assert len({t for r in e["reqs"] for t in r.tokens}) > 3


def test_engine_step_logits_match_jax(engines):
    jlog, tlog = engines["jlog"], engines["tlog"]
    assert len(tlog) == len(jlog) == engines["te"].stats["decode_steps"]
    for i, ((jw, jl), (tw, tl)) in enumerate(zip(jlog, tlog)):
        assert tw == jw
        np.testing.assert_allclose(tl, jl, err_msg=f"step {i}", **TOL)


def test_engine_caches_match_jax(engines):
    flat = convert.cache_from_numpy(
        jax.tree.map(np.asarray, engines["je"].cache), engines["cfg"], "cpu")
    assert len(flat) == len(engines["te"].cache) == 4
    for a, b in zip(engines["te"].cache, flat):
        torch.testing.assert_close(a["k"], b["k"], **TOL)
        torch.testing.assert_close(a["v"], b["v"], **TOL)
        assert torch.equal(a["pos"], b["pos"])


def _prompt_end_logits(log, rid, n_prompt):
    for who, logits in log:
        for slot, (r, pos) in who.items():
            if r == rid and pos == n_prompt - 1:
                return slot, logits[slot]
    raise AssertionError(f"request {rid} never fed its prompt's end")


def test_slot_reuse_starts_clean_for_attention(engines):
    """The Mamba quirk's question (tests/test_torch_serving.py::
    test_slot_reuse_keeps_the_previous_state) asked of a dense config.
    JAX's answer: a request admitted to a slot the first wave freed
    decodes as from an empty cache (the stale k/v entries are overwritten
    before they are read or masked by their position tags), so its logits
    after its prompt equal a fresh prefill's, in both engines alike."""
    e = engines
    n_first = len(e["ex"].WAVE1)
    reused = 0
    for r in e["reqs"]:
        slot, got = _prompt_end_logits(e["tlog"], r.rid, len(r.prompt))
        jslot, want = _prompt_end_logits(e["jlog"], r.rid, len(r.prompt))
        assert slot == jslot
        np.testing.assert_allclose(got, want, **TOL)
        tok = [r.prompt]
        jpre = np.asarray(jprefill(e["jcfg"], e["jp"],
                                   {"tokens": jnp.asarray(tok)}))[0]
        pre = ss.prefill(e["cfg"], e["model"],
                         {"tokens": torch.as_tensor(tok)})[0].numpy()
        np.testing.assert_allclose(pre, jpre, **TOL)
        np.testing.assert_allclose(want, jpre, **TOL)     # JAX's answer
        np.testing.assert_allclose(got, pre, **TOL)
        reused += r.rid >= n_first
    assert reused == len(e["ex"].WAVE2) == 2
