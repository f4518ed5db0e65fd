"""Shared helpers of tests/test_torch_ssm2.py and tests/test_torch_moe.py:
a tiny config's weights carried from JAX to the port, nested cache trees
compared leaf by leaf, and the two ServingEngines driven over the same
requests with every decode step's logits recorded."""
from __future__ import annotations

import jax
import numpy as np
import torch

from repro.configs.tiny import tiny_config as jtiny
from repro.models import transformer as jtr
from repro.serving import engine as jeng
from repro_torch import convert
from repro_torch.configs.tiny import tiny_config
from repro_torch.serving import engine as eng

ENGINE = dict(batch_slots=3, max_len=64, page_size=8)


def model_pair(arch, seed=0, **kw):
    """(JAX cfg, port cfg, JAX params, port Model on the CPU) at the tiny
    twin of ``arch``, the weights JAX's ``init_params`` draws."""
    jcfg, cfg = jtiny(arch, **kw), tiny_config(arch, **kw)
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(seed))
    model = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                      "cpu")
    return jcfg, cfg, jp, model


def port_cache(jcache, cfg):
    return convert.cache_from_numpy(jax.tree.map(np.asarray, jcache), cfg,
                                    "cpu")


def assert_tree_close(got, want, tol, path="cache"):
    """Two nested dicts of tensors: the same keys, shapes and dtypes,
    float leaves within ``tol``, integer leaves (position tags) equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_tree_close(got[k], want[k], tol, f"{path}.{k}")
        return
    assert got.shape == want.shape and got.dtype == want.dtype, path
    if want.dtype.is_floating_point:
        torch.testing.assert_close(got, want, msg=path, **tol)
    else:
        assert torch.equal(got, want), path


def requests(vocab, seed=0):
    """(first run, second run) of (prompt, max_new): five requests over
    three slots (the last two admitted to slots the first wave freed),
    then two of them again (prefix hits) and a new one."""
    rng = np.random.default_rng(seed)
    first = [(rng.integers(1, vocab, int(n)).tolist(), int(m))
             for n, m in zip(rng.integers(6, 21, 5), rng.integers(6, 13, 5))]
    second = [first[0], first[3], (rng.integers(1, vocab, 9).tolist(), 8)]
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
    reqs = []
    for wave in (first, second):
        for prompt, m in wave:
            e.submit(prompt, max_new=m)
            reqs.append(e.queue[-1])
        e.run()
    return reqs


def run_engines(arch, **kw):
    """Both engines over ``requests``: a dict of the configs, weights,
    engines, their requests and step logs."""
    jcfg, cfg, jp, model = model_pair(arch, **kw)
    je = jeng.ServingEngine(jcfg, jp, **ENGINE)
    te = eng.ServingEngine(cfg, model, device="cpu", **ENGINE)
    jlog = _record(je, lambda a: np.asarray(a, np.float32))
    tlog = _record(te, lambda a: a.numpy())
    first, second = requests(cfg.vocab_size)
    jreqs = _drive(je, first, second)
    reqs = _drive(te, first, second)
    return dict(jcfg=jcfg, cfg=cfg, jp=jp, model=model, je=je, te=te,
                jlog=jlog, tlog=tlog, jreqs=jreqs, reqs=reqs, first=first)


def prompt_end_logits(log, rid, n_prompt):
    """The logits of the step that fed request rid's last prompt token,
    and its slot."""
    for who, logits in log:
        for slot, (r, pos) in who.items():
            if r == rid and pos == n_prompt - 1:
                return slot, logits[slot]
    raise AssertionError(f"request {rid} never fed its prompt's end")


def check_engines_match(e, tol):
    """Equal stats, tokens, slots and free lists; every step's logits
    within ``tol``; the engines' caches within ``tol``."""
    assert e["te"].stats == e["je"].stats
    assert e["te"].stats["prefix_hits"] == 2
    assert [r.tokens for r in e["reqs"]] == [r.tokens for r in e["jreqs"]]
    assert [r.slot for r in e["reqs"]] == [r.slot for r in e["jreqs"]]
    assert all(r.done for r in e["reqs"])
    assert e["te"].free_pages == e["je"].free_pages
    jlog, tlog = e["jlog"], e["tlog"]
    assert len(tlog) == len(jlog) == e["te"].stats["decode_steps"]
    for i, ((jw, jl), (tw, tl)) in enumerate(zip(jlog, tlog)):
        assert tw == jw
        np.testing.assert_allclose(tl, jl, err_msg=f"step {i}", **tol)
    want = port_cache(e["je"].cache, e["cfg"])
    assert len(want) == len(e["te"].cache) == e["cfg"].n_layers
    for i, (a, b) in enumerate(zip(e["te"].cache, want)):
        assert_tree_close(a, b, tol, f"layer {i}")
