"""The rest of the mesh's data axis over ranks: FSDP (``cfg.fsdp``: the
parameters cut over data beside the model cut, gathered a layer at a
time) and the sequence cut over data at a global batch of 1, on gloo
ranks on the CPU, held against the JAX package's ``train`` on the same
Auto meshes and against the port's one process.

Every training run starts from one step-0 checkpoint per config, written
from the port's seeded weights in the JAX package's format.  One JAX
subprocess, on 8 forced host devices, runs JAX's unmodified ``train`` for
every case of tests/_data_axis_ranks.py's ``CASES``: tiny kimi-k2
(``fsdp`` from its own config: a dense layer, then two MoE layers
stacked, so that the data axis cuts the stack's layer axis), tiny
mistral-nemo-12b and zamba2-7b with ``fsdp=True``, each on (2 x 1) and
(2 x 2); and at a global batch of 1 on (2 x 1), the sequence cut over
data, tiny mistral-nemo (GQA; also on (2 x 2)), gemma3-27b (its window of
8 inside a rank's 16 positions), falcon-mamba-7b (``ssm_impl="jnp"``, at
32 positions and at 24, whose 12 a rank hold no whole chunk of 8),
zamba2-7b, deepseek-v2-lite-16b (at a capacity factor that drops slots)
and kimi-k2 (FSDP and the sequence cut at once).  Two such subprocesses
share the cases (the FSDP ones, the sequence ones), and at the same time
one spawn of 4 gloo ranks runs the port's side (the rank bodies are in
tests/_data_axis_ranks.py, which imports no JAX).

Beside them, the SSD's gradient where its masked decay overflows float32
(as zamba2's does at full width): finite, against a float64 recurrence,
where JAX's is NaN.

Beside them, a prefill and decode steps on the (2 x 2) FSDP cases'
shards against the whole model's one process (DECODE_ATOL).

Tolerances: against JAX, tests/_train_parity.py's (METRIC_TOL for the
losses and grad norms, the PARAM_ATOL / outlier rule for the parameters
after 2 steps); against the port's one process, ONE_PROCESS_RTOL
relative for the losses and grad norms of a resumed run; the
Functions (float64) against their one-process forms within FN_TOL.
"""
from __future__ import annotations

import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import _data_axis_ranks as D
import _train_ranks as T
from _train_parity import METRIC_TOL, PARAM_ATOL, PARAM_OUTLIERS
from repro_torch.launch import ranks

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 400
ONE_PROCESS_RTOL = 1e-5
FN_TOL = 1e-12

JAX_SIDE = r"""
import shutil, sys
from pathlib import Path
import jax
import numpy as np
sys.path.insert(0, sys.argv[2])
import _data_axis_ranks as D
import _train_ranks as T
from repro.configs.base import ShapeSpec
from repro.configs.tiny import tiny_config
from repro.train.trainer import train

root, part = Path(sys.argv[1]), sys.argv[3]
AUTO = jax.sharding.AxisType.Auto
res = {}
for name, (arch, kw, m, batch, seq) in D.CASES.items():
    if not name.startswith(part + "/"):
        continue
    mesh = jax.make_mesh((m["data"], m["model"]), ("data", "model"),
                         axis_types=(AUTO, AUTO),
                         devices=jax.devices()[:m["data"] * m["model"]])
    d = shutil.copytree(root / arch / "init", root / "jax" / name)
    cfg = tiny_config(arch, **{**T.ARCHS.get(arch, {}), **kw})
    out = train(cfg, mesh, ShapeSpec("tiny", seq, batch, "train"),
                steps=D.STEPS, ckpt_dir=d, ckpt_every=100, lr=T.LR,
                log_every=1)
    h = out["history"]
    res[f"{name}/loss"] = np.array([x["loss"] for x in h])
    res[f"{name}/grad_norm"] = np.array([x["grad_norm"] for x in h])
    for i, x in enumerate(jax.tree.leaves(out["params"])):
        res[f"{name}/p{i:04d}"] = np.asarray(x)
np.savez(root / f"jax_{part}.npz", **res)
"""
PARTS = ("fsdp", "seq")


def _env(**kw):
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "JAX_PLATFORMS": "cpu", **kw}


def _inputs(root):
    """The step-0 checkpoints, and a copy for each of the port's runs."""
    for arch in D.ARCHS:
        T.init_checkpoint(arch, root / arch / "init")
    for name, case in D.CASES.items():
        T.copy_dir(root / case[0] / "init", root / name)
    T.copy_dir(root / D.CASES["seq/deepseek/2x1"][0] / "init",
               root / "one_deepseek")
    for run in ("a", "straight"):
        T.copy_dir(root / D.NEMO / "init", root / "resume" / run)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two JAX subprocesses in the background while the port's
    spawn runs."""
    root = tmp_path_factory.mktemp("data_axis")
    _inputs(root)
    procs = [subprocess.Popen(
        [sys.executable, "-c", JAX_SIDE, str(root), str(ROOT / "tests"),
         part], cwd=ROOT,
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=8"),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for part in PARTS]
    try:
        port = ranks.spawn(D.train_cases, 4, device="cpu",
                           timeout_s=TIMEOUT_S, args=(str(root),))
        jax = {}
        for part, proc in zip(PARTS, procs):
            _, err = proc.communicate(timeout=TIMEOUT_S)
            assert proc.returncode == 0, err[-4000:]
            jax.update(np.load(root / f"jax_{part}.npz"))
        return types.SimpleNamespace(port=port, root=root, jax=jax)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _ranks_of(name):
    """The spawn's ranks that ran case ``name``, its rank 0 first."""
    if name in D.QUADS:
        return [0, 1, 2, 3]
    return [0, 1] if name in D.PAIRS[0] else [2, 3]


def _against_jax(rec, jax, prefix, steps=D.STEPS):
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(rec[k], jax[f"{prefix}/{k}"],
                                   err_msg=f"{prefix} {k}", **METRIC_TOL)
    want = [jax[k] for k in sorted(jax) if k.startswith(f"{prefix}/p")]
    assert len(rec["params"]) == len(want)
    d = np.concatenate([np.abs(g - w).ravel()
                        for g, w in zip(rec["params"], want)])
    assert d.max() <= 2 * T.LR * steps, (prefix, d.max())
    assert (d > PARAM_ATOL).mean() <= PARAM_OUTLIERS, (
        prefix, (d > PARAM_ATOL).sum(), d.size)


def _check_case(runs, name):
    on = _ranks_of(name)
    rec = runs.port[on[0]][name]
    assert rec["step"] == list(range(D.STEPS))
    for r in on:
        assert runs.port[r][name]["loss"] == rec["loss"], (name, r)
    _against_jax(rec, runs.jax, name)
    return [runs.port[r][name] for r in on]


FSDP_CASES = [k for k in D.CASES if k.startswith("fsdp/")]
SEQ_CASES = [k for k in D.CASES if k.startswith("seq/")]


@pytest.mark.parametrize("name", FSDP_CASES)
def test_fsdp_trainer_matches_jax(runs, name):
    """FSDP over (2 x 1) and (2 x 2) against JAX's train on the same Auto
    mesh: every step's loss and grad norm, the parameters after 2 steps
    gathered whole; every rank the same losses; the weights gathered a
    layer at a time (all-gathers or the owner's broadcasts) and their
    gradients reduce-scattered (or reduced to the owner)."""
    for rec in _check_case(runs, name):
        calls = rec["data_calls"]
        assert (calls.get("all_gather", 0)
                + calls.get("broadcast", 0)) > 0, calls
        assert (calls.get("reduce_scatter", 0)
                + calls.get("reduce_to", 0)) > 0, calls
    if name.startswith("fsdp/kimi/2x1"):
        # the two MoE layers' stack axis over data: one layer a rank
        assert runs.port[0][name]["data_calls"]["reduce_to"] > 0


def _planned_bytes(name, f32=False):
    """(the bytes each rank holds of the parameters (or, ``f32``, of m)
    by the plan: a leaf over d where param_pspecs puts the data axis on
    it, and over m where the port cuts it over model; the same by
    per_device_bytes of param_pspecs (opt_pspecs for m) over the mesh)."""
    from repro_torch.convert import param_tree, stack_like
    from repro_torch.models.transformer import Model
    from repro_torch.pytree import leaves_with_path, tree_map
    from repro_torch.sharding.partition import (model_dims, opt_pspecs,
                                                param_pspecs,
                                                per_device_bytes, spec_at)

    cfg, mesh = D.cfg_of(name), D.CASES[name][2]
    tree = param_tree(Model(cfg, device="cpu"), cfg)
    like = stack_like(tree)
    if f32:
        like = tree_map(lambda t: torch.empty(t.shape, dtype=torch.float32,
                                              device="meta"), like)
    specs = (opt_pspecs if f32 else param_pspecs)(cfg, like, mesh)
    dims = iter(model_dims(cfg, tree, mesh))
    want = 0
    for path, x in leaves_with_path(like):
        port = spec_at(tree, path)
        cut = [next(dims) for _ in (port if isinstance(port, list)
                                    else [port])][0]
        n = x.numel() * x.element_size()
        if "data" in spec_at(specs, path):
            n //= mesh["data"]
        if cut is not None:
            n //= mesh["model"]
        want += n
    return want, per_device_bytes(like, specs, mesh)


@pytest.mark.parametrize("name", FSDP_CASES)
def test_fsdp_bytes_follow_the_plan(runs, name):
    """Each rank's parameter and m bytes are the plan's: param_pspecs' /
    opt_pspecs' data cut beside the port's model cut, which is
    per_device_bytes of those specs on (2 x 1) (on (2 x 2) JAX also cuts
    zamba2's stacked [n_rep, H] leaves' layer axis over model, which the
    port's per-layer leaves keep whole: ROADMAP.md §C)."""
    p_want, p_plan = _planned_bytes(name)
    m_want, m_plan = _planned_bytes(name, f32=True)
    if D.CASES[name][2]["model"] == 1:
        assert (p_want, m_want) == (p_plan, m_plan)
    for r in _ranks_of(name):
        rec = runs.port[r][name]
        assert rec["param_bytes"] == p_want, (r, rec["param_bytes"], p_want)
        assert rec["m_bytes"] == m_want, (r, rec["m_bytes"], m_want)


@pytest.mark.parametrize("name", SEQ_CASES)
def test_sequence_cut_matches_jax(runs, name):
    """At a global batch of 1 the sequence is cut over data: each rank's
    batches hold its block of the sequence (1 x S / d), not the whole,
    the keys, values, conv halos and carried states cross the ranks, and
    every step's loss, grad norm and the parameters after 2 steps match
    JAX's train on the same Auto mesh, every rank the same losses."""
    seq, d = D.CASES[name][4], D.CASES[name][2]["data"]
    for rec in _check_case(runs, name):
        assert rec["shapes"] == [(1, seq // d)] * D.STEPS, rec["shapes"]
        assert rec["data_calls"]["reduce_scatter"] > 0, rec["data_calls"]


def test_sequence_cut_keeps_the_global_slots(runs):
    """deepseek-v2-lite-16b at a capacity factor that drops slots, its
    sequence cut over 2 ranks: the slots kept a dispatch plan, summed
    over the ranks, are the one process's (JAX's global sort order), and
    some slots drop."""
    name = "seq/deepseek/2x1"
    a, b = (runs.port[r][name]["kept"] for r in _ranks_of(name))
    one = runs.port[3]["one/deepseek"]
    assert len(a) == len(b) == len(one["kept"]) > 0
    assert [x + y for x, y in zip(a, b)] == one["kept"]
    slots = D.SEQ * T.cfg_of("deepseek-v2-lite-16b").top_k
    assert min(one["kept"]) < slots
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(runs.port[2][name][k], one[k],
                                   rtol=ONE_PROCESS_RTOL, atol=0)


def test_fsdp_checkpoint_resumes_on_other_meshes(runs):
    """The checkpoint FSDP wrote on (2 x 2) at step 2 is one JAX-format
    file (JAX's restore_checkpoint reads it: the parameters gathered whole
    at step 2); resumed on (4 x 1) and in one process to step 4, both
    within ONE_PROCESS_RTOL of the straight (2 x 2) run, and their
    parameters within the step rule."""
    import jax

    from repro.checkpoint import checkpoint as jck
    from repro.configs.tiny import tiny_config as jtiny
    from repro.models import transformer as jtr
    from repro.optim.adamw import adamw_init as jadamw_init

    port = runs.port
    a, b, s = (port[0][f"resume/{k}"] for k in ("a", "b", "straight"))
    one = port[1]["resume/one"]
    assert a["step"] == list(range(D.RESUME_AT))
    assert b["step"] == one["step"] == list(range(D.RESUME_AT, D.RESUME_TO))
    assert a["loss"] == s["loss"][:D.RESUME_AT]
    for rec in (b, one):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(rec[k], s[k][D.RESUME_AT:],
                                       rtol=ONE_PROCESS_RTOL, atol=0)
        gap = max(np.abs(x - y).max() for x, y in zip(rec["params"],
                                                      s["params"]))
        assert gap <= 2 * T.LR * (D.RESUME_TO - D.RESUME_AT), gap
    jcfg = jtiny(D.NEMO, fsdp=True)
    like = jax.eval_shape(lambda k: jtr.init_params(jcfg, k),
                          jax.random.PRNGKey(0))
    tree = jck.restore_checkpoint(runs.root / "resume" / "a", D.RESUME_AT, {
        "params": like, "opt": jax.eval_shape(jadamw_init, like)})
    got = [np.asarray(x) for x in jax.tree.leaves(tree["params"])]
    assert len(got) == len(a["params"])
    assert all(np.array_equal(x, y) for x, y in zip(got, a["params"]))
    assert int(tree["opt"]["step"]) == D.RESUME_AT


@pytest.mark.parametrize("W", D.FN_WIDTHS)
@pytest.mark.parametrize("fn", D.FUNCTIONS)
def test_data_axis_functions_match_one_process(runs, fn, W):
    """The FSDP gather (its backward a reduce-scatter), the owner's
    broadcast (a reduce to the owner), the conv halo and the carry prefix
    over W ranks, float64: every rank's output and the gradients of the
    ranks' summed products with their own cotangents within FN_TOL of the
    one-process function's and autograd's."""
    for r in range(W):
        got = runs.port[r][("fn", fn, W)]
        assert got["fwd"] <= FN_TOL and got["bwd"] <= FN_TOL, (r, got)


DECODE_ATOL = 1e-5


@pytest.mark.parametrize("name", D.DECODES)
def test_fsdp_shards_prefill_and_decode(runs, name):
    """The model cut to each rank's FSDP and model slices on (2 x 2)
    serves: a prefill and DECODE_STEPS decode steps of the rank's rows,
    the layers' parameters gathered for each call, every logit within
    DECODE_ATOL of the whole model's one process; each rank's parameter
    bytes the same after as before (the gathered wholes freed)."""
    for r in range(4):
        got = runs.port[r][("decode", name)]
        assert got["gap"] <= DECODE_ATOL, (r, got["gap"])
        assert got["bytes"][0] == got["bytes"][1], (r, got["bytes"])


def test_ssd_gradient_stays_finite_where_the_masked_exp_overflows():
    """A chunk whose log decays sum past float32's exp range (as zamba2's
    do at full width, phase 17 (b)): JAX's _ssd_chunk takes
    where(tril, exp(Ldiff), 0), whose gradient is NaN there; the port's
    gives the same outputs and a finite gradient of the log decays,
    within 1e-4 (relative to its largest) of the recurrence's taken step
    by step in float64."""
    import jax
    import jax.numpy as jnp

    from repro.models import ssm as jssm
    from repro_torch.models import ssm

    rng = np.random.default_rng(7)
    B, T, H, P, N, G = 1, 8, 2, 3, 4, 1
    arrays = [rng.standard_normal(s).astype(np.float32) for s in (
        (B, H, P, N), (B, T, H, P), (B, T, G, N), (B, T, G, N))]
    a_log = -0.5 * np.abs(rng.standard_normal((B, T, H))).astype(np.float32)
    a_log[:, 3] = -100.0                              # exp(100) overflows
    dt = np.abs(rng.standard_normal((B, T, H))).astype(np.float32)
    arrays += [a_log, dt]

    def jloss(a_log):
        y, h = jssm._ssd_chunk(*[jnp.asarray(a) for a in arrays[:4]], a_log,
                               jnp.asarray(arrays[5]))
        return jnp.sum(y) + jnp.sum(h)

    jgrad = np.asarray(jax.grad(jloss)(jnp.asarray(a_log)))
    assert np.isnan(jgrad).any()
    def scan64(h, x, Bm, Cm, a_log, dt):
        # the recurrence step by step, float64: h_t = exp(a_t) h + dt x B
        ys = []
        for t in range(T):
            h = (torch.exp(a_log[:, t])[:, :, None, None] * h
                 + (dt[:, t, :, None] * x[:, t])[..., None]
                 * Bm[:, t, 0][:, None, None, :])
            ys.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, t, 0]))
        return torch.stack(ys, 1), h

    grads = []
    for fn, dtype in ((ssm._ssd_chunk, torch.float32),
                      (scan64, torch.float64)):
        ts = [torch.as_tensor(a, dtype=dtype) for a in arrays]
        ts[4].requires_grad_()
        y, h = fn(*ts)
        grads.append(torch.autograd.grad(y.sum() + h.sum(), ts[4])[0])
        if dtype == torch.float32:
            y_port = y.detach().numpy()
    y_jax, _ = jssm._ssd_chunk(*[jnp.asarray(a) for a in arrays])
    np.testing.assert_allclose(y_port, np.asarray(y_jax), rtol=1e-5,
                               atol=1e-5)
    g32, g64 = grads[0].numpy(), grads[1].numpy()
    assert np.isfinite(g32).all()
    np.testing.assert_allclose(g32, g64, rtol=0,
                               atol=1e-4 * np.abs(g64).max())
