"""Training over ranks (repro_torch.train.dp, the trainer with ZeRO-1, the
compressed all-reduce over a group, GPipe with one stage a rank, the
elastic self-test) on gloo ranks on the CPU, held against JAX's
``train`` on an Auto (W data x 1 model) mesh and against the port's
one-process trainer.

Every run starts from one step-0 checkpoint per config, written from the
port's seeded weights in the JAX package's format (either package
resumes it).  Four JAX subprocesses, on 8 forced host devices each, run
JAX's ``train`` at W = 4 and at W = 2 for tiny mistral-nemo-12b,
falcon-mamba-7b (``ssm_impl="jnp"``), zamba2-7b and deepseek-v2-lite-16b,
plus the replicated fallback (a global batch of 3 over 2 devices, which
``batch_pspec`` does not split), the MoE's global dispatch at a capacity
factor that drops slots, JAX's shard_map compressed all-reduce and its
pipeline on a 4-device "stage" mesh.  At the same time one spawn of 4
gloo ranks (the rank bodies are in tests/_train_ranks.py, which imports
no JAX) runs the port's side, an 8-rank spawn the compressed all-reduce,
and two subprocesses ``elastic_selftest --ranks 2`` and
``examples/train_lm_torch.py --ranks 2``.

Tolerances: against JAX, tests/_train_parity.py's (METRIC_TOL for the
losses and grad norms, the PARAM_ATOL / outlier rule for the
parameters); against the port's one process, ONE_PROCESS_RTOL relative
(the ranks sum the gradients in another order), and bit for bit at
W = 1; the compressed all-reduce bit for bit against the stacked one
and within COMP_TOL of JAX's; the pipeline within PIPE_TOL (JAX's own
tolerance against serial application) of JAX's, of the stacked one and
of serial application.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import _train_ranks as R
from _train_parity import METRIC_TOL, PARAM_ATOL, PARAM_OUTLIERS
from repro_torch.launch import ranks
from repro_torch.train.dp import DP, check_mesh

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 300
ONE_PROCESS_RTOL = 1e-6
COMP_TOL = 1e-6
PIPE_TOL = dict(rtol=2e-5, atol=2e-5)

JAX_SIDE = r"""
import shutil, sys
from pathlib import Path
import jax
import jax.numpy as jnp
import numpy as np
sys.path.insert(0, sys.argv[3])
import _train_ranks as R
from jax.sharding import PartitionSpec as P
from repro.configs.base import ShapeSpec
from repro.configs.tiny import tiny_config
from repro.train.trainer import train

root, W, tasks = Path(sys.argv[1]), int(sys.argv[2]), sys.argv[4].split(",")
AUTO = jax.sharding.AxisType.Auto
res = {}


def mesh(n, names=("data", "model")):
    shape = (n, 1) if len(names) == 2 else (n,)
    return jax.make_mesh(shape, names, axis_types=(AUTO,) * len(names),
                         devices=jax.devices()[:n])


def run(arch, d, batch=R.BATCH, **kw):
    cfg = tiny_config(arch, **{**R.ARCHS[arch], **kw})
    out = train(cfg, mesh(W), ShapeSpec("tiny", R.SEQ, batch, "train"),
                steps=R.STEPS, ckpt_dir=d, ckpt_every=100, lr=R.LR,
                log_every=1)
    h = out["history"]
    return {"loss": np.array([x["loss"] for x in h]),
            "grad_norm": np.array([x["grad_norm"] for x in h]),
            "params": [np.asarray(x) for x in jax.tree.leaves(out["params"])]}


def put(prefix, rec):
    res[f"{prefix}/loss"] = rec["loss"]
    res[f"{prefix}/grad_norm"] = rec["grad_norm"]
    for i, x in enumerate(rec["params"]):
        res[f"{prefix}/p{i:04d}"] = x


for arch in R.ARCHS:
    if arch in tasks:
        d = shutil.copytree(root / arch / "init", root / arch / f"jax_w{W}")
        put(f"{arch}/{W}", run(arch, d))
if "fallback" in tasks:
    d = shutil.copytree(root / "mistral-nemo-12b" / "init",
                        root / "mistral-nemo-12b" / "jax_fallback")
    put("fallback", run("mistral-nemo-12b", d, batch=R.FALLBACK_BATCH))
if "moe" in tasks:
    # the MoE's global dispatch: the slots' experts and capacity
    from repro.models import moe as jmoe
    z = np.load(root / "moe.npz")
    cfg = tiny_config(R.MOE_ARCH, capacity_factor=R.DROP_CF)
    params = {k: jnp.asarray(z[k]) for k in ("router", "e_wi", "e_wg",
                                             "e_wo")}
    if "shared_wi" in z.files:
        params["shared"] = {k: jnp.asarray(z[f"shared_{k}"])
                            for k in ("wi", "wg", "wo")}
    seen = []
    inner = jmoe._dispatch_gspmd

    def spy(cfg, params, xf, eidx, gate, C):
        seen.append((np.asarray(eidx), C))
        return inner(cfg, params, xf, eidx, gate, C)

    jmoe._dispatch_gspmd = spy
    y, aux = jmoe.moe_apply(cfg, params, jnp.asarray(z["x"]))
    (eidx, C), = seen
    res["moe/y"], res["moe/aux"] = np.asarray(y), np.asarray(aux)
    res["moe/eidx"], res["moe/C"] = eidx.reshape(-1), np.array(C)
if "comp" in tasks:
    from repro.optim.compression import dp_allreduce_compressed
    from repro.sharding.smap import shard_map
    z = dict(np.load(root / "comp.npz"))

    def body(g, h, e, f):
        o, ne = dp_allreduce_compressed({"g": g[0], "h": h[0]},
                                        {"g": e[0], "h": f[0]}, "data")
        return o["g"][None], o["h"][None], ne["g"][None], ne["h"][None]

    fn = shard_map(body, mesh(R.COMP_RANKS, ("data",)), (P("data"),) * 4,
                   (P("data"),) * 4)
    g, h, e, f = z["g"], z["h"], z["e_g"], z["e_h"]
    for it in range(R.COMP_ROUNDS):
        og, oh, e, f = fn(g, h, e, f)
        res.update({f"comp/og{it}": og, f"comp/oh{it}": oh,
                    f"comp/e{it}": e, f"comp/f{it}": f})
if "pipe" in tasks:
    from repro.train.pipeline import (AXIS, make_pipeline_train_step,
                                      pipeline_apply)
    z = np.load(root / "pipe.npz")
    pm = mesh(R.PIPE_S, (AXIS,))
    stage = lambda p, x: jnp.tanh(x @ p)
    w, x, tgt = (jnp.asarray(z[k]) for k in ("w", "x", "tgt"))
    res["pipe/y"] = np.asarray(pipeline_apply(stage, w, x, pm))
    step = make_pipeline_train_step(
        stage, lambda out, t: jnp.mean((out - t) ** 2), pm, lr=R.PIPE_LR)
    losses = []
    for _ in range(R.PIPE_STEPS):
        w, loss = step(w, x, tgt)
        losses.append(float(loss))
    res["pipe/w"], res["pipe/losses"] = np.asarray(w), np.array(losses)
np.savez(root / f"jax_{sys.argv[5]}.npz",
         **{k: np.asarray(v) for k, v in res.items()})
"""


# JAX's side in four subprocesses, each (its mesh's W, its tasks), about
# as long as each other
JAX_TASKS = {"a4": (4, ["mistral-nemo-12b", "zamba2-7b"]),
             "b4": (4, ["falcon-mamba-7b", R.MOE_ARCH, "comp", "pipe"]),
             "a2": (2, ["zamba2-7b", "falcon-mamba-7b"]),
             "b2": (2, ["mistral-nemo-12b", R.MOE_ARCH, "fallback", "moe"])}


def _env(**kw):
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "JAX_PLATFORMS": "cpu", **kw}


def _inputs(root):
    """The step-0 checkpoints, one directory a run, and the inputs of the
    MoE, compressed all-reduce and pipeline cases."""
    for arch in R.ARCHS:
        a = root / arch
        R.init_checkpoint(arch, a / "init")
        runs = ["w4", "w2", "w1", "one"]
        runs += {"mistral-nemo-12b": ["fallback"],
                 R.MOE_ARCH: ["drop_w4", "drop_w2", "drop_one"]}.get(arch, [])
        for name in runs:
            R.copy_dir(a / "init", a / name)
    R.copy_dir(root / "mistral-nemo-12b" / "init", root / "resume" / "w4")
    from repro_torch.models.moe import moe_init
    cfg = R.cfg_of(R.MOE_ARCH)
    p = moe_init(cfg, torch.Generator().manual_seed(3), "cpu")
    flat = {k: v.numpy() for k, v in p.items() if k != "shared"}
    flat.update({f"shared_{k}": v.numpy()
                 for k, v in p.get("shared", {}).items()})
    rng = np.random.default_rng(4)
    np.savez(root / "moe.npz", x=rng.standard_normal(
        (R.BATCH, R.SEQ, cfg.d_model)).astype(np.float32), **flat)
    rng = np.random.default_rng(5)
    n = R.COMP_RANKS
    np.savez(root / "comp.npz",
             g=(rng.standard_normal((n, 32, 16)) * 0.01).astype(np.float32),
             h=np.zeros((n, 7), np.float32),
             e_g=(rng.standard_normal((n, 32, 16)) * 1e-4).astype(np.float32),
             e_h=np.zeros((n, 7), np.float32))
    rng = np.random.RandomState(0)
    S, D = R.PIPE_S, R.PIPE_D
    np.savez(root / "pipe.npz",
             w=(rng.randn(S, D, D) * D ** -0.5).astype(np.float32),
             x=rng.randn(R.PIPE_M, R.PIPE_MB, D).astype(np.float32),
             tgt=rng.randn(R.PIPE_M, R.PIPE_MB, D).astype(np.float32))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every side at once: the two JAX subprocesses and the self-test in
    the background while the port's spawns run."""
    root = tmp_path_factory.mktemp("train_ranks")
    _inputs(root)
    env = _env(XLA_FLAGS="--xla_force_host_platform_device_count=8")
    jax_procs = {name: subprocess.Popen(
        [sys.executable, "-c", JAX_SIDE, str(root), str(W),
         str(ROOT / "tests"), ",".join(tasks), name], cwd=ROOT, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for name, (W, tasks) in JAX_TASKS.items()}
    selftest = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.train.elastic_selftest",
         "--ranks", "2", "--device", "cpu", "--timeout", str(TIMEOUT_S)],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    example = subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / "train_lm_torch.py"),
         "--ranks", "2", "--device", "cpu", "--steps", "6", "--d-model", "64",
         "--n-layers", "2", "--seq-len", "32", "--batch", "4",
         "--ckpt-dir", str(root / "example")], cwd=ROOT, env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = ranks.spawn(R.train_cases, 4, device="cpu",
                           timeout_s=TIMEOUT_S, args=(str(root),))
        comp = ranks.spawn(R.compressed, R.COMP_RANKS, device="cpu",
                           timeout_s=TIMEOUT_S, args=(str(root / "comp.npz"),))
        said = ranks.spawn(R.smap_and_fsdp, 2, device="cpu",
                           timeout_s=TIMEOUT_S)
        out = {"port": port, "comp": comp, "trains": said, "root": root}
        for W in (4, 2):
            out[f"jax{W}"] = {}
        for name, p in jax_procs.items():
            _, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, err[-4000:]
            out[f"jax{JAX_TASKS[name][0]}"].update(
                np.load(root / f"jax_{name}.npz"))
        so, se = selftest.communicate(timeout=TIMEOUT_S)
        out["selftest"] = (selftest.returncode, so, se)
        so, se = example.communicate(timeout=TIMEOUT_S)
        out["example"] = (example.returncode, so, se)
        return types.SimpleNamespace(**out)
    finally:
        for p in [*jax_procs.values(), selftest, example]:
            if p.poll() is None:
                p.kill()
                p.wait()


def _jax_params(jax, prefix):
    return [jax[k] for k in sorted(jax) if k.startswith(f"{prefix}/p")]


def _against_jax(rec, jax, prefix, steps=R.STEPS):
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(rec[k], jax[f"{prefix}/{k}"],
                                   err_msg=f"{prefix} {k}", **METRIC_TOL)
    want = _jax_params(jax, prefix)
    assert len(rec["params"]) == len(want)
    d = np.concatenate([np.abs(g - w).ravel()
                        for g, w in zip(rec["params"], want)])
    assert d.max() <= 2 * R.LR * steps, (prefix, d.max())
    assert (d > PARAM_ATOL).mean() <= PARAM_OUTLIERS, (
        prefix, (d > PARAM_ATOL).sum(), d.size)


def _close(got, want, rtol, what):
    for k in ("loss", "ce", "aux", "grad_norm"):
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=0,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("arch", list(R.ARCHS))
def test_dp_trainer_matches_jax_on_each_mesh(runs, arch):
    """W = 4 and W = 2 against JAX's train on the (W, 1) mesh: every
    step's loss and grad norm, the final parameters."""
    for W in (4, 2):
        rec = runs.port[0][(arch, W)]
        assert rec["step"] == list(range(R.STEPS))
        _against_jax(rec, runs.__dict__[f"jax{W}"], f"{arch}/{W}")


@pytest.mark.parametrize("arch", list(R.ARCHS))
def test_dp_trainer_matches_one_process(runs, arch):
    """W = 2 and 4 within ONE_PROCESS_RTOL of the one-process trainer,
    their final parameters close; W = 1 (a group of one) bit for bit;
    every rank of a group reports the same history."""
    one = runs.port[1][(arch, "one")]
    for W in (4, 2):
        for r in range(W):
            rec = runs.port[r][(arch, W)]
            assert rec["loss"] == runs.port[0][(arch, W)]["loss"], (W, r)
        rec = runs.port[0][(arch, W)]
        _close(rec, one, ONE_PROCESS_RTOL, f"{arch} W={W}")
        d = max(np.abs(a - b).max() for a, b in zip(rec["params"],
                                                    one["params"]))
        assert d <= 2 * R.LR * R.STEPS, (W, d)
    w1 = runs.port[0][(arch, 1)]
    for k in ("loss", "ce", "aux", "grad_norm"):
        assert w1[k] == one[k], k
    for a, b in zip(w1["params"], one["params"]):
        assert np.array_equal(a, b)


def test_moe_drops_the_slots_of_the_global_sort(runs):
    """At DROP_CF the MoE over 4 and over 2 ranks routes every slot as
    JAX's global dispatch does and keeps exactly the slots it keeps; its
    outputs and summed aux loss agree.  The negative control, a capacity
    per rank (``_capacity`` of the rank's tokens, the rank's own sort),
    keeps other slots."""
    jax = runs.jax2
    want_keep = _global_keep(jax["moe/eidx"], int(jax["moe/C"]))
    assert 0 < (~want_keep).sum() < want_keep.size
    for label, got in (("W=4", runs.port[0]["moe"]),
                       ("W=2", runs.port[0]["moe2"])):
        g = got["global"]
        assert np.array_equal(g["eidx"], jax["moe/eidx"]), label
        assert np.array_equal(g["keep"], want_keep), label
        np.testing.assert_allclose(g["y"].reshape(jax["moe/y"].shape),
                                   jax["moe/y"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g["aux"], float(jax["moe/aux"]),
                                   rtol=1e-5)
        # a capacity a rank may drop as many slots, but not the same ones
        bad = got["per_rank"]
        assert not np.array_equal(bad["keep"], want_keep), label


def _global_keep(eidx, C):
    """JAX's stable sort by expert keeps an expert's first C slots in
    slot order."""
    seen, keep = {}, np.zeros(eidx.shape, bool)
    for i, e in enumerate(eidx.tolist()):
        keep[i] = seen.get(e, 0) < C
        seen[e] = seen.get(e, 0) + 1
    return keep


def test_moe_drops_train_as_one_process(runs):
    """Tiny deepseek at DROP_CF trained over 4 and 2 ranks: within
    ONE_PROCESS_RTOL of one process."""
    one = runs.port[2][("drop", "one")]
    _close(runs.port[0][("drop", 4)], one, ONE_PROCESS_RTOL, "drop W=4")
    _close(runs.port[2][("drop", 2)], one, ONE_PROCESS_RTOL, "drop W=2")


def test_replicated_fallback_matches_jax(runs):
    """A global batch of 3 over 2 ranks: every rank takes the whole batch
    and sums no gradient, as JAX's batch_pspec falls back; against JAX's
    (2, 1) mesh."""
    rec = runs.port[2]["fallback"]
    assert runs.port[3]["fallback"]["loss"] == rec["loss"]
    _against_jax(rec, runs.jax2, "fallback")


def test_zero1_bytes_as_planned(runs):
    """Each rank's m and v bytes are what opt_pspecs plans for one device
    of {"data": W, "model": 1}: at W = 1 the whole state, over more ranks
    at most the whole over W plus the leaves that fall back to whole."""
    from repro_torch.convert import param_tree, stack_like
    from repro_torch.models.transformer import Model
    from repro_torch.pytree import leaves, leaves_with_path, tree_map
    from repro_torch.sharding.partition import (opt_pspecs, per_device_bytes,
                                                spec_at)

    for arch in R.ARCHS:
        cfg = R.cfg_of(arch)
        model = Model(cfg, device="cpu")
        like = tree_map(lambda t: torch.empty(t.shape, dtype=torch.float32,
                                              device="meta"),
                        stack_like(param_tree(model, cfg)))
        whole = sum(4 * x.numel() for x in leaves(like))
        for W in (4, 2, 1):
            mesh = {"data": W, "model": 1}
            plan = opt_pspecs(cfg, {"m": like}, mesh)["m"]
            want = per_device_bytes(like, plan, mesh)
            fallback = sum(4 * x.numel() for p, x in leaves_with_path(like)
                           if "data" not in spec_at(plan, p))
            assert want == (whole - fallback) // W + fallback, (arch, W)
            for r in range(W):
                rec = runs.port[r][(arch, W)]
                assert rec["m_bytes"] == rec["v_bytes"] == want, (arch, W, r)


def test_w4_checkpoint_resumes_over_two_ranks_and_one_process(runs):
    """The W = 4 checkpoint at RESUME_AT resumed to RESUME_TO over 2
    ranks and in one process: the same steps and losses."""
    a, b = runs.port[0]["resume_w2"], runs.port[2]["resume_one"]
    assert a["step"] == b["step"] == list(range(R.RESUME_AT, R.RESUME_TO))
    _close(a, b, ONE_PROCESS_RTOL, "resume")


def test_w4_checkpoint_is_one_jax_file(runs):
    """The checkpoint written over 4 ranks is one file in JAX's format:
    JAX's restore_checkpoint reads it, its parameters equal to rank 0's
    at the step it was written, and every leaf (m and v whole) equal to
    the port's one-process restore of it."""
    import jax

    from repro.checkpoint import checkpoint as jck
    from repro.configs.tiny import tiny_config as jtiny
    from repro.models import transformer as jtr
    from repro.optim.adamw import adamw_init as jadamw_init
    from repro_torch.checkpoint import checkpoint as ck
    from repro_torch.convert import opt_to_numpy, param_tree, params_to_numpy
    from repro_torch.models.transformer import Model
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.pytree import leaves
    from repro_torch.train.trainer import restore_state

    d = runs.root / "resume" / "w4"
    assert ck.latest_step(d) == R.RESUME_AT
    assert sorted(p.name for p in d.glob("step_*.npz")) == [
        "step_00000000.npz", f"step_{R.RESUME_AT:08d}.npz"]
    jcfg = jtiny("mistral-nemo-12b")
    like_p = jax.eval_shape(lambda k: jtr.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    tree = jck.restore_checkpoint(d, R.RESUME_AT, {
        "params": like_p, "opt": jax.eval_shape(jadamw_init, like_p)})
    jp = [np.asarray(x) for x in jax.tree.leaves(tree["params"])]
    live = runs.port[0]["resume_w4"]["params"]
    assert len(jp) == len(live)
    assert all(np.array_equal(a, b) for a, b in zip(jp, live))
    cfg = R.cfg_of("mistral-nemo-12b")
    model = Model(cfg, device="cpu")
    opt = restore_state(d, R.RESUME_AT, model, cfg,
                        adamw_init(param_tree(model, cfg)))
    port = {"params": params_to_numpy(model, cfg), "opt": opt_to_numpy(opt)}
    got, want = leaves(port), [np.asarray(x) for x in jax.tree.leaves(tree)]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    assert int(tree["opt"]["step"]) == R.RESUME_AT
    assert all(np.abs(np.asarray(x)).max() > 0
               for x in jax.tree.leaves(tree["opt"]["m"]))


def test_compressed_allreduce_over_eight_ranks(runs):
    """Each of 8 ranks its own leaves, three rounds of error feedback:
    bit-equal to the stacked version, within COMP_TOL of JAX's shard_map;
    the payload counted at 4 B an element (int32), as JAX sums it."""
    from repro_torch.optim.compression import dp_allreduce_compressed

    z = np.load(runs.root / "comp.npz")
    grads = {k: torch.from_numpy(z[k]) for k in ("g", "h")}
    err = {k: torch.from_numpy(z[f"e_{k}"]) for k in ("g", "h")}
    for it in range(R.COMP_ROUNDS):
        out, err = dp_allreduce_compressed(grads, err)
        for r, (rounds, _) in enumerate(runs.comp):
            for k in ("g", "h"):
                got = rounds[it]
                assert np.array_equal(got["out"][k], out[k][r].numpy()), (
                    it, r, k)
                assert np.array_equal(got["err"][k], err[k][r].numpy()), (
                    it, r, k)
                jk = {"g": ("og", "e"), "h": ("oh", "f")}[k]
                np.testing.assert_allclose(got["out"][k],
                                           runs.jax4[f"comp/{jk[0]}{it}"][r],
                                           rtol=0, atol=COMP_TOL)
                np.testing.assert_allclose(got["err"][k],
                                           runs.jax4[f"comp/{jk[1]}{it}"][r],
                                           rtol=0, atol=COMP_TOL)
    n = z["g"][0].size + z["h"][0].size
    for _, nbytes in runs.comp:
        assert nbytes["all_reduce_sum"] == 4 * n * R.COMP_ROUNDS
        assert nbytes["all_reduce_max"] == 4 * 2 * R.COMP_ROUNDS


def test_pipeline_one_stage_per_rank(runs):
    """S = 4 stages on 4 ranks: the outputs and PIPE_STEPS SGD steps
    within PIPE_TOL of JAX's make_pipeline_train_step, of the stacked
    pipeline and of serial application; one handoff a tick each way."""
    from repro_torch.train.pipeline import (make_pipeline_train_step,
                                            pipeline_apply)

    z = np.load(runs.root / "pipe.npz")
    w, x, tgt = (torch.from_numpy(z[k]) for k in ("w", "x", "tgt"))
    ref = x
    for s in range(R.PIPE_S):
        ref = torch.tanh(ref @ w[s])
    stacked = pipeline_apply(R.pipe_stage, w, x)
    step = make_pipeline_train_step(R.pipe_stage, R.pipe_loss, lr=R.PIPE_LR)
    ws, losses = w, []
    for _ in range(R.PIPE_STEPS):
        ws, loss = step(ws, x, tgt)
        losses.append(float(loss))
    jax = runs.jax4
    ticks = R.PIPE_S + R.PIPE_M - 1
    for r in range(R.PIPE_S):
        got = runs.port[r]["pipeline"]
        y = torch.from_numpy(got["y"])
        for want in (ref, stacked, torch.from_numpy(jax["pipe/y"])):
            torch.testing.assert_close(y, want, **PIPE_TOL)
        for want in (ws[r], torch.from_numpy(jax["pipe/w"][r])):
            torch.testing.assert_close(torch.from_numpy(got["w"]), want,
                                       **PIPE_TOL)
        np.testing.assert_allclose(got["losses"], losses, **PIPE_TOL)
        np.testing.assert_allclose(got["losses"], jax["pipe/losses"],
                                   **PIPE_TOL)
        assert got["shifts"] == (1 + 2 * R.PIPE_STEPS) * ticks


def test_elastic_selftest_module_over_two_ranks(runs):
    rc, out, err = runs.selftest
    assert rc == 0, err[-4000:]
    lines = out.splitlines()
    assert lines[-1] == "ELASTIC-SELFTEST-OK"
    for ok in ("elastic ok (1 data x 2 model -> 2 data x 1 model)",
               "pipeline ok (2 stages, one a rank)",
               "compressed-dp ok (2 ranks)", "moe-smap ok (1 data x 2 model)",
               "decode-hint ok (1 data x 2 model)"):
        assert ok in lines, (ok, lines)


def test_crash_over_ranks_after_a_durable_checkpoint(runs):
    """fail_at = 3 over 4 ranks with a checkpoint at 2: every rank raises,
    and every rank then sees the step-2 file."""
    for said, latest in (r["crash"] for r in runs.port):
        assert said == "injected failure at step 3"
        assert latest == 2


def test_train_lm_example_over_two_ranks(runs):
    """examples/train_lm_torch.py --ranks 2: rank 0 prints the JAX
    example's lines, the ranks counted on the model line and the train
    lines; one checkpoint file a save."""
    import re

    rc, out, err = runs.example
    assert rc == 0, err[-4000:]
    lines = out.splitlines()
    assert re.fullmatch(r"model: \d+\.\dM params, device=cpu, ranks=2",
                        lines[0])
    steps = [int(re.fullmatch(r"\[train\] step=(\d+) loss=\d+\.\d{4} "
                              r"gnorm=\d+\.\d{3} ranks=2", x)[1])
             for x in lines[1:-1]]
    assert steps == [0, 5]
    assert re.fullmatch(r"loss: \d+\.\d{3} -> \d+\.\d{3} over steps 0\.\.5",
                        lines[-1])
    assert sorted(p.name for p in (runs.root / "example").glob(
        "step_*.npz")) == ["step_00000006.npz"]


def test_smap_and_fsdp_train_over_ranks(runs):
    """moe_impl='smap' trains over 2 ranks (every rank the same loss);
    cfg.fsdp trains over them, as JAX's train does, every rank the same
    losses, within ONE_PROCESS_RTOL of the same run without FSDP; a mesh
    with a model axis builds and is checked against the ranks.  At
    batch 1 the sequence is cut over data, and a length the data axis
    does not divide raises ValueError, as JAX's make_batch does."""
    for said in runs.trains:
        assert len(said) == 3, said
        assert said[0] == runs.trains[0][0] and len(said[0]) == 1, said
        assert said[1] == runs.trains[0][1], said
        np.testing.assert_allclose(said[1][0], said[1][1],
                                   rtol=ONE_PROCESS_RTOL, atol=0)
        assert said[2] == 2, said
    check_mesh({"data": 1, "model": 2}, 2)
    with pytest.raises(ValueError, match="2 ranks"):
        check_mesh({"data": 2, "model": 4}, 2)
    with pytest.raises(ValueError, match="2 ranks"):
        check_mesh({"data": 4, "model": 1}, 2)
    two = DP.single("cpu")
    two.rank, two.world = 1, 2          # rank 1's split, no collective
    assert two.split(1, 32) == (slice(0, 1), slice(16, 32))
    assert two.split(2, 32) == (slice(1, 2), None)
    assert two.split(3, 32) == (slice(0, 3), None)
    with pytest.raises(ValueError, match="does not divide"):
        two.split(1, 31)


def test_one_process_group_calls_no_collective(monkeypatch):
    """DP.single: the batch whole, every verb the identity, and no call
    into torch.distributed."""
    import torch.distributed as dist

    def boom(*a, **k):
        raise AssertionError("a collective on one process")

    for name in ("all_reduce", "all_gather", "broadcast", "barrier",
                 "all_to_all_single"):
        monkeypatch.setattr(dist, name, boom)
    dp = DP.single("cpu")
    t = torch.arange(6.0)
    assert dp.rows(5) == slice(0, 5) and dp.shards(5)
    assert dp.sum_(t) is t and dp.max_(t) is t and dp.broadcast(t) is t
    assert dp.all_gather(t) is t and torch.equal(dp.shift(t), t)
    assert dp.gather(t) == [t]
    assert int(dp.agree(3)) == 3
    dp.barrier()
    assert dp.stats["calls"] == {}


def test_dp_group_reaches_every_thread():
    """``use_dp``'s group is seen by a thread the block did not start: on
    the card autograd runs the backward, and so the forward that
    ``remat="unit"`` recomputes, on a thread of its own."""
    import threading

    from repro_torch.sharding.context import current_dp, use_dp

    seen = []
    dp = DP.single("cpu")
    with use_dp(dp):
        t = threading.Thread(target=lambda: seen.append(current_dp()))
        t.start()
        t.join()
    assert seen == [dp] and current_dp() is None

