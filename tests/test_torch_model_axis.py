"""The mesh's model axis over ranks (tensor parallelism, the expert-cut
MoE, the vocab-cut embedding, head and loss, the ``use_mesh`` paths:
``moe_impl="smap"`` and the sequence-cut decode cache) on gloo ranks on
the CPU, held against the JAX package on the same (data x model) Auto
meshes and against the port's one process.

Every training run starts from one step-0 checkpoint per config, written
from the port's seeded weights in the JAX package's format.  One JAX
subprocess, on 8 forced host devices, runs JAX's ``train`` on (2 x 2)
and (1 x 4) for tiny mistral-nemo-12b, falcon-mamba-7b
(``ssm_impl="jnp"``), zamba2-7b and deepseek-v2-lite-16b (at a capacity
factor that drops slots), ``moe_impl="smap"`` inside ``train`` on
(2 x 1) beside the sort dispatch, the elastic (4 x 2) -> (2 x 4),
``moe_apply`` with smap under ``use_mesh`` on (2 x 4) at JAX's own
capacity factor of 8 and at the dropping one, and decode with
``decode_cache_hint`` on (2 x 4).  At the same time one spawn of 4 gloo
ranks and then one of 8 run the port's side (the rank bodies are in
tests/_model_axis_ranks.py, which imports no JAX).

Tolerances: against JAX, tests/_train_parity.py's (METRIC_TOL for the
losses and grad norms, the PARAM_ATOL / outlier rule for the
parameters), JAX's own self-test tolerances for smap (2e-4) and the
decode hint (2e-4); against the port's one process, ONE_PROCESS_RTOL
relative, and bit for bit on the mesh (1 x 1).
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

import _model_axis_ranks as M
import _train_ranks as T
from _train_parity import METRIC_TOL, PARAM_ATOL, PARAM_OUTLIERS
from repro_torch.launch import ranks
from repro_torch.train.dp import coords

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 400
ONE_PROCESS_RTOL = 1e-5
SMAP_TOL = dict(rtol=2e-4, atol=2e-4)
DECODE_TOL = dict(rtol=2e-4, atol=2e-4)

JAX_SIDE = r"""
import shutil, sys
from pathlib import Path
import jax
import jax.numpy as jnp
import numpy as np
sys.path.insert(0, sys.argv[2])
import _model_axis_ranks as M
import _train_ranks as T
from repro.checkpoint.checkpoint import restore_checkpoint
from repro.configs.base import ShapeSpec
from repro.configs.tiny import tiny_config
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro.optim.adamw import adamw_init
from repro.sharding.context import use_mesh
from repro.train.trainer import train

root = Path(sys.argv[1])
AUTO = jax.sharding.AxisType.Auto
res = {}


def mesh(m):
    return jax.make_mesh((m["data"], m["model"]), ("data", "model"),
                         axis_types=(AUTO, AUTO),
                         devices=jax.devices()[:m["data"] * m["model"]])


def cfg_of(arch, **kw):
    if arch == T.MOE_ARCH:
        kw = {"capacity_factor": T.DROP_CF, **kw}
    return tiny_config(arch, **{**T.ARCHS.get(arch, {}), **kw})


def put(prefix, out):
    h = out["history"]
    res[f"{prefix}/loss"] = np.array([x["loss"] for x in h])
    res[f"{prefix}/grad_norm"] = np.array([x["grad_norm"] for x in h])
    for i, x in enumerate(jax.tree.leaves(out["params"])):
        res[f"{prefix}/p{i:04d}"] = np.asarray(x)


def run(arch, m, name, steps=T.STEPS, batch=T.BATCH, lr=T.LR, every=100,
        d=None, **kw):
    d = d or shutil.copytree(root / arch / "init", root / arch / name)
    return train(cfg_of(arch, **kw), mesh(m),
                 ShapeSpec("tiny", T.SEQ, batch, "train"), steps=steps,
                 ckpt_dir=d, ckpt_every=every, lr=lr, log_every=1)


for m in (M.ELASTIC_A, M.ELASTIC_B):
    res[f"devices/{M.mesh_name(m)}"] = np.array(
        [[d.id for d in row] for row in mesh(m).devices])
for arch in T.ARCHS:
    for m in M.MESHES:
        put(f"{arch}/{M.mesh_name(m)}",
            run(arch, m, f"jax_{M.mesh_name(m)}"))
# the repair: smap inside train takes the sort dispatch on any mesh
for impl in ("smap", "sort"):
    put(f"repair/{impl}", run(T.MOE_ARCH, {"data": 2, "model": 1},
                              f"jax_repair_{impl}", moe_impl=impl))
# the elastic re-mesh from the step-0 checkpoint
d = shutil.copytree(root / "mistral-nemo-12b" / "init", root / "jax_elastic")
for tag, m, steps in (("a", M.ELASTIC_A, M.ELASTIC_AT),
                      ("b", M.ELASTIC_B, M.ELASTIC_TO)):
    out = run("mistral-nemo-12b", m, None, steps=steps,
              batch=M.ELASTIC_BATCH, lr=M.ELASTIC_LR, every=M.ELASTIC_AT, d=d)
    put(f"elastic_{tag}", out)
    res[f"elastic_{tag}/step"] = np.array([x["step"] for x in out["history"]])
# smap under use_mesh, and the sort dispatch with no mesh
z = np.load(root / "smap.npz")
params = {k: jnp.asarray(z[k]) for k in ("router", "e_wi", "e_wg", "e_wo")}
if "shared_wi" in z.files:
    params["shared"] = {k: jnp.asarray(z[f"shared_{k}"])
                        for k in ("wi", "wg", "wo")}
x = jnp.asarray(z["x"])
for cf in M.SMAP_CFS:
    cfg = tiny_config(M.SMAP_ARCH, n_experts=8, top_k=2, capacity_factor=cf)
    y, aux = jax.jit(lambda p, x: jmoe.moe_apply(cfg, p, x))(params, x)
    res[f"sort/{cf}/y"], res[f"sort/{cf}/aux"] = np.asarray(y), np.asarray(aux)
    c2 = cfg.scaled(moe_impl="smap")
    with use_mesh(mesh(M.SMAP_MESH)):
        y, aux = jax.jit(lambda p, x: jmoe.moe_apply(c2, p, x))(params, x)
    res[f"smap/{cf}/y"], res[f"smap/{cf}/aux"] = np.asarray(y), np.asarray(aux)
# decode with the cache hint under use_mesh, and plain decode
cfg = tiny_config("mistral-nemo-12b")
like = jax.eval_shape(lambda k: jtr.init_params(cfg, k), jax.random.PRNGKey(0))
p = restore_checkpoint(root / "mistral-nemo-12b" / "init", 0, {
    "params": like, "opt": jax.eval_shape(adamw_init, like)})["params"]
for tag, c in (("plain", cfg), ("hint", cfg.scaled(decode_cache_hint=True))):
    cache = jtr.init_cache(c, M.DECODE_B, M.DECODE_S)
    for t in range(M.DECODE_STEPS):
        inp = {"tokens": jnp.full((M.DECODE_B, 1), 3 + t, jnp.int32),
               "pos": jnp.full((M.DECODE_B,), t, jnp.int32)}
        step = jax.jit(lambda p, c_, i: jtr.decode_step(c, p, c_, i))
        if tag == "hint":
            with use_mesh(mesh(M.SMAP_MESH)):
                lg, cache = step(p, cache, inp)
        else:
            lg, cache = step(p, cache, inp)
        res[f"decode/{tag}/{t}"] = np.asarray(lg)
np.savez(root / "jax.npz", **{k: np.asarray(v) for k, v in res.items()})
"""


def _env(**kw):
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "JAX_PLATFORMS": "cpu", **kw}


def _inputs(root):
    """The step-0 checkpoints, one directory a run, and the smap inputs."""
    for arch in T.ARCHS:
        a = root / arch
        T.init_checkpoint(arch, a / "init")
        for name in [M.mesh_name(m) for m in M.MESHES] + ["1x1", "one"]:
            T.copy_dir(a / "init", a / name)
    for impl in ("smap", "sort"):
        T.copy_dir(root / T.MOE_ARCH / "init", root / "repair" / impl)
    T.copy_dir(root / "mistral-nemo-12b" / "init", root / "elastic")
    from repro_torch.models.moe import moe_init
    cfg = M.smap_cfg(8.0)
    p = moe_init(cfg, torch.Generator().manual_seed(3), "cpu")
    flat = {k: v.numpy() for k, v in p.items() if k != "shared"}
    flat.update({f"shared_{k}": v.numpy()
                 for k, v in p.get("shared", {}).items()})
    rng = np.random.default_rng(6)
    np.savez(root / "smap.npz", x=rng.standard_normal(
        (4, 16, cfg.d_model)).astype(np.float32), **flat)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX subprocess in the background while the port's two spawns
    run."""
    root = tmp_path_factory.mktemp("model_axis")
    _inputs(root)
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SIDE, str(root), str(ROOT / "tests")],
        cwd=ROOT, env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=8"),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        port = ranks.spawn(M.train_cases, 4, device="cpu",
                           timeout_s=TIMEOUT_S, args=(str(root),))
        mesh = ranks.spawn(M.mesh_cases, 8, device="cpu",
                           timeout_s=TIMEOUT_S, args=(str(root),))
        _, err = jax_proc.communicate(timeout=TIMEOUT_S)
        assert jax_proc.returncode == 0, err[-4000:]
        return types.SimpleNamespace(port=port, mesh=mesh,
                                     fsdp=[x["fsdp"] for x in port],
                                     jax=dict(np.load(root / "jax.npz")),
                                     root=root)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()


def _against_jax(rec, jax, prefix, steps=T.STEPS):
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


@pytest.mark.parametrize("arch", list(T.ARCHS))
@pytest.mark.parametrize("mesh", [M.mesh_name(m) for m in M.MESHES])
def test_model_axis_trainer_matches_jax(runs, arch, mesh):
    """(2 x 2) and (1 x 4) against JAX's train on the same Auto mesh: every
    step's loss and grad norm, the final parameters gathered whole."""
    rec = runs.port[0][(arch, mesh)]
    assert rec["step"] == list(range(T.STEPS))
    _against_jax(rec, runs.jax, f"{arch}/{mesh}")


@pytest.mark.parametrize("arch", list(T.ARCHS))
def test_model_axis_trainer_matches_one_process(runs, arch):
    """Both meshes within ONE_PROCESS_RTOL of the one-process trainer,
    every rank the same history, each rank's parameter bytes those of
    its cut; the mesh (1 x 1) on a group of one bit for bit."""
    one = runs.port[1][(arch, "one")]
    for mesh in MESH_NAMES:
        for r in range(4):
            assert runs.port[r][(arch, mesh)]["loss"] == \
                runs.port[0][(arch, mesh)]["loss"], (mesh, r)
        rec = runs.port[0][(arch, mesh)]
        for k in ("loss", "ce", "aux", "grad_norm"):
            np.testing.assert_allclose(rec[k], one[k], rtol=ONE_PROCESS_RTOL,
                                       atol=0, err_msg=f"{arch} {mesh} {k}")
        d = max(np.abs(a - b).max() for a, b in zip(rec["params"],
                                                    one["params"]))
        assert d <= 2 * T.LR * T.STEPS, (mesh, d)
        assert rec["param_bytes"] < one["param_bytes"], mesh
    w1 = runs.port[0][(arch, "1x1")]
    for k in ("loss", "ce", "aux", "grad_norm"):
        assert w1[k] == one[k], k
    for a, b in zip(w1["params"], one["params"]):
        assert np.array_equal(a, b)


MESH_NAMES = [M.mesh_name(m) for m in M.MESHES]


@pytest.mark.parametrize("arch", list(T.ARCHS))
def test_zero1_beside_the_model_cut(runs, arch):
    """Each rank's m bytes on (2 x 2) and (1 x 4): every leaf's over d
    where opt_pspecs puts the data axis on one of its dims, and over m
    where param_pspecs cuts the parameter over model (m and v follow the
    parameter's cut; JAX's opt_pspecs, keyed under "m", drops the
    embedding's and head's model entries, and a stack's layer axis cut
    over model stays whole in the port's per-layer leaves)."""
    from repro_torch.convert import param_tree, stack_like
    from repro_torch.models.transformer import Model
    from repro_torch.pytree import leaves_with_path, tree_map
    from repro_torch.sharding.partition import (model_dims, opt_pspecs,
                                                spec_at)

    cfg = M.cfg_of(arch)
    tree = param_tree(Model(cfg, device="cpu"), cfg)
    like = tree_map(lambda t: torch.empty(t.shape, dtype=torch.float32,
                                          device="meta"), stack_like(tree))
    for mesh in M.MESHES:
        plan = opt_pspecs(cfg, {"m": like}, mesh)["m"]
        dims = iter(model_dims(cfg, tree, mesh))
        want = 0
        for path, x in leaves_with_path(like):
            port = spec_at(tree, path)
            cut = [next(dims) for _ in (port if isinstance(port, list)
                                        else [port])][0]
            n = 4 * x.numel()
            if "data" in spec_at(plan, path):
                n //= mesh["data"]
            if cut is not None:
                n //= mesh["model"]
            want += n
        for r in range(4):
            got = runs.port[r][(arch, M.mesh_name(mesh))]["m_bytes"]
            assert got == want, (mesh, r, got, want)


def test_smap_inside_train_takes_the_sort_dispatch(runs):
    """moe_impl="smap" inside train over 2 ranks (2 x 1): JAX's run equals
    its own sort run, and the port's matches JAX's and its own sort run
    (no use_mesh: train never sets one, in either package)."""
    jax = runs.jax
    for k in ("loss", "grad_norm"):
        np.testing.assert_array_equal(jax[f"repair/smap/{k}"],
                                      jax[f"repair/sort/{k}"])
    _against_jax(runs.port[0]["repair"], jax, "repair/smap")
    smap, sort = runs.port[0]["repair"], runs.port[2]["repair"]
    for k in ("loss", "ce", "aux", "grad_norm"):
        assert smap[k] == sort[k], k


def test_elastic_remesh_over_eight_ranks(runs):
    """JAX's (4 x 2) -> (2 x 4): 4 steps, a checkpoint, 4 more on the other
    mesh; the losses and final parameters against JAX's, the resumed run
    at step 4, its last loss below the first."""
    a, b = runs.mesh[0]["elastic_a"], runs.mesh[0]["elastic_b"]
    assert a["step"] == list(range(M.ELASTIC_AT))
    assert b["step"] == list(range(M.ELASTIC_AT, M.ELASTIC_TO))
    assert list(runs.jax["elastic_b/step"]) == b["step"]
    assert b["loss"][-1] < a["loss"][0]
    _against_jax(a, runs.jax, "elastic_a", M.ELASTIC_AT)
    _against_jax(b, runs.jax, "elastic_b", M.ELASTIC_TO)
    for r in range(8):
        assert runs.mesh[r]["elastic_b"]["loss"] == b["loss"], r


def test_elastic_checkpoint_resumes_from_equal_parameters(runs):
    """The step-4 file written on (4 x 2) is one JAX-format file: JAX's
    restore_checkpoint reads it, its parameters equal to the model slices
    gathered whole at step 4, m and v nonzero."""
    import jax

    from repro.checkpoint import checkpoint as jck
    from repro.configs.tiny import tiny_config as jtiny
    from repro.models import transformer as jtr
    from repro.optim.adamw import adamw_init as jadamw_init

    d = runs.root / "elastic"
    jcfg = jtiny("mistral-nemo-12b")
    like = jax.eval_shape(lambda k: jtr.init_params(jcfg, k),
                          jax.random.PRNGKey(0))
    tree = jck.restore_checkpoint(d, M.ELASTIC_AT, {
        "params": like, "opt": jax.eval_shape(jadamw_init, like)})
    got = [np.asarray(x) for x in jax.tree.leaves(tree["params"])]
    live = runs.mesh[0]["elastic_a"]["params"]
    assert len(got) == len(live)
    assert all(np.array_equal(a, b) for a, b in zip(got, live))
    assert int(tree["opt"]["step"]) == M.ELASTIC_AT
    assert all(np.abs(np.asarray(x)).max() > 0
               for x in jax.tree.leaves(tree["opt"]["m"]))


@pytest.mark.parametrize("cf", M.SMAP_CFS)
def test_smap_under_use_mesh_matches_jax(runs, cf):
    """moe_apply with smap under use_mesh on (2 x 4): JAX's _dispatch_smap
    within SMAP_TOL, the aux loss within 1e-4, one all-reduce over model;
    the one-process stacked form within SMAP_TOL too.  At cf 8 nothing
    drops and smap equals the sort dispatch; at DROP_CF the capacity per
    data shard drops other slots, and the output tells the two apart."""
    from repro_torch.models.layers import mlp_apply
    from repro_torch.models.moe import route, smap_stacked

    jax = runs.jax
    got = runs.mesh[0][("smap", cf)]
    y = got["y"].reshape(jax[f"smap/{cf}/y"].shape)
    np.testing.assert_allclose(y, jax[f"smap/{cf}/y"], **SMAP_TOL)
    np.testing.assert_allclose(got["aux"], float(jax[f"smap/{cf}/aux"]),
                               rtol=1e-4)
    assert got["model_reduces"] == 1
    z = np.load(runs.root / "smap.npz")
    params = {k: torch.from_numpy(z[k]) for k in ("router", "e_wi", "e_wg",
                                                  "e_wo")}
    params["shared"] = {k: torch.from_numpy(z[f"shared_{k}"])
                        for k in ("wi", "wg", "wo")}
    cfg = M.smap_cfg(cf)
    xf = torch.from_numpy(z["x"]).reshape(-1, cfg.d_model)
    _, _, eidx, gate = route(cfg, params, xf)
    stacked, keep = smap_stacked(cfg, params, xf, eidx, gate,
                                 M.SMAP_MESH["data"], M.SMAP_MESH["model"])
    stacked = stacked + mlp_apply(params["shared"], xf)
    np.testing.assert_allclose(stacked.numpy(), y.reshape(stacked.shape),
                               **SMAP_TOL)
    np.testing.assert_allclose(stacked.numpy().reshape(y.shape),
                               jax[f"smap/{cf}/y"], **SMAP_TOL)
    slots = xf.shape[0] * cfg.top_k
    gap = np.abs(jax[f"smap/{cf}/y"] - jax[f"sort/{cf}/y"]).max()
    if cf == 8.0:
        assert int(keep.sum()) == slots
        np.testing.assert_allclose(y, jax[f"sort/{cf}/y"], **SMAP_TOL)
    else:
        assert 0 < int(keep.sum()) < slots
        assert gap > 100 * SMAP_TOL["atol"], gap
        assert np.abs(y - jax[f"sort/{cf}/y"]).max() > 100 * SMAP_TOL["atol"]


def test_decode_hint_under_use_mesh_matches_plain_decode(runs):
    """Decode with decode_cache_hint under use_mesh on (2 x 4), the model
    cut to each rank's shard and each cache's 32 slots cut to 8 a model
    index: every step's logits within DECODE_TOL of JAX's plain and hinted
    decode."""
    got = runs.mesh[0]["decode"]
    assert got["slots"] == [M.DECODE_S // M.SMAP_MESH["model"]] * len(
        got["slots"])
    for t in range(M.DECODE_STEPS):
        for tag in ("plain", "hint"):
            np.testing.assert_allclose(got["logits"][t],
                                       runs.jax[f"decode/{tag}/{t}"],
                                       **DECODE_TOL, err_msg=f"{tag} {t}")


DECODE_ATOL = 1e-5


@pytest.mark.parametrize("arch", list(T.ARCHS))
def test_decode_on_shards_matches_whole_model(runs, arch):
    """decode_step on the model cut to each rank's shard (no use_mesh),
    init_cache's rank caches, on (2 x 2) and (1 x 4): every step's logits
    within DECODE_ATOL of the whole model's one-process decode; each
    rank's caches smaller than the whole's (its rows, heads or
    channels), but MLA's latent cache, which keeps the data cut only."""
    whole = None
    for mesh in MESH_NAMES:
        for r in range(4):
            got = runs.port[r][("decode", arch, mesh)]
            assert got["gap"] <= DECODE_ATOL, (mesh, r, got["gap"])
        if whole is None:
            from repro_torch.models import transformer as tr
            from repro_torch.pytree import leaves
            whole = [tuple(t.shape) for t in leaves(tr.init_cache(
                T.cfg_of(arch), M.DECODE_B, M.DECODE_S, device="meta"))]
        sizes = [int(np.prod(s)) for s in runs.port[0][
            ("decode", arch, mesh)]["shapes"]]
        total = sum(int(np.prod(s)) for s in whole)
        if mesh == "1x4" and T.cfg_of(arch).attn_kind == "mla":
            assert sum(sizes) == total      # MLA's cache: the data cut only
        else:
            assert sum(sizes) < total, mesh


def test_rank_coords_follow_jax_mesh_order(runs):
    """Rank r sits at (r // m, r % m): JAX's make_mesh device order."""
    for m in (M.ELASTIC_A, M.ELASTIC_B):
        devs = runs.jax[f"devices/{M.mesh_name(m)}"]
        for r in range(8):
            assert tuple(np.argwhere(devs == r)[0]) == coords(r, m)


def test_fsdp_trains_and_model_axis_builds(runs):
    """cfg.fsdp over 4 ranks on (2 x 2) trains, as JAX's train does: every
    rank the same losses, within ONE_PROCESS_RTOL of the same run without
    FSDP (the same global step); the (2 x 2) mesh builds: each rank at
    (r // 2, r % 2), both axes of 2."""
    for r, (losses, at) in enumerate(runs.fsdp):
        assert losses == runs.fsdp[0][0], r
        assert len(losses[0]) == 2 and np.isfinite(losses[0]).all()
        np.testing.assert_allclose(losses[0], losses[1],
                                   rtol=ONE_PROCESS_RTOL, atol=0)
        assert at == ((r // 2, r % 2), 2, 2), at


@pytest.mark.parametrize("arch", [
    "mistral-nemo-12b", "command-r-35b", "gemma3-27b", "mistral-large-123b",
    "internvl2-76b", "musicgen-large", "falcon-mamba-7b", "zamba2-7b",
    "deepseek-v2-lite-16b", "kimi-k2-1t-a32b"])
def test_placer_slices_reassemble_every_leaf(arch):
    """Every leaf of each config, on the meta device, cut by model_dims
    for each index of a 16-wide model axis and concatenated back: the
    whole shapes, each slice 1/16 of its cut dim."""
    from repro_torch.configs import get_config
    from repro_torch.convert import param_tree
    from repro_torch.pytree import leaves
    from repro_torch.roofline.compositional import meta_model
    from repro_torch.sharding.partition import (model_dims, shard_tree,
                                                unshard_tree)

    cfg = get_config(arch)
    mesh = {"data": 16, "model": 16}
    tree = param_tree(meta_model(cfg), cfg)
    dims = model_dims(cfg, tree, mesh)
    shards = [shard_tree(cfg, tree, mesh, r) for r in range(16)]
    back = unshard_tree(shards, dims)
    assert any(d is not None for d in dims)
    for whole, got, part, d in zip(leaves(tree), leaves(back),
                                   leaves(shards[3]), dims):
        assert got.shape == whole.shape
        if d is not None:
            assert part.shape[d] * 16 == whole.shape[d]


def test_one_rank_mesh_calls_no_collective(monkeypatch):
    """The mesh (1 x 1) of one process: the data and model axes are
    DP.single, and the tensor-parallel collectives are the identity, with
    no call into torch.distributed."""
    import torch.distributed as dist

    from repro_torch.sharding import tp
    from repro_torch.sharding.context import current_model, use_dp
    from repro_torch.train.dp import DP, Ranks

    def boom(*a, **k):
        raise AssertionError("a collective on one process")

    for name in ("all_reduce", "all_gather", "broadcast", "barrier",
                 "all_to_all_single", "new_group"):
        monkeypatch.setattr(dist, name, boom)
    r = Ranks(DP.single("cpu"), {"data": 1, "model": 1})
    assert r.mesh == {"data": 1, "model": 1} and r.coords == (0, 0)
    assert not r.data.distributed and not r.model.distributed
    x = torch.arange(6.0)
    with use_dp(None, r.model):
        assert current_model() is None
        for f in (tp.copy, tp.reduce, tp.gather, tp.split):
            assert f(x) is x


def test_placer_values_round_trip_and_cut_model_matches():
    """On a tiny config's real weights: shard_tree then unshard_tree gives
    every leaf back bit for bit, Model.cut_to holds the placer's slice of
    each leaf, marked with its dim, and so does a JAX-layout numpy tree
    carried onto the rank (convert.shard_params_from_numpy)."""
    from repro_torch import convert
    from repro_torch.convert import param_tree
    from repro_torch.models.transformer import Model
    from repro_torch.pytree import leaves
    from repro_torch.sharding import tp
    from repro_torch.sharding.partition import (model_dims, shard_tree,
                                                unshard_tree)

    cfg = T.cfg_of("zamba2-7b")
    mesh = {"data": 1, "model": 4}
    model = Model(cfg, device="cpu")
    tree = param_tree(model, cfg)
    dims = model_dims(cfg, tree, mesh)
    shards = [shard_tree(cfg, tree, mesh, r) for r in range(4)]
    for a, b in zip(leaves(unshard_tree(shards, dims)), leaves(tree)):
        assert torch.equal(a, b)
    ranks_ = types.SimpleNamespace(mesh=mesh,
                                   model=types.SimpleNamespace(rank=2))
    want = [t.clone() for t in leaves(shards[2])]
    carried = convert.shard_params_from_numpy(
        convert.params_to_numpy(model, cfg), cfg, ranks_, device="cpu")
    assert model.cut_to(ranks_) == dims
    for m_ in (model, carried):
        for p, w, d in zip(leaves(param_tree(m_, cfg)), want, dims):
            assert torch.equal(p, w) and tp.cut(p) == d
