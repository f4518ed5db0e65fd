"""The rank processes' side of tests/test_torch_model_axis.py: the mesh's
model axis over ``torch.distributed`` gloo ranks on the CPU.

``repro_torch.launch.ranks.spawn`` pickles these functions by name, so
they live in a module that a fresh process imports without JAX: each
takes (rank, world, device, ...), checks what it can with asserts (a
failed one fails the spawn) and returns plain data (numpy arrays, lists,
dicts).  Every training run starts from a step-0 checkpoint the test
wrote from the port's seeded weights (``_train_ranks.init_checkpoint``),
in its own copy of the directory, so that JAX's ``train`` resumes the
same state.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

import _train_ranks as T

MESHES = ({"data": 2, "model": 2}, {"data": 1, "model": 4})
ELASTIC_A, ELASTIC_B = {"data": 4, "model": 2}, {"data": 2, "model": 4}
ELASTIC_BATCH, ELASTIC_LR, ELASTIC_AT, ELASTIC_TO = 8, 3e-3, 4, 8
SMAP_MESH = {"data": 2, "model": 4}
SMAP_ARCH = "kimi-k2-1t-a32b"
SMAP_CFS = (8.0, T.DROP_CF)
DECODE_B, DECODE_S, DECODE_STEPS = 4, 32, 4


def mesh_name(mesh):
    return f"{mesh['data']}x{mesh['model']}"


def cfg_of(arch, **kw):
    """``_train_ranks.cfg_of``, the MoE arch at DROP_CF (its slots drop)."""
    if arch == T.MOE_ARCH:
        kw = {"capacity_factor": T.DROP_CF, **kw}
    return T.cfg_of(arch, **kw)


def smap_cfg(cf):
    from repro_torch.configs.tiny import tiny_config
    return tiny_config(SMAP_ARCH, n_experts=8, top_k=2, capacity_factor=cf,
                       moe_impl="smap")


def run(cfg, d, dp, mesh=None, *, steps=T.STEPS, batch=T.BATCH, lr=T.LR,
        ckpt_every=100):
    """``train`` from the checkpoint in ``d`` to ``steps`` on ``mesh``:
    the history, rank 0's whole final parameters (JAX's leaf order),
    each rank's parameter, m and v bytes."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.convert import param_tree, stack_tree
    from repro_torch.pytree import leaves, unflatten
    from repro_torch.train.trainer import train, whole_params

    out = train(cfg, ShapeSpec("tiny", T.SEQ, batch, "train"), steps=steps,
                ckpt_dir=d, ckpt_every=ckpt_every, lr=lr, log_every=1,
                device="cpu", dp=dp, mesh=mesh)
    rec = {k: [h[k] for h in out["history"]]
           for k in ("step", "loss", "ce", "aux", "grad_norm")}
    model = out["model"]
    tree = param_tree(model, cfg)
    rec["param_bytes"] = sum(p.numel() * p.element_size()
                             for p in leaves(tree))
    if out["zero"] is None:
        flat = leaves(tree)
    else:
        flat = whole_params(model, cfg, out["ranks"])
        rec["m_bytes"] = out["zero"].nbytes(out["opt"]["m"])
    if flat is not None:
        rec["params"] = [t.numpy() for t in leaves(stack_tree(
            unflatten(tree, flat)))]
    return rec


def train_cases(rank, world, device, root):
    """Over 4 ranks: every arch on (2 x 2) and (1 x 4), then in one
    process (rank 1) and on a group of one with the mesh (1 x 1) (rank
    0); FSDP over the 4 ranks (``fsdp_trains``); the smap-in-train
    repair over 2 ranks on (2 x 1) (ranks 0-1), while ranks 2-3 run the
    sort dispatch there; decode on shards.  Returns {case: record} of this rank."""
    import torch.distributed as dist

    from repro_torch.train.dp import DP

    root = Path(root)
    pair = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    ones = [dist.new_group([r]) for r in range(world)]
    dp4 = DP(dist.group.WORLD, device)
    dp2 = DP(pair[rank // 2], device)
    out = {}
    for arch in T.ARCHS:
        cfg, a = cfg_of(arch), root / arch
        for mesh in MESHES:
            out[(arch, mesh_name(mesh))] = run(cfg, a / mesh_name(mesh), dp4,
                                               mesh)
        if rank == 0:
            out[(arch, "1x1")] = run(cfg, a / "1x1", DP(ones[0], device),
                                     {"data": 1, "model": 1})
        elif rank == 1:
            out[(arch, "one")] = run(cfg, a / "one", None)
        dp4.barrier()
    out["fsdp"] = fsdp_trains(dp4)
    impl = "smap" if rank < 2 else "sort"
    out["repair"] = run(cfg_of(T.MOE_ARCH, moe_impl=impl),
                        root / "repair" / impl, dp2, {"data": 2, "model": 1})
    for arch in T.ARCHS:
        for mesh in MESHES:
            out[("decode", arch, mesh_name(mesh))] = decode_shards(
                dp4, root / arch / "init", arch, mesh)
    return out


def decode_shards(dp, init, arch, mesh):
    """DECODE_STEPS decode steps of ``arch``'s tiny config (the step-0
    checkpoint's weights) with the model cut to each rank's shard on
    ``mesh`` (no ``use_mesh``: every cache holds the rank's rows and its
    heads or channels), against the whole model's decode on this rank.
    Returns the worst gap of the logits and each layer cache's shapes."""
    from repro_torch.convert import param_tree
    from repro_torch.models import transformer as tr
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.dp import Ranks
    from repro_torch.train.trainer import restore_state

    cfg = cfg_of(arch)
    model = tr.Model(cfg, device="cpu")
    restore_state(init, 0, model, cfg, adamw_init(param_tree(model, cfg)))

    def inputs(t, rows=slice(None)):
        return {"tokens": torch.full((DECODE_B, 1), 3 + t,
                                     dtype=torch.int32)[rows],
                "pos": torch.full((DECODE_B,), t, dtype=torch.int32)[rows]}

    cache = tr.init_cache(cfg, DECODE_B, DECODE_S, device="cpu")
    want = []
    for t in range(DECODE_STEPS):
        lg, cache = tr.decode_step(cfg, model, cache, inputs(t))
        want.append(lg)
    ranks = Ranks(dp, mesh)
    model.cut_to(ranks)
    rows = ranks.data.rows(DECODE_B)
    cache = tr.init_cache(cfg, DECODE_B, DECODE_S, device="cpu",
                          ranks=ranks)
    shapes = [tuple(t.shape) for c in cache for t in _tensors(c)]
    gap = 0.0
    for t in range(DECODE_STEPS):
        lg, cache = tr.decode_step(cfg, model, cache, inputs(t, rows))
        lg = ranks.data.all_gather(lg.contiguous(), 0)
        gap = max(gap, float((lg - want[t]).abs().max()))
    return {"gap": gap, "shapes": shapes}


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    return [tree]


def mesh_cases(rank, world, device, root):
    """Over 8 ranks: the elastic (4 x 2) -> (2 x 4) from the step-0
    checkpoint; ``moe_apply`` with smap under ``use_mesh`` on (2 x 4) at
    each of SMAP_CFS; decode with ``decode_cache_hint`` under
    ``use_mesh`` on (2 x 4).  Returns {case: record} of this rank."""
    import torch.distributed as dist

    from repro_torch.train.dp import DP

    root = Path(root)
    dp = DP(dist.group.WORLD, device)
    cfg = T.cfg_of("mistral-nemo-12b")
    d = root / "elastic"
    out = {"elastic_a": run(cfg, d, dp, ELASTIC_A, steps=ELASTIC_AT,
                            batch=ELASTIC_BATCH, lr=ELASTIC_LR,
                            ckpt_every=ELASTIC_AT),
           "elastic_b": run(cfg, d, dp, ELASTIC_B, steps=ELASTIC_TO,
                            batch=ELASTIC_BATCH, lr=ELASTIC_LR,
                            ckpt_every=ELASTIC_AT)}
    for cf in SMAP_CFS:
        out[("smap", cf)] = smap(dp, root / "smap.npz", cf)
    out["decode"] = decode(dp, root / "mistral-nemo-12b" / "init")
    return out


def smap(dp, path, cf):
    """``moe_apply`` with smap under ``use_mesh`` on SMAP_MESH: each rank
    its data shard's rows and its expert shard.  Returns the output
    gathered over data, the summed aux loss and the model calls made."""
    from repro_torch.models.moe import moe_apply
    from repro_torch.sharding.context import use_mesh
    from repro_torch.train.dp import Ranks

    z = np.load(path)
    ranks = Ranks(dp, SMAP_MESH)
    m, j = ranks.model.world, ranks.model.rank
    E_l = z["e_wi"].shape[0] // m
    params = {k: torch.from_numpy(z[k]) for k in ("router",)}
    params.update({k: torch.from_numpy(z[k][j * E_l:(j + 1) * E_l])
                   for k in ("e_wi", "e_wg", "e_wo")})
    if "shared_wi" in z.files:
        params["shared"] = {k: torch.from_numpy(z[f"shared_{k}"])
                            for k in ("wi", "wg", "wo")}
    x = torch.from_numpy(z["x"])[ranks.data.rows(z["x"].shape[0])]
    with use_mesh(ranks), torch.no_grad():
        y, aux = moe_apply(smap_cfg(cf), params, x)
    return {"y": ranks.data.all_gather(y.contiguous(), 0).numpy(),
            "aux": float(ranks.data.sum_(aux.clone())),
            "model_reduces": ranks.model.stats["calls"]["all_reduce_sum"]}


def decode(dp, init):
    """DECODE_STEPS decode steps of tiny mistral-nemo-12b (the step-0
    checkpoint's weights) under ``use_mesh`` with ``decode_cache_hint``
    on SMAP_MESH: the model cut to each rank's shard, the caches cut by
    ``init_cache``.  Returns the logits gathered over data, a step each,
    and each GQA cache's slots on this rank."""
    from repro_torch.models import transformer as tr
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.convert import param_tree
    from repro_torch.sharding.context import use_mesh
    from repro_torch.train.dp import Ranks
    from repro_torch.train.trainer import restore_state

    cfg = T.cfg_of("mistral-nemo-12b").scaled(decode_cache_hint=True)
    model = tr.Model(cfg, device="cpu")
    restore_state(init, 0, model, cfg, adamw_init(param_tree(model, cfg)))
    ranks = Ranks(dp, SMAP_MESH)
    model.cut_to(ranks)
    rows = ranks.data.rows(DECODE_B)
    logits = []
    with use_mesh(ranks):
        cache = tr.init_cache(cfg, DECODE_B, DECODE_S, device="cpu",
                              ranks=ranks)
        slots = [c["k"].shape[1] for c in cache]
        for t in range(DECODE_STEPS):
            inputs = {"tokens": torch.full((DECODE_B, 1), 3 + t,
                                           dtype=torch.int32)[rows],
                      "pos": torch.full((DECODE_B,), t,
                                        dtype=torch.int32)[rows]}
            lg, cache = tr.decode_step(cfg, model, cache, inputs)
            logits.append(ranks.data.all_gather(lg.contiguous(), 0).numpy())
    return {"logits": logits, "slots": slots}


def fsdp_trains(dp):
    """FSDP over the ranks trains, as JAX's ``train`` does: tiny
    mistral-nemo-12b with ``fsdp=True`` on (2 x 2), beside the same run
    without it (the same global step); and the (2 x 2) mesh builds.
    Returns (both runs' losses, each rank's coordinates and axis
    sizes)."""
    from repro_torch.train.dp import Ranks
    from repro_torch.train.trainer import train

    mesh = {"data": dp.world // 2, "model": 2}
    losses = [[h["loss"] for h in train(
        T.cfg_of("mistral-nemo-12b", fsdp=f), T.shape_of(), steps=2,
        device="cpu", dp=dp, mesh=mesh, log_every=1)["history"]]
        for f in (True, False)]
    r = Ranks(dp, mesh)
    return losses, (r.coords, r.data.world, r.model.world)
