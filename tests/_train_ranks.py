"""The rank processes' side of tests/test_torch_train_ranks.py: the
training path over ``torch.distributed`` gloo ranks on the CPU.

``repro_torch.launch.ranks.spawn`` pickles these functions by name, so
they live in a module that a fresh process imports without JAX: each
takes (rank, world, device, ...), checks what it can with asserts (a
failed one fails the spawn) and returns plain data (numpy arrays, lists,
dicts).  Every run starts from a step-0 checkpoint the test wrote from
the port's seeded weights (``init_checkpoint``), in its own copy of the
directory, so that JAX's ``train`` resumes the same state.
"""
from __future__ import annotations

import shutil
from pathlib import Path

import numpy as np
import torch

ARCHS = {"mistral-nemo-12b": {}, "falcon-mamba-7b": {"ssm_impl": "jnp"},
         "zamba2-7b": {}, "deepseek-v2-lite-16b": {}}
MOE_ARCH = "deepseek-v2-lite-16b"
SEQ, BATCH, STEPS, LR = 32, 4, 3, 3e-3
FALLBACK_BATCH = 3          # over 2 ranks: every rank takes the whole batch
DROP_CF = 0.5               # a capacity factor at which the MoE drops slots
RESUME_AT, RESUME_TO = 4, 8
PIPE_S, PIPE_M, PIPE_MB, PIPE_D, PIPE_LR, PIPE_STEPS = 4, 8, 4, 16, 0.1, 20
COMP_RANKS, COMP_ROUNDS = 8, 3


def cfg_of(arch, **kw):
    from repro_torch.configs.tiny import tiny_config
    return tiny_config(arch, **{**ARCHS.get(arch, {}), **kw})


def shape_of(batch=BATCH):
    from repro_torch.configs.base import ShapeSpec
    return ShapeSpec("tiny", SEQ, batch, "train")


def init_checkpoint(arch, d, seed=0):
    """Step 0 of ``arch``'s tiny config: the port's weights drawn from
    ``seed`` and zero AdamW state, in the JAX package's format."""
    from repro_torch.checkpoint.checkpoint import save_checkpoint
    from repro_torch.convert import param_tree
    from repro_torch.models.transformer import Model
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.trainer import state_tree

    cfg = cfg_of(arch)
    model = Model(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(seed))
    save_checkpoint(d, 0, state_tree(model, cfg,
                                     adamw_init(param_tree(model, cfg))))


def copy_dir(src, dst):
    shutil.copytree(src, dst)
    return dst


def run(cfg, d, dp=None, *, steps=STEPS, batch=BATCH, device="cpu"):
    """``train`` from the checkpoint in ``d`` to ``steps``: the history,
    rank 0's final parameters (JAX's leaf order), each rank's m and v
    bytes.  Over ranks the whole state is gathered once more, to rank 0
    only."""
    from repro_torch.convert import param_tree, params_to_numpy
    from repro_torch.pytree import leaves
    from repro_torch.train.trainer import train

    out = train(cfg, shape_of(batch), steps=steps, ckpt_dir=d,
                ckpt_every=100, lr=LR, log_every=1, device=device, dp=dp)
    rec = {k: [h[k] for h in out["history"]]
           for k in ("step", "loss", "ce", "aux", "grad_norm")}
    if dp is None or dp.rank == 0:
        rec["params"] = leaves(params_to_numpy(out["model"], cfg))
    if out["zero"] is not None:
        rec["m_bytes"] = out["zero"].nbytes(out["opt"]["m"])
        rec["v_bytes"] = out["zero"].nbytes(out["opt"]["v"])
        whole = out["zero"].gather_state(param_tree(out["model"], cfg),
                                         out["opt"])
        assert (whole is None) == (dp.rank != 0), dp
    return rec


def moe_on_card(rank, world, device, root):
    """The MoE at DROP_CF over the ranks on the card, float32 with TF32
    off, from the checkpoint in ``root``: autograd runs the backward, and
    so the forward each checkpointed layer recomputes, on a thread of its
    own there.  Returns the run's record."""
    import torch.distributed as dist

    from repro_torch.train.dp import DP

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cfg_of(MOE_ARCH, capacity_factor=DROP_CF)
    assert cfg.remat == "unit", cfg.remat
    return run(cfg, root, DP(dist.group.WORLD, device))


def train_cases(rank, world, device, root):
    """Over 4 ranks: every arch at W = 4 (the world), W = 2 (ranks 0-1;
    ranks 2-3 run the replicated fallback of FALLBACK_BATCH rows, and the
    MoE at DROP_CF), W = 1 (rank 0, a group of one) and one process
    (rank 1, no group); then the MoE at DROP_CF over 4 and 2 ranks and in
    one process; then the W = 4 checkpoint at RESUME_AT resumed over 2
    ranks (ranks 0-1) and in one process (rank 2); a crash over 4 ranks;
    ``moe_drops`` over 4 and 2 ranks; the pipeline over 4.  Returns
    {case: record} of this rank."""
    import torch.distributed as dist

    from repro_torch.train.dp import DP

    root = Path(root)
    groups = {2: [dist.new_group([0, 1]), dist.new_group([2, 3])],
              1: [dist.new_group([r]) for r in range(world)]}
    dp4 = DP(dist.group.WORLD, device)
    dp2 = DP(groups[2][rank // 2], device)
    dp1 = DP(groups[1][rank], device)
    out = {}
    for arch in ARCHS:
        cfg, a = cfg_of(arch), root / arch
        out[(arch, 4)] = run(cfg, a / "w4", dp4)
        if rank < 2:
            out[(arch, 2)] = run(cfg, a / "w2", dp2)
        elif arch == "mistral-nemo-12b":
            out["fallback"] = run(cfg, a / "fallback", dp2,
                                  batch=FALLBACK_BATCH)
        elif arch == MOE_ARCH:
            out[("drop", 2)] = run(cfg_of(arch, capacity_factor=DROP_CF),
                                   a / "drop_w2", dp2)
        if rank == 0:
            out[(arch, 1)] = run(cfg, a / "w1", dp1)
        elif rank == 1:
            out[(arch, "one")] = run(cfg, a / "one", None)
        elif rank == 2 and arch == MOE_ARCH:
            out[("drop", "one")] = run(cfg_of(arch, capacity_factor=DROP_CF),
                                       a / "drop_one", None)
        dp4.barrier()
    drop = cfg_of(MOE_ARCH, capacity_factor=DROP_CF)
    out[("drop", 4)] = run(drop, root / MOE_ARCH / "drop_w4", dp4)
    # the elastic move: W = 4 to RESUME_AT, then over 2 ranks and in one
    # process from that one file
    cfg = cfg_of("mistral-nemo-12b")
    ck = root / "resume"
    out["resume_w4"] = run(cfg, ck / "w4", dp4, steps=RESUME_AT)
    if rank == 0:
        copy_dir(ck / "w4", ck / "w2")
        copy_dir(ck / "w4", ck / "one")
    dp4.barrier()
    if rank < 2:
        out["resume_w2"] = run(cfg, ck / "w2", dp2, steps=RESUME_TO)
    elif rank == 2:
        out["resume_one"] = run(cfg, ck / "one", None, steps=RESUME_TO)
    out["crash"] = crash(cfg, root / "crash", dp4)
    out["moe"] = moe_drops(rank, dp4, root / "moe.npz")
    if rank < 2:
        out["moe2"] = moe_drops(rank, dp2, root / "moe.npz")
    out["pipeline"] = pipeline(dp4, root / "pipe.npz")
    return out


def crash(cfg, d, dp):
    """``fail_at`` over ranks: a checkpoint at 2, the failure at 3 on
    every rank once the file is durable.  Returns (what was raised, the
    latest step in ``d`` as this rank sees it)."""
    from repro_torch.checkpoint.checkpoint import latest_step
    from repro_torch.train.trainer import train

    try:
        train(cfg, shape_of(), steps=6, ckpt_dir=d, ckpt_every=2, lr=LR,
              fail_at=3, log_every=1, device="cpu", dp=dp)
        said = None
    except RuntimeError as e:
        said = str(e)
    return said, latest_step(d)


def moe_drops(rank, dp, path):
    """``moe_apply`` over ``dp``'s ranks at DROP_CF on this rank's rows of
    one global input, and, as the negative control, on the same rows with
    no group (a capacity a rank).  Returns the gathered outputs, the
    summed aux loss, and each slot's expert and keep mask (JAX's slot
    order, global) both ways."""
    from repro_torch.models import moe
    from repro_torch.sharding.context import use_dp

    z = np.load(path)
    cfg = cfg_of(MOE_ARCH, capacity_factor=DROP_CF)
    params = {k: torch.from_numpy(z[k]) for k in ("router", "e_wi", "e_wg",
                                                  "e_wo")}
    if "shared_wi" in z.files:
        params["shared"] = {k: torch.from_numpy(z[f"shared_{k}"])
                            for k in ("wi", "wg", "wo")}
    x = torch.from_numpy(z["x"])[dp.rows(z["x"].shape[0])]
    seen = []
    plan = moe.dispatch_plan

    def spy(cfg, eidx, C, base=None):
        res = plan(cfg, eidx, C, base)
        keep = torch.empty_like(res[3])
        keep[res[0]] = res[3]                      # sorted -> slot order
        seen.append((eidx.reshape(-1).clone(), keep))
        return res

    got = {}
    moe.dispatch_plan = spy
    try:
        for name, ctx in (("global", dp), ("per_rank", None)):
            seen.clear()
            with use_dp(ctx), torch.no_grad():
                y, aux = moe.moe_apply(cfg, params, x)
            (eidx, keep), = seen
            got[name] = {"y": dp.all_gather(y).numpy(),
                         "aux": float(dp.sum_(aux.clone())),
                         "eidx": dp.all_gather(eidx).numpy(),
                         "keep": dp.all_gather(keep).numpy()}
    finally:
        moe.dispatch_plan = plan
    return got


def pipeline(dp, path):
    """The toy pipeline with one stage a rank: outputs, then PIPE_STEPS
    SGD steps; rank s returns its stage's final weights."""
    from repro_torch.train.pipeline import (make_pipeline_train_step,
                                            pipeline_apply)

    z = np.load(path)
    w, x, tgt = (torch.from_numpy(z[k]) for k in ("w", "x", "tgt"))
    mine = w[dp.rank]
    y = pipeline_apply(pipe_stage, mine, x, dp)
    step = make_pipeline_train_step(pipe_stage, pipe_loss, lr=PIPE_LR, dp=dp)
    losses = []
    for _ in range(PIPE_STEPS):
        mine, loss = step(mine, x, tgt)
        losses.append(float(loss))
    return {"y": y.numpy(), "w": mine.numpy(), "losses": losses,
            "shifts": dp.stats["calls"]["shift"]}


def pipe_stage(p, x):
    return torch.tanh(x @ p)


def pipe_loss(out, t):
    return torch.mean((out - t) ** 2)


def compressed(rank, world, device, path):
    """``dp_allreduce_compressed`` over ``world`` ranks, each its row of
    the stacked inputs, COMP_ROUNDS rounds of error feedback."""
    import torch.distributed as dist

    from repro_torch.optim.compression import dp_allreduce_compressed
    from repro_torch.train.dp import DP

    dp = DP(dist.group.WORLD, device)
    z = np.load(path)
    grads = {k: torch.from_numpy(z[k][rank]) for k in ("g", "h")}
    err = {k: torch.from_numpy(z[f"e_{k}"][rank]) for k in ("g", "h")}
    rounds = []
    for _ in range(COMP_ROUNDS):
        out, err = dp_allreduce_compressed(grads, err, dp)
        rounds.append({"out": {k: v.numpy() for k, v in out.items()},
                       "err": {k: v.numpy() for k, v in err.items()}})
    return rounds, dict(dp.stats["bytes"])


def smap_and_fsdp(rank, world, device):
    """moe_impl='smap' trains over the ranks (the sort dispatch, as
    JAX's train takes it), cfg.fsdp trains over them beside the same run
    without it, and a mesh with a model axis builds.  Returns (the smap run's losses, the FSDP and plain
    runs' losses, the model axis's size)."""
    import torch.distributed as dist

    from repro_torch.train.dp import DP
    from repro_torch.train.trainer import train

    dp = DP(dist.group.WORLD, device)
    out = train(cfg_of(MOE_ARCH, moe_impl="smap"), shape_of(), steps=1,
                device="cpu", dp=dp)
    said = [[h["loss"] for h in out["history"]]]
    said.append([[h["loss"] for h in train(
        cfg_of("mistral-nemo-12b", fsdp=f), shape_of(), steps=2,
        device="cpu", dp=dp, log_every=1)["history"]] for f in (True, False)])
    mesh = DP(dist.group.WORLD, device, mesh={"data": world // 2,
                                             "model": 2})
    said.append(mesh.world)
    return said
