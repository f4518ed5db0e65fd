"""Training driver: the train step over the stateless data stream, async
checkpoints and crash/restart (port of ``repro/train/trainer.py``).

Fault-tolerance model, as the JAX package's:
  * checkpoint/restart: AsyncCheckpointer every ``ckpt_every`` steps;
    a restart resumes from the latest checkpoint.  Data is stateless by
    step, so no batch is lost or repeated.
  * the injected failure (``fail_at``) flushes the async writer first: it
    models a crash AFTER the last checkpoint is durable.

The checkpoint holds {"params", "opt": {"m", "v", "step"}} in the JAX
package's layout (``convert.param_tree``, stacked), so a run either
package starts the other resumes.

Over ranks (``dp``, ``train/dp.py``: one process a rank, the W ranks the
data axis of the mesh {"data": W, "model": 1}) the step is JAX's sharded
step restated: each rank takes its rows of the global batch
(``dp.rows``; every rank the whole batch where W does not divide it, as
``batch_pspec`` falls back, and then no gradient is summed), its loss is
its share of the global loss and the gradients are summed
(``train/step.py``), and the optimizer state is ZeRO-1 sharded
(``optim/adamw.py``'s ``Zero1``).  Rank 0 draws the weights from the seed
and broadcasts them; every rank's parameter checksum is then checked
equal.  A checkpoint is one file whatever W is: the m and v slices are
gathered to rank 0, which writes the JAX package's format, so a run resumes
over any number of ranks (the elastic re-mesh) and in either package.
Restoring, every rank reads the file a leaf at a time and keeps its
slice.  ``fail_at`` waits for the writer, then raises on every rank.

Over a (data x model) mesh (``mesh={"data": d, "model": m}`` beside
``dp``, the group of all d * m ranks: ``train/dp.Ranks``) the model is
built whole, rank 0's weights are broadcast and, from a checkpoint,
restored whole, and then every rank cuts it to its model index's shard
(``Model.cut_to``); the batch's rows split over data, the step's layers
run over the model group, ZeRO-1 cuts the state over data beside the
model cut, and the checksum sums a cut leaf's slices over model.  A
checkpoint is still one file in JAX's format: the ZeRO slices gathered
over data and the model slices over model to rank 0; a restore cuts by
the mesh it runs on, whatever mesh wrote the file.

Under FSDP (``cfg.fsdp`` over a data axis of more than one rank) the cut
also frees each parameter's whole for its data slice (``Model.cut_to``,
after rank 0's broadcast), m and v are the same slices, and the step
gathers the weights a layer at a time (``sharding/fsdp.py``).  A restore
reads the file a leaf at a time and keeps only each rank's slices; the
checkpoint gathers them over data, then over model, into one JAX-format
file, and the checksum sums a sliced leaf over data.  At a global batch
of 1 over a data axis of more than one rank the sequence is cut instead
of the batch (``dp.split``): each rank takes its block of the sequence,
and the step is split as a batch split is.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from repro_torch.checkpoint.checkpoint import (AsyncCheckpointer, latest_step,
                                               read_leaves, restore_checkpoint)
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.convert import (load_stacked, param_tree, stack_like,
                                 stack_tree)
from repro_torch.core.client import _resolve_device
from repro_torch.data.pipeline import SyntheticLM, make_batch
from repro_torch.models.transformer import Model
from repro_torch.optim.adamw import Zero1, adamw_init
from repro_torch.pytree import leaves, tree_map
from repro_torch.sharding import fsdp
from repro_torch.train.dp import DP, Ranks
from repro_torch.train.step import check_trainable, train_step


@dataclass
class TrainState:
    model: Model
    opt: dict
    step: int


def state_tree(model: Model, cfg: ModelConfig, opt: dict) -> dict:
    """{"params", "opt"} in the JAX package's layout: new tensors, the
    scanned stages stacked."""
    return {"params": stack_tree(param_tree(model, cfg)),
            "opt": stack_tree(opt)}


def restore_state(ckpt_dir, step: int, model: Model, cfg: ModelConfig,
                  opt: dict) -> dict:
    """Load checkpoint ``step`` into ``model``'s parameters and ``opt``'s
    m and v; returns the opt state with the checkpoint's step count."""
    like = {"params": stack_like(param_tree(model, cfg)),
            "opt": stack_like(opt)}
    tree = restore_checkpoint(ckpt_dir, step, like, device=model.device)
    load_stacked(param_tree(model, cfg), tree["params"])
    load_stacked(opt["m"], tree["opt"]["m"], "opt/m")
    load_stacked(opt["v"], tree["opt"]["v"], "opt/v")
    return dict(opt, step=tree["opt"]["step"])


def train(cfg: ModelConfig, shape: ShapeSpec, *, steps: int, ckpt_dir=None,
          ckpt_every: int = 50, lr: float = 3e-4, seed: int = 0,
          log_every: int = 10, fail_at: int | None = None,
          device=None, dp=None, mesh=None) -> dict:
    """Run (or resume) training on ``device`` (the card unless the caller
    names another), or over ``dp``'s ranks on ``dp.device``, the mesh
    ``mesh`` ({"data": d, "model": m}; by default every rank on data).
    With no checkpoint to resume from, the weights are drawn from a
    generator seeded with ``seed``.  ``fail_at`` raises midway to
    exercise the crash/restart path in tests.  Returns {"history",
    "model", "opt", "zero", "ranks"}: over ranks "model" holds this
    rank's shard, "opt" its slices and "zero" the plan; in one process
    "opt" is the whole state and "zero" None."""
    check_trainable(cfg)
    if dp is None or not dp.distributed:
        dp = DP.single(_resolve_device(device, "train"))
    ranks = Ranks(dp, mesh)
    dev = dp.device
    data, tpg = ranks.data, ranks.model
    B = shape.global_batch
    rows, seq = data.split(B, shape.seq_len)
    ds = SyntheticLM(cfg.vocab_size, shape.seq_len, B, seed=seed,
                     embed_dim=cfg.d_model if cfg.frontend == "embed" else 0)
    model = Model(cfg, device=dev,
                  generator=torch.Generator(device=dev).manual_seed(seed))
    if dp.distributed:
        # every rank draws from the seed; rank 0's draw is broadcast, so
        # that the ranks hold rank 0's weights whatever their generators
        # give
        with torch.no_grad():
            for p in leaves(param_tree(model, cfg)):
                dp.broadcast(p.detach(), 0)
    last = latest_step(ckpt_dir) if ckpt_dir else None
    if dp.distributed:
        last = int(dp.agree(-1 if last is None else last, "min"))
        last = None if last < 0 else last
        dims = model.cut_to(ranks)
        zero = Zero1(cfg, param_tree(model, cfg), data, tpg, dims,
                     fsdp=model.data_group is not None)
        if last is not None:
            restore_params(ckpt_dir, last, model, cfg, zero)
        opt = (restore_opt(ckpt_dir, last, zero, dev) if last is not None
               else zero.init(param_tree(model, cfg)))
        check_replicas(model, cfg, dp)
    else:
        zero, opt = None, adamw_init(param_tree(model, cfg))
        if last is not None:
            opt = restore_state(ckpt_dir, last, model, cfg, opt)
    start = last or 0
    ckpt = AsyncCheckpointer(ckpt_dir) if ckpt_dir and dp.rank == 0 else None

    def save(at):
        tree = (rank_state(model, cfg, opt, zero, ranks) if zero
                else state_tree(model, cfg, opt))
        if ckpt:
            ckpt.save(at, tree, copy=zero is None)

    history = []
    t0 = time.time()
    for step in range(start, steps):
        if fail_at is not None and step == fail_at:
            if ckpt:
                ckpt.wait()
            dp.barrier()            # the checkpoint is durable on every rank
            raise RuntimeError(f"injected failure at step {step}")
        batch = make_batch(ds, step, device=dev, dtype=cfg.param_dtype,
                           rows=rows, seq=seq)
        split = data.distributed and (data.shards(B) or seq is not None)
        model, opt, metrics = train_step(cfg, model, opt, batch, lr=lr,
                                         dp=data if split else None,
                                         zero=zero, seq=seq is not None)
        if step % log_every == 0 or step == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["wall_s"] = round(time.time() - t0, 2)
            history.append(m)
            if dp.rank == 0:
                over = f" ranks={dp.world}" if dp.distributed else ""
                if tpg.world > 1:
                    over += f" model={tpg.world}"
                print(f"[train] step={step} loss={m['loss']:.4f} "
                      f"gnorm={m['grad_norm']:.3f}{over}", flush=True)
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            save(step + 1)
    if ckpt_dir:
        save(steps)
        if ckpt:
            ckpt.wait()
        dp.barrier()
    return {"history": history, "model": model, "opt": opt, "zero": zero,
            "ranks": ranks}


def param_checksum(model: Model, cfg: ModelConfig):
    """Each parameter leaf's float64 sum and sum of squares: [2 n]; of a
    model cut over the data axis (FSDP), a sliced leaf's sums summed over
    data, and over the model axis, a cut leaf's sums summed over its
    slices."""
    flat = leaves(param_tree(model, cfg))
    sums = torch.stack([f(p.detach().double()) for p in flat
                        for f in (torch.sum, lambda x: torch.sum(x * x))])
    d = getattr(model, "data_group", None)
    if d is not None and d.world > 1:
        cut = torch.tensor([fsdp.marked(p) for p in flat for _ in range(2)],
                           device=sums.device)
        sums = torch.where(cut, d.sum_(torch.where(cut, sums, 0.0)), sums)
    g = getattr(model, "model_group", None)
    if g is None or g.world == 1:
        return sums
    cut = torch.tensor([d is not None for d in model.model_dims
                        for _ in range(2)], device=sums.device)
    return torch.where(cut, g.sum_(torch.where(cut, sums, 0.0)), sums)


def check_replicas(model: Model, cfg: ModelConfig, dp):
    """Raise unless every rank of ``dp`` holds the same parameters
    (checksums)."""
    sums = dp.all_gather(param_checksum(model, cfg)[None])
    if not bool((sums == sums[0]).all()):
        bad = [r for r in range(dp.world) if not torch.equal(sums[r],
                                                             sums[0])]
        raise RuntimeError(f"rank {dp.rank}: the parameters of ranks {bad} "
                           f"differ from rank 0's")


@torch.no_grad()
def whole_params(model: Model, cfg: ModelConfig, ranks,
                 zero: Zero1 | None = None) -> list | None:
    """The parameters' whole leaves (``param_tree`` order, detached) on
    rank 0, None on the others: under FSDP the data slices gathered to
    data index 0 (``zero``'s plan, made here if None), then the model
    slices over data index 0's model group."""
    flat = [p.detach() for p in leaves(param_tree(model, cfg))]
    if getattr(model, "data_group", None) is not None:
        if zero is None:
            zero = Zero1(cfg, param_tree(model, cfg), ranks.data,
                         ranks.model, model.model_dims, fsdp=True)
        return zero.gather_tree([None if v is None else p for p, v in
                                 zip(flat, zero.views)], flat[0].device)
    if ranks.model.world == 1:
        return flat if ranks.rank == 0 else None
    if ranks.data.rank != 0:
        return None
    from repro_torch.sharding.partition import gather_leaves
    return gather_leaves(flat, model.model_dims, ranks.model)


@torch.no_grad()
def rank_state(model: Model, cfg: ModelConfig, opt: dict, zero: Zero1,
               ranks):
    """The checkpoint tree on rank 0 (the JAX layout, on the CPU), None on
    the others: m and v gathered to rank 0 from every rank's slices, and
    the parameters' model slices.  Every tensor is a copy of its own."""
    from repro_torch.pytree import unflatten
    whole = zero.gather_state(param_tree(model, cfg), opt)
    flat = whole_params(model, cfg, ranks, zero)
    if ranks.rank != 0:
        return None
    params = unflatten(param_tree(model, cfg), flat)
    return {"params": tree_map(lambda t: t.to("cpu", copy=True),
                               stack_tree(params)),
            "opt": stack_tree(whole)}


@torch.no_grad()
def restore_params(ckpt_dir, step: int, model: Model, cfg: ModelConfig,
                   zero: Zero1):
    """Load checkpoint ``step``'s parameters into ``model``, cut by
    ``zero``'s plan (``Model.cut_to``): the file is read a leaf at a
    time, and each rank keeps its model slice of each leaf and, under
    FSDP, its data slice of that."""
    flat = leaves(param_tree(model, cfg))
    for k, full in enumerate(read_leaves(ckpt_dir, step,
                                         {"params": zero.whole_like})):
        first = zero.shards[k][0]
        for j, x in enumerate(zero.slices(k, full, data=zero.fsdp)):
            if x is not None:
                flat[first + j].copy_(x)


def restore_opt(ckpt_dir, step: int, zero: Zero1, device) -> dict:
    """This rank's slices of checkpoint ``step``'s m and v (``zero``'s
    plan, its model cut first): the file is read a leaf at a time, and
    each leaf is cut at once."""
    f32 = tree_map(lambda t: torch.empty(t.shape, dtype=torch.float32,
                                         device="meta"), zero.whole_like)
    opt = {"step": restore_checkpoint(ckpt_dir, step, {"opt": {
        "step": torch.empty((), dtype=torch.int32, device="meta")}},
        device=device)["opt"]["step"]}
    for key in ("m", "v"):
        opt[key] = [x for k, full in enumerate(read_leaves(
            ckpt_dir, step, {"opt": {key: f32}}))
            for x in zero.cut(k, full, device)]
    return opt
