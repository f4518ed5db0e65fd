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
package starts the other resumes.  The mesh, the sharded step and the
partition specs have no meaning on one card and are left out.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from repro_torch.checkpoint.checkpoint import (AsyncCheckpointer, latest_step,
                                               restore_checkpoint)
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.convert import (load_stacked, param_tree, stack_like,
                                 stack_tree)
from repro_torch.core.client import _resolve_device
from repro_torch.data.pipeline import SyntheticLM, make_batch
from repro_torch.models.transformer import Model
from repro_torch.optim.adamw import adamw_init
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
          device=None) -> dict:
    """Run (or resume) training on ``device`` (the card unless the caller
    names another).  With no checkpoint to resume from, the weights are
    drawn from a generator seeded with ``seed``.  ``fail_at`` raises
    midway to exercise the crash/restart path in tests.  Returns
    {"history", "model", "opt"}."""
    check_trainable(cfg)
    dev = _resolve_device(device, "train")
    ds = SyntheticLM(cfg.vocab_size, shape.seq_len, shape.global_batch,
                     seed=seed,
                     embed_dim=cfg.d_model if cfg.frontend == "embed" else 0)
    model = Model(cfg, device=dev,
                  generator=torch.Generator(device=dev).manual_seed(seed))
    opt = adamw_init(param_tree(model, cfg))
    start = 0
    ckpt = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    if ckpt_dir and (s := latest_step(ckpt_dir)) is not None:
        opt = restore_state(ckpt_dir, s, model, cfg, opt)
        start = s

    history = []
    t0 = time.time()
    for step in range(start, steps):
        if fail_at is not None and step == fail_at:
            if ckpt:
                ckpt.wait()
            raise RuntimeError(f"injected failure at step {step}")
        batch = make_batch(ds, step, device=dev, dtype=cfg.param_dtype)
        model, opt, metrics = train_step(cfg, model, opt, batch, lr=lr)
        if step % log_every == 0 or step == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["wall_s"] = round(time.time() - t0, 2)
            history.append(m)
            print(f"[train] step={step} loss={m['loss']:.4f} "
                  f"gnorm={m['grad_norm']:.3f}", flush=True)
        if ckpt and (step + 1) % ckpt_every == 0:
            ckpt.save(step + 1, state_tree(model, cfg, opt))
    if ckpt:
        ckpt.save(steps, state_tree(model, cfg, opt))
        ckpt.wait()
    return {"history": history, "model": model, "opt": opt}
