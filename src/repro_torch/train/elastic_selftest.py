"""Elastic restart + pipeline + compressed-DP self-test (port of
``repro/train/elastic_selftest.py``).

    PYTHONPATH=src python -m repro_torch.train.elastic_selftest [--device cpu]
    PYTHONPATH=src python -m repro_torch.train.elastic_selftest --ranks W [--device cpu] [--backend gloo]
    PYTHONPATH=src torchrun --nproc-per-node W -m repro_torch.train.elastic_selftest [--device cpu]

On the card unless ``--device`` names another device.  The JAX package
runs its checks on 8 forced host devices.  With ``--ranks W`` (or under
torchrun) the port runs them over W processes, one a rank
(``launch/ranks.py``: NCCL with rank r on ``cuda:r``, gloo on the CPU,
``--backend gloo`` for gloo ranks sharing the card), the ranks the data
axis of a mesh {"data": W, "model": 1}; rank 0 prints.  Without it they
run in one process, each mesh axis a leading tensor axis:

1. Elastic re-mesh.  Over ranks: train tiny mistral-nemo-12b 4 steps over
   the W ranks with a checkpoint at 4, then resume it over the first
   max(W // 2, 1) ranks to step 8 (JAX's (4 data x 2 model) -> (2 x 4)
   restated on the data axis; the model axis over ranks is slice 9 of
   the port).  In one process the run moves from the device to the CPU
   instead.  Asserts the resumed run starts at step 4 from parameters
   equal to the ones saved, and that its last loss is below the first
   run's first.
2. Pipeline: the 4-stage GPipe schedule (over ranks: W stages, one a
   rank; ``train/pipeline.py``) equals serial application, and a toy
   pipeline trains (the loss falls under 0.95 x the first in 20 steps).
3. Compressed DP sync: the int8 error-feedback all-reduce over 8 ranks
   (over ranks: the W ranks, each its own leaf; in one process 8 stacked
   on one axis) matches the float32 mean within 5%, and over ranks equals
   the stacked version bit for bit.
4. ``moe_impl="smap"`` equals the sort dispatch exactly: the port has no
   mesh, so every ``moe_impl`` takes the sort dispatch (one process).
5. Decode with ``decode_cache_hint`` equals plain decode exactly: the
   hint only constrains JAX's cache sharding, and the port ignores it.

Ends with ELASTIC-SELFTEST-OK.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.tiny import tiny_config
from repro_torch.convert import param_tree, stack_tree
from repro_torch.core.client import _resolve_device
from repro_torch.launch import ranks
from repro_torch.models import transformer as tr
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.optim.adamw import adamw_init
from repro_torch.optim.compression import dp_allreduce_compressed
from repro_torch.pytree import leaves
from repro_torch.train.pipeline import make_pipeline_train_step, pipeline_apply
from repro_torch.train.dp import DP
from repro_torch.train.trainer import (param_checksum, restore_state,
                                       train)

SHAPE = ShapeSpec("tiny", 32, 8, "train")
F32 = torch.float32


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def check_elastic(dev, dp=None):
    if dp is not None:
        return _elastic_ranks(dp)
    other = torch.device("cpu")
    cfg = tiny_config("mistral-nemo-12b")
    kw = dict(ckpt_every=4, lr=3e-3, log_every=1)
    with tempfile.TemporaryDirectory() as d:
        out_a = train(cfg, SHAPE, steps=4, ckpt_dir=d, device=dev, **kw)
        # the checkpoint restored on the other device holds run A's
        # parameters exactly: the state the resumed run starts from
        model = tr.Model(cfg, device=other)
        restore_state(d, 4, model, cfg, adamw_init(param_tree(model, cfg)))
        saved = leaves(stack_tree(param_tree(out_a["model"], cfg)))
        got = leaves(stack_tree(param_tree(model, cfg)))
        _check(all(torch.equal(a.cpu(), b) for a, b in zip(saved, got)),
               "the restored parameters differ from the saved ones")
        out_b = train(cfg, SHAPE, steps=8, ckpt_dir=d, device=other, **kw)
    h = out_b["history"]
    _check(h[0]["step"] == 4, f"resumed at step {h[0]['step']}, not 4")
    _check(h[-1]["loss"] < out_a["history"][0]["loss"],
           f"last loss {h[-1]['loss']} is not below the first run's first "
           f"{out_a['history'][0]['loss']}")
    print("elastic ok", flush=True)


def _elastic_ranks(dp):
    """Train over every rank of ``dp``, then resume over its first half."""
    import torch.distributed as dist

    cfg = tiny_config("mistral-nemo-12b")
    kw = dict(ckpt_every=4, lr=3e-3, log_every=1)
    half = max(dp.world // 2, 1)
    ranks_b = [dist.get_global_rank(dp.group, r) for r in range(half)]
    sub = dist.new_group(ranks_b)      # every rank makes it, in one order
    d = [tempfile.mkdtemp(prefix="elastic-") if dp.rank == 0 else None]
    dist.broadcast_object_list(d, dist.get_global_rank(dp.group, 0),
                               group=dp.group)
    d = d[0]
    out_a = train(cfg, SHAPE, steps=4, ckpt_dir=d, dp=dp, **kw)
    saved = param_checksum(out_a["model"], cfg)
    if dp.rank < half:
        out_b = train(cfg, SHAPE, steps=8, ckpt_dir=d,
                      dp=DP(sub, dp.device), **kw)
        h = out_b["history"]
        _check(h[0]["step"] == 4, f"resumed at step {h[0]['step']}, not 4")
        _check(h[-1]["loss"] < out_a["history"][0]["loss"],
               f"last loss {h[-1]['loss']} is not below the first run's "
               f"first {out_a['history'][0]['loss']}")
        # the state the resumed run started from is run A's: its
        # parameters restored from the step-4 file
        model = tr.Model(cfg, device=dp.device)
        restore_state(d, 4, model, cfg, adamw_init(param_tree(model, cfg)))
        _check(torch.equal(param_checksum(model, cfg), saved),
               "the restored parameters differ from the saved ones")
    dp.barrier()
    if dp.rank == 0:
        import shutil
        shutil.rmtree(d, ignore_errors=True)
        print(f"elastic ok ({dp.world} ranks -> {half})", flush=True)


def check_pipeline(dev, dp=None):
    S = 4 if dp is None else dp.world
    M, mb, d = 8, 4, 16
    rng = np.random.RandomState(0)
    w = torch.tensor(rng.randn(S, d, d) * (d ** -0.5), dtype=F32,
                     device=dev)

    def stage_fn(p, x):
        return torch.tanh(x @ p)

    mine = w if dp is None else w[dp.rank]
    x = torch.tensor(rng.randn(M, mb, d), dtype=F32, device=dev)
    y_pipe = pipeline_apply(stage_fn, mine, x, dp)
    # serial reference
    y_ref = x
    for s in range(S):
        y_ref = torch.tanh(y_ref @ w[s])
    torch.testing.assert_close(y_pipe, y_ref, rtol=2e-5, atol=2e-5)
    # train the pipeline
    tgt = torch.tensor(rng.randn(M, mb, d), dtype=F32, device=dev)

    def loss_fn(out, t):
        return torch.mean((out - t) ** 2)

    step = make_pipeline_train_step(stage_fn, loss_fn, lr=0.1, dp=dp)
    w2, l0 = step(mine, x, tgt)
    for _ in range(20):
        w2, loss = step(w2, x, tgt)
    _check(float(loss) < float(l0) * 0.95, (float(l0), float(loss)))
    if dp is None or dp.rank == 0:
        print("pipeline ok" + ("" if dp is None else
                               f" ({S} stages, one a rank)"), flush=True)


def check_compressed_dp(dev, dp=None):
    n = 8 if dp is None else dp.world
    rng = np.random.RandomState(1)
    g_shards = torch.tensor(rng.randn(max(n, 8), 32, 16)[:n] * 0.01,
                            dtype=F32, device=dev)
    err = torch.zeros((n, 32, 16), dtype=F32, device=dev)
    stacked, _ = dp_allreduce_compressed({"g": g_shards}, {"g": err})
    out = stacked
    if dp is not None:
        out, _ = dp_allreduce_compressed({"g": g_shards[dp.rank]},
                                         {"g": err[dp.rank]}, dp)
        _check(torch.equal(out["g"], stacked["g"][dp.rank]),
               "the compressed all-reduce over ranks differs from the "
               "stacked one")
        out = {"g": out["g"][None]}
    ref = g_shards.mean(0)
    got = out["g"][0]
    rel = float((got - ref).abs().max() / ref.abs().max())
    _check(rel < 0.05, rel)
    if dp is None or dp.rank == 0:
        print(f"compressed-dp ok ({n} ranks)", flush=True)


@torch.no_grad()
def check_moe_smap_parity(dev):
    """moe_impl="smap" == the sort dispatch (same routing), exactly."""
    cfg = tiny_config("kimi-k2-1t-a32b", n_experts=8, top_k=2,
                      capacity_factor=8.0)   # high cf: no drops
    gen = torch.Generator(device=dev).manual_seed(0)
    params = moe_init(cfg, gen, dev)
    x = torch.randn((4, 16, cfg.d_model), generator=gen, dtype=F32,
                    device=dev)
    y_ref, aux_ref = moe_apply(cfg, params, x)
    y_smap, aux_smap = moe_apply(cfg.scaled(moe_impl="smap"), params, x)
    _check(torch.equal(y_ref, y_smap) and torch.equal(aux_ref, aux_smap),
           "moe_impl='smap' differs from the sort dispatch")
    print("moe-smap ok", flush=True)


def check_decode_hint_parity(dev):
    """decode with the cache hint == plain decode, exactly."""
    cfg = tiny_config("mistral-nemo-12b")
    model = tr.Model(cfg, device=dev)
    B, S = 4, 32
    logits = {}
    for variant, c in (("ref", cfg), ("hint", cfg.scaled(
            decode_cache_hint=True))):
        cache = tr.init_cache(c, B, S, device=dev)
        out = []
        for t in range(4):
            inputs = {"tokens": torch.full((B, 1), 3 + t, dtype=torch.int32,
                                           device=dev),
                      "pos": torch.full((B,), t, dtype=torch.int32,
                                        device=dev)}
            lg, cache = tr.decode_step(c, model, cache, inputs)
            out.append(lg)
        logits[variant] = out
    _check(all(torch.equal(a, b) for a, b in zip(logits["ref"],
                                                  logits["hint"])),
           "decode with decode_cache_hint differs from plain decode")
    print("decode-hint ok", flush=True)


def run_ranks(dp):
    """The five checks over ``dp``'s ranks (the one-process ones on rank
    0); rank 0 prints."""
    check_elastic(dp.device, dp)
    check_pipeline(dp.device, dp)
    check_compressed_dp(dp.device, dp)
    if dp.rank == 0:
        check_moe_smap_parity(dp.device)
        check_decode_hint_parity(dp.device)
    dp.barrier()


def _rank_main(rank, world, device):
    import torch.distributed as dist
    run_ranks(DP(dist.group.WORLD, device))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="the card unless this names another device")
    ap.add_argument("--ranks", type=int, default=0,
                    help="processes, one a rank (default: one process, no "
                         "process group)")
    ap.add_argument("--backend", default=None,
                    help="nccl (the card's default) or gloo")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds before a rank's collective or the whole "
                         "spawned run gives up")
    args = ap.parse_args(argv)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        import torch.distributed as dist
        rank, world, dev = ranks.init_from_env(
            _resolve_device(args.device, "elastic_selftest").type,
            backend=args.backend, timeout_s=args.timeout)
        _rank_main(rank, world, dev)
        dist.destroy_process_group()
        if rank != 0:
            return 0
    elif args.ranks:
        dev = _resolve_device(args.device, "elastic_selftest")
        ranks.spawn(_rank_main, args.ranks, device=dev.type,
                    backend=args.backend, timeout_s=args.timeout)
    else:
        dev = _resolve_device(args.device, "elastic_selftest")
        check_elastic(dev)
        check_pipeline(dev)
        check_compressed_dp(dev)
        check_moe_smap_parity(dev)
        check_decode_hint_parity(dev)
    print("ELASTIC-SELFTEST-OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
