"""Elastic restart + pipeline + compressed-DP self-test (port of
``repro/train/elastic_selftest.py``).

    PYTHONPATH=src python -m repro_torch.train.elastic_selftest [--device cpu]
    PYTHONPATH=src python -m repro_torch.train.elastic_selftest --ranks W [--device cpu] [--backend gloo]
    PYTHONPATH=src torchrun --nproc-per-node W -m repro_torch.train.elastic_selftest [--device cpu]

On the card unless ``--device`` names another device.  The JAX package
runs its checks on 8 forced host devices.  With ``--ranks W`` (or under
torchrun) the port runs them over W processes, one a rank
(``launch/ranks.py``: NCCL with rank r on ``cuda:r``, gloo on the CPU,
``--backend gloo`` for gloo ranks sharing the card), on (data x model)
meshes of the W ranks (``train/dp.Ranks``); rank 0 prints.  Without it
they run in one process, each mesh axis a leading tensor axis:

1. Elastic re-mesh.  Over ranks: train tiny mistral-nemo-12b 4 steps on
   the mesh (W / 2 data x 2 model) with a checkpoint at 4, then resume it
   on (W / 4 x 4) to step 8: JAX's own (4 x 2) -> (2 x 4) over 8 ranks,
   (2 x 2) -> (1 x 4) over 4, (1 x 2) -> (2 x 1) over 2.  In one process
   the run moves from the device to the CPU instead.  Asserts the
   resumed run starts at step 4 from parameters equal to the ones saved
   (the first run's model slices gathered whole), and that its last loss
   is below the first run's first.
2. Pipeline: the 4-stage GPipe schedule (over ranks: W stages, one a
   rank; ``train/pipeline.py``) equals serial application, and a toy
   pipeline trains (the loss falls under 0.95 x the first in 20 steps).
3. Compressed DP sync: the int8 error-feedback all-reduce over 8 ranks
   (over ranks: the W ranks, each its own leaf; in one process 8 stacked
   on one axis) matches the float32 mean within 5%, and over ranks equals
   the stacked version bit for bit.
4. ``moe_impl="smap"`` under ``sharding/context.use_mesh`` (JAX's
   ``_dispatch_smap``) equals the sort dispatch at a capacity factor of 8
   (no slot drops), within JAX's tolerances (2e-4; the aux loss 1e-4
   relative).  Over ranks on (2 data x W / 2 model) (JAX's (2 x 4) over 8
   ranks): each rank its data shard's tokens and expert shard, held also
   within SMAP_RTOL of the one-process stacked form (``smap_stacked``).
   In one process no mesh is set, so smap takes the sort dispatch, as
   JAX's does there, and equals it exactly.
5. Decode with ``decode_cache_hint`` equals plain decode within 2e-4.
   Over ranks, under ``use_mesh`` on (2 x W / 2): the model cut to each
   rank's shard, each GQA cache's slots cut over the model axis, 4
   steps against the whole model's plain decode.  In one process the
   hint does nothing (no mesh), and the logits are equal.

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
from repro_torch.train.trainer import restore_state, train

SHAPE = ShapeSpec("tiny", 32, 8, "train")
F32 = torch.float32
SMAP_RTOL = 1e-5


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


def elastic_meshes(W: int) -> tuple:
    """The two meshes of the re-mesh over W ranks: (W / 2 x 2) then
    (W / 4 x 4), or (2 x 1) below 4 ranks (one rank: (1 x 1) twice)."""
    if W == 1:
        return {"data": 1, "model": 1}, {"data": 1, "model": 1}
    b = 4 if W >= 4 else 1
    return ({"data": W // 2, "model": 2}, {"data": W // b, "model": b})


def _elastic_ranks(dp):
    """Train over ``dp``'s ranks on one mesh, resume on another."""
    import torch.distributed as dist

    from repro_torch.train.trainer import whole_params

    cfg = tiny_config("mistral-nemo-12b")
    kw = dict(ckpt_every=4, lr=3e-3, log_every=1)
    mesh_a, mesh_b = elastic_meshes(dp.world)
    d = [tempfile.mkdtemp(prefix="elastic-") if dp.rank == 0 else None]
    dist.broadcast_object_list(d, dist.get_global_rank(dp.group, 0),
                               group=dp.group)
    d = d[0]
    out_a = train(cfg, SHAPE, steps=4, ckpt_dir=d, dp=dp, mesh=mesh_a, **kw)
    saved = whole_params(out_a["model"], cfg, out_a["ranks"])
    out_b = train(cfg, SHAPE, steps=8, ckpt_dir=d, dp=dp, mesh=mesh_b, **kw)
    h = out_b["history"]
    _check(h[0]["step"] == 4, f"resumed at step {h[0]['step']}, not 4")
    _check(h[-1]["loss"] < out_a["history"][0]["loss"],
           f"last loss {h[-1]['loss']} is not below the first run's "
           f"first {out_a['history'][0]['loss']}")
    if dp.rank == 0:
        # the state the resumed run started from is run A's: the step-4
        # file's parameters equal run A's slices gathered whole
        model = tr.Model(cfg, device=dp.device)
        restore_state(d, 4, model, cfg, adamw_init(param_tree(model, cfg)))
        _check(all(torch.equal(a, b) for a, b in zip(
            saved, leaves(param_tree(model, cfg)))),
            "the restored parameters differ from the saved ones")
    dp.barrier()
    if dp.rank == 0:
        import shutil
        shutil.rmtree(d, ignore_errors=True)
        print(f"elastic ok ({_mesh(mesh_a)} -> {_mesh(mesh_b)})", flush=True)


def _mesh(mesh):
    return f"{mesh['data']} data x {mesh['model']} model"


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


def smap_mesh(W: int) -> dict:
    """The mesh of checks 4 and 5 over W ranks: (2 x W / 2), JAX's
    (2 x 4) at 8; (1 x W) below 4."""
    return ({"data": 2, "model": W // 2} if W >= 4 else
            {"data": 1, "model": W})


@torch.no_grad()
def check_moe_smap_parity(dev, dp=None):
    """moe_impl="smap" == the sort dispatch (same routing): exactly in one
    process, within JAX's tolerances over ranks under use_mesh."""
    from repro_torch.models.moe import route, smap_stacked
    from repro_torch.sharding.context import use_mesh
    from repro_torch.train.dp import Ranks

    cfg = tiny_config("kimi-k2-1t-a32b", n_experts=8, top_k=2,
                      capacity_factor=8.0)   # high cf: no drops
    gen = torch.Generator(device=dev).manual_seed(0)
    params = moe_init(cfg, gen, dev)
    x = torch.randn((4, 16, cfg.d_model), generator=gen, dtype=F32,
                    device=dev)
    y_ref, aux_ref = moe_apply(cfg, params, x)
    cfg2 = cfg.scaled(moe_impl="smap")
    if dp is None:
        y_smap, aux_smap = moe_apply(cfg2, params, x)
        _check(torch.equal(y_ref, y_smap) and torch.equal(aux_ref, aux_smap),
               "moe_impl='smap' differs from the sort dispatch")
        print("moe-smap ok", flush=True)
        return
    mesh = smap_mesh(dp.world)
    ranks = Ranks(dp, mesh)
    E_l = cfg.n_experts // mesh["model"]
    j = ranks.model.rank
    mine = {k: (v[j * E_l:(j + 1) * E_l] if k.startswith("e_") else v)
            for k, v in params.items()}
    rows = ranks.data.rows(x.shape[0])
    with use_mesh(ranks):
        y, aux = moe_apply(cfg2, mine, x[rows])
    y = ranks.data.all_gather(y.contiguous(), 0)
    aux = ranks.data.sum_(aux.clone())
    xf = x.reshape(-1, cfg.d_model)
    _, _, eidx, gate = route(cfg, params, xf)
    stacked, _ = smap_stacked(cfg, params, xf, eidx, gate, mesh["data"],
                              mesh["model"])
    if "shared" in params:
        from repro_torch.models.layers import mlp_apply
        stacked = stacked + mlp_apply(params["shared"], xf)
    torch.testing.assert_close(y, y_ref, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(float(aux), float(aux_ref), rtol=1e-4,
                               atol=0)
    torch.testing.assert_close(y.reshape(stacked.shape), stacked,
                               rtol=SMAP_RTOL, atol=SMAP_RTOL)
    if dp.rank == 0:
        print(f"moe-smap ok ({_mesh(mesh)})", flush=True)


@torch.no_grad()
def check_decode_hint_parity(dev, dp=None):
    """decode with the cache hint == plain decode: exactly in one process
    (no mesh), within 2e-4 over ranks under use_mesh."""
    cfg = tiny_config("mistral-nemo-12b")
    model = tr.Model(cfg, device=dev)
    B, S = 4, 32
    logits = {}
    for variant, c in (("ref", cfg), ("hint", cfg.scaled(
            decode_cache_hint=True))):
        if variant == "hint" and dp is not None:
            logits[variant] = _decode_ranks(c, model, B, S, dp)
            continue
        cache = tr.init_cache(c, B, S, device=dev)
        out = []
        for t in range(4):
            lg, cache = tr.decode_step(c, model, cache, _decode_in(B, t,
                                                                   dev))
            out.append(lg)
        logits[variant] = out
    if dp is None:
        _check(all(torch.equal(a, b) for a, b in zip(logits["ref"],
                                                      logits["hint"])),
               "decode with decode_cache_hint differs from plain decode")
        print("decode-hint ok", flush=True)
        return
    for a, b in zip(logits["ref"], logits["hint"]):
        torch.testing.assert_close(b, a, rtol=2e-4, atol=2e-4)
    if dp.rank == 0:
        print(f"decode-hint ok ({_mesh(smap_mesh(dp.world))})", flush=True)


def _decode_in(B, t, dev, rows=slice(None)):
    return {"tokens": torch.full((B, 1), 3 + t, dtype=torch.int32,
                                 device=dev)[rows],
            "pos": torch.full((B,), t, dtype=torch.int32, device=dev)[rows]}


def _decode_ranks(cfg, model, B, S, dp):
    """4 decode steps of ``model`` cut to each rank's shard under
    use_mesh, the caches cut by ``init_cache``; the logits gathered over
    data."""
    from repro_torch.sharding.context import use_mesh
    from repro_torch.train.dp import Ranks

    ranks = Ranks(dp, smap_mesh(dp.world))
    shard = tr.Model(cfg, device=dp.device)
    with torch.no_grad():
        for a, b in zip(shard.parameters(), model.parameters()):
            a.copy_(b)
    shard.cut_to(ranks)
    rows = ranks.data.rows(B)
    out = []
    with use_mesh(ranks):
        cache = tr.init_cache(cfg, B, S, device=dp.device, ranks=ranks)
        for t in range(4):
            lg, cache = tr.decode_step(cfg, shard, cache,
                                       _decode_in(B, t, dp.device, rows))
            out.append(ranks.data.all_gather(lg.contiguous(), 0))
    return out


def run_ranks(dp):
    """The five checks over ``dp``'s ranks; rank 0 prints."""
    check_elastic(dp.device, dp)
    check_pipeline(dp.device, dp)
    check_compressed_dp(dp.device, dp)
    check_moe_smap_parity(dp.device, dp)
    check_decode_hint_parity(dp.device, dp)
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
