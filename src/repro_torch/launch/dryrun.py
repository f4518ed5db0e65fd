"""The dry run restated for one H100 (port of ``repro/launch/dryrun.py``):
for every (architecture x input shape) cell, what the cell costs and
whether its state fits, counted on the meta device.  Nothing is
allocated on any device, so it runs the same on the CPU and on the card.

Per cell:
  * ``params_total`` / ``params_active`` and ``model_flops_global``
    (``roofline/analysis.py``);
  * the compositional global cost (``roofline/compositional.py``):
    ``flops`` (GEMM FLOPs) and ``bytes_unfused``, with ``per_layer``;
  * the state one device holds on the chosen mesh, by the partition
    planner (``sharding/partition.py``): the weights; for train also
    their gradients (the weights' dtype and layout) and AdamW's float32 m
    and v (ZeRO-1 layout); for decode the cache;
  * ``fits_one_card``: that state against the card's memory
    (``torch.cuda.get_device_properties(0).total_memory`` on the card,
    else the data sheet's 80e9 B);
  * the roofline terms on one H100 (``HW``) of flops and bytes divided by
    the mesh's device count.  That is an ideal split: the port has no
    SPMD partitioner to count replicated work, and no collective bytes.

The JAX package compiles each cell on 512 forced host devices and reads
XLA's ``memory_analysis`` and HLO; the port has no counterpart to that
compile, to its memory analysis or to the multi-pod compile proof.

Records go to results/dryrun_torch/<arch>__<shape>__<mesh>.json.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch musicgen-large --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh 1|16x16|2x16x16]
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import torch

from repro_torch.configs import SHAPES, all_archs, get_config, shape_applicable
from repro_torch.configs.base import input_specs
from repro_torch.convert import param_tree, stack_like, stage_layout
from repro_torch.launch.mesh import local_mesh, mesh_name, n_devices, parse_mesh
from repro_torch.models.transformer import init_cache
from repro_torch.pytree import tree_map
from repro_torch.roofline.analysis import (HW, active_params, model_flops,
                                           roofline_terms)
from repro_torch.roofline.compositional import compositional_cost, meta_model
from repro_torch.sharding.partition import (cache_pspecs, input_pspecs,
                                            opt_pspecs, param_pspecs,
                                            per_device_bytes)

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


def tune_for_shape(cfg, shape):
    """The JAX dry run's attention blocks: wide for 32k prefill."""
    if shape.kind == "prefill":
        cfg = cfg.scaled(attn_q_block=2048, attn_kv_block=2048)
    if shape.kind == "train":
        cfg = cfg.scaled(attn_q_block=1024, attn_kv_block=1024)
    return cfg


def card_bytes() -> tuple[float, str]:
    """The card's memory and where the figure comes from."""
    if torch.cuda.is_available():
        return (float(torch.cuda.get_device_properties(0).total_memory),
                "torch.cuda.get_device_properties(0).total_memory")
    return HW.hbm_bytes, "H100 SXM data sheet (no card here)"


def state_bytes(cfg, shape, params, mesh) -> dict:
    """The state one device holds of the cell on ``mesh``, by the
    planner, in bytes; ``params`` is the config's parameter tree in the
    JAX package's layout (meta tensors)."""
    out = {"weights": per_device_bytes(
        params, param_pspecs(cfg, params, mesh), mesh)}
    if shape.kind == "train":
        out["grads"] = out["weights"]
        f32 = tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32,
                                             device="meta"), params)
        out["adam_m"] = out["adam_v"] = per_device_bytes(
            f32, opt_pspecs(cfg, params, mesh), mesh)
    if shape.kind == "decode":
        cache = stack_like(stage_layout(init_cache(
            cfg, shape.global_batch, shape.seq_len, device="meta"), cfg))
        out["cache"] = per_device_bytes(
            cache, cache_pspecs(cfg, shape, cache, mesh), mesh)
    inputs = input_specs(cfg, shape)
    out["inputs"] = per_device_bytes(
        inputs, input_pspecs(cfg, shape, inputs, mesh), mesh)
    out["total"] = sum(out.values())
    return out


def dry_cell(arch: str, shape_name: str, mesh: dict, opts: str = "",
             card=None) -> dict:
    """The record of one cell; ``card`` is (the card's bytes, their
    source), ``card_bytes()`` by default."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": why}
    cfg = tune_for_shape(cfg, shape).with_opts(opts)
    t0 = time.perf_counter()
    params = stack_like(param_tree(meta_model(cfg), cfg))
    n_total, n_active = active_params(cfg, params)
    comp = compositional_cost(cfg, shape)
    state = state_bytes(cfg, shape, params, mesh)
    card, card_src = card_bytes() if card is None else card
    n_dev = n_devices(mesh)
    terms = roofline_terms(comp["flops"] / n_dev,
                           comp["bytes_unfused"] / n_dev, 0.0)
    mflops = model_flops(cfg, n_total, n_active, shape)
    return {
        "arch": arch, "shape": shape_name, "opts": opts,
        "mesh": mesh_name(mesh), "devices": n_dev, "status": "ok",
        "params_total": n_total, "params_active": n_active,
        "model_flops_global": mflops,
        "flops": comp["flops"], "bytes_unfused": comp["bytes_unfused"],
        "flops_source": comp["flops_source"],
        "compositional": comp,
        "useful_flops_ratio": mflops / comp["flops"] if comp["flops"] else 0.0,
        "state_bytes_per_device": state,
        "card_bytes": card, "card_bytes_source": card_src,
        "fits_one_card": state["total"] <= card,
        "roofline": terms,
        "roofline_split": "ideal: the cell's flops and bytes over the "
                          "mesh's devices",
        "t_s": time.perf_counter() - t0,
    }


def cell_record(arch, shape_name, mesh, opts, card) -> dict:
    """``dry_cell``, a failure recorded as the cell's error."""
    try:
        return dry_cell(arch, shape_name, mesh, opts, card)
    except Exception as e:  # noqa: BLE001 - the sweep records a failed cell
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name(mesh),
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:]}


def _report(rec, mesh, outdir: Path) -> dict:
    tag = f"{rec['arch']}__{rec['shape']}__{mesh_name(mesh)}"
    outdir.mkdir(parents=True, exist_ok=True)
    (outdir / f"{tag}.json").write_text(json.dumps(rec, indent=1))
    extra = ""
    if rec["status"] == "ok":
        r = rec["roofline"]
        extra = (f" compute={r['compute_s']:.4g}s mem={r['memory_s']:.4g}s"
                 f" dom={r['dominant']} state="
                 f"{rec['state_bytes_per_device']['total'] / 2**30:.2f}GiB"
                 f" fits={rec['fits_one_card']} t={rec['t_s']:.2f}s")
    elif rec["status"] == "error":
        extra = " " + rec["error"][:160]
    print(f"[dryrun] {tag}: {rec['status']}{extra}", flush=True)
    return rec


def run(cells, mesh=None, outdir: Path = RESULTS, opts="") -> list:
    """Dry-run ``cells`` [(arch, shape)] on ``mesh`` (one card by
    default), one worker process a CPU core (spawned: a cell is
    seconds of Python over the meta device's kernels, and the cells are
    independent); writes and prints each record, returns them in order."""
    mesh = local_mesh() if mesh is None else mesh
    card = card_bytes()
    args = [(a, s, mesh, opts, card) for a, s in cells]
    jobs = min(len(args), os.cpu_count() or 1)
    if jobs == 1:
        return [_report(cell_record(*a), mesh, outdir) for a in args]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(jobs, mp_context=ctx) as pool:
        return [_report(rec, mesh, outdir)
                for rec in pool.map(cell_record, *zip(*args))]


def all_cells() -> list:
    return [(a, s) for a in all_archs() for s in SHAPES]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default="1",
                    help="1 (one card), 16x16 or 2x16x16")
    ap.add_argument("--out", default=str(RESULTS))
    ap.add_argument("--set", default="", dest="opts",
                    help="cfg overrides k=v,k=v")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    cells = all_cells() if args.all else [(args.arch, args.shape)]
    recs = run(cells, parse_mesh(args.mesh), Path(args.out), args.opts)
    n = {k: sum(r["status"] == k for r in recs)
         for k in ("ok", "skipped", "error")}
    print(f"[dryrun] done: {n['ok']} ok, {n['skipped']} skipped, "
          f"{n['error']} failed", flush=True)
    return 0 if n["error"] == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
