"""End-to-end training on the PyTorch port: a ~15M-parameter decoder
trained on the synthetic LM stream, with checkpoints and restart.

    python examples/train_lm_torch.py --steps 100 [--device cpu]
    python examples/train_lm_torch.py --steps 200   # resumes!
    python examples/train_lm_torch.py --steps 100 --ranks 2 [--device cpu]
    python examples/train_lm_torch.py --steps 100 --ranks 4 --model 2 [--device cpu]
    torchrun --nproc-per-node 2 examples/train_lm_torch.py --steps 100

The port's counterpart of ``examples/train_lm.py``: the same flags and
printed lines, plus ``--device``, the card unless it names another.
The JAX example trains over every device of the host; ``--ranks W``
trains over W processes, one a rank (NCCL with rank r on ``cuda:r``,
gloo on the CPU; under torchrun each process joins torchrun's group),
rank 0 printing: the ranks a mesh of W / M data x M model (``--model
M``, 1 by default), the batch split over data with ZeRO-1 and the
weights cut over model (tensor parallelism).  A checkpoint is one file
whatever the mesh is, so a run resumes on another mesh.
Pass --d-model 704 --n-layers 12 for the ~100M run.  Loss on the
synthetic copy-structure stream drops from ~ln(V) toward the copy floor.
The checkpoint directory (by default under the temporary directory) is
in the JAX package's format: either package resumes the other's run.
"""
import argparse
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.base import ModelConfig, ShapeSpec  # noqa: E402
from repro_torch.core.client import _resolve_device  # noqa: E402
from repro_torch.launch import ranks  # noqa: E402
from repro_torch.models.transformer import Model, count_params  # noqa: E402
from repro_torch.train.trainer import train  # noqa: E402


def demo_config(d_model: int = 384, n_layers: int = 6) -> ModelConfig:
    return ModelConfig(
        name="train-lm-demo", family="dense",
        n_layers=n_layers, d_model=d_model,
        n_heads=max(4, d_model // 64), n_kv_heads=max(2, d_model // 128),
        head_dim=64, d_ff=d_model * 4, vocab_size=2048,
        attn_q_block=64, attn_kv_block=64, dtype="float32",
    )


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--d-model", type=int, default=384)
    ap.add_argument("--n-layers", type=int, default=6)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_train_lm_torch"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--ranks", type=int, default=0,
                    help="processes, one a rank (default: one process)")
    ap.add_argument("--model", type=int, default=1,
                    help="the mesh's model axis over the ranks (tensor "
                         "parallelism); the rest is the data axis")
    return ap.parse_args(argv)


def run(args, dev, dp=None, say=print):
    cfg = demo_config(args.d_model, args.n_layers)
    n = count_params(Model(cfg, device="cpu"))
    where = f"device={dev}" + ("" if dp is None else f", ranks={dp.world}")
    mesh = None
    if dp is not None and args.model > 1:
        mesh = {"data": dp.world // args.model, "model": args.model}
        where += f", model={args.model}"
    say(f"model: {n/1e6:.1f}M params, {where}")
    shape = ShapeSpec("demo", args.seq_len, args.batch, "train")
    out = train(cfg, shape, steps=args.steps, ckpt_dir=args.ckpt_dir,
                ckpt_every=25, lr=args.lr, log_every=5, device=dev, dp=dp,
                mesh=mesh)
    h = out["history"]
    say(f"loss: {h[0]['loss']:.3f} -> {h[-1]['loss']:.3f} "
        f"over steps {h[0]['step']}..{h[-1]['step']}")
    return out


def _rank_main(rank, world, device, args):
    import torch.distributed as dist

    from repro_torch.train.dp import DP
    out = run(args, device, DP(dist.group.WORLD, device),
              say=(lambda m: print(m, flush=True)) if rank == 0 else
              (lambda m: None))
    return [(h["step"], h["loss"]) for h in out["history"]]


def main(argv=None):
    args = parse(argv)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        import torch.distributed as dist
        kind = _resolve_device(args.device, "train_lm_torch").type
        rank, world, dev = ranks.init_from_env(kind)
        out = _rank_main(rank, world, dev, args)
        dist.destroy_process_group()
        return out
    dev = _resolve_device(args.device, "train_lm_torch")
    if args.ranks:
        return ranks.spawn(_rank_main, args.ranks, device=dev.type,
                           timeout_s=3600, args=(args,))[0]
    return run(args, dev)


if __name__ == "__main__":
    main()
