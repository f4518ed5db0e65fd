"""The rank processes' side of tests/test_torch_data_axis.py: the rest of
the mesh's data axis (FSDP, and the sequence cut at a global batch of 1)
over ``torch.distributed`` gloo ranks on the CPU.

``repro_torch.launch.ranks.spawn`` pickles these functions by name, so
they live in a module that a fresh process imports without JAX: each
takes (rank, world, device, ...), checks what it can with asserts (a
failed one fails the spawn) and returns plain data.  Every training run
starts from a step-0 checkpoint the test wrote from the port's seeded
weights (``_train_ranks.init_checkpoint``), in its own copy of the
directory, so that JAX's ``train`` resumes the same state.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

import _train_ranks as T

SEQ, BATCH, STEPS = 32, 4, 2
M21, M22 = {"data": 2, "model": 1}, {"data": 2, "model": 2}
KIMI, NEMO, ZAMBA = "kimi-k2-1t-a32b", "mistral-nemo-12b", "zamba2-7b"
FSDP = {"fsdp": True}

# name -> (arch, config keywords, mesh, global batch, sequence length);
# kimi-k2 sets fsdp in its own config
CASES = {
    "fsdp/kimi/2x1": (KIMI, {}, M21, BATCH, SEQ),
    "fsdp/kimi/2x2": (KIMI, {}, M22, BATCH, SEQ),
    "fsdp/nemo/2x2": (NEMO, FSDP, M22, BATCH, SEQ),
    "fsdp/nemo/2x1": (NEMO, FSDP, M21, BATCH, SEQ),
    "fsdp/zamba/2x2": (ZAMBA, FSDP, M22, BATCH, SEQ),
    "fsdp/zamba/2x1": (ZAMBA, FSDP, M21, BATCH, SEQ),
    "seq/nemo/2x1": (NEMO, {}, M21, 1, SEQ),
    "seq/gemma/2x1": ("gemma3-27b", {}, M21, 1, SEQ),
    "seq/falcon/2x1": ("falcon-mamba-7b", {}, M21, 1, SEQ),
    # 12 positions a rank: no whole chunk of 8
    "seq/falcon24/2x1": ("falcon-mamba-7b", {}, M21, 1, 24),
    "seq/zamba/2x1": (ZAMBA, {}, M21, 1, SEQ),
    "seq/deepseek/2x1": ("deepseek-v2-lite-16b",
                         {"capacity_factor": T.DROP_CF}, M21, 1, SEQ),
    "seq/kimi/2x1": (KIMI, {}, M21, 1, SEQ),
    "seq/nemo/2x2": (NEMO, {}, M22, 1, SEQ),
}
ARCHS = sorted({c[0] for c in CASES.values()})
# the cases over 4 ranks, and those each pair of ranks runs
QUADS = [k for k, c in CASES.items() if c[2] == M22]
PAIRS = ([k for k in CASES if k.startswith("fsdp/") and k.endswith("2x1")]
         + ["seq/nemo/2x1", "seq/gemma/2x1"],
         ["seq/falcon/2x1", "seq/falcon24/2x1", "seq/zamba/2x1",
          "seq/deepseek/2x1", "seq/kimi/2x1"])
RESUME_AT, RESUME_TO = 2, 4
# the FSDP cases decoded and prefilled on their (2 x 2) shards
DECODES = [k for k in QUADS if k.startswith("fsdp/")]
DECODE_B, DECODE_S, DECODE_STEPS = 4, 16, 3
FN_WIDTHS = (2, 4)
FUNCTIONS = ("gather", "owned", "halo", "carry")


def cfg_of(name):
    arch, kw = CASES[name][:2]
    return T.cfg_of(arch, **kw)


class Spy:
    """While installed: the MoE's kept slots a dispatch plan, and the
    rows and positions of each batch the trainer makes."""

    def __init__(self):
        from repro_torch.models import moe
        from repro_torch.train import trainer
        self.moe, self.trainer = moe, trainer
        self.plan, self.batch = moe.dispatch_plan, trainer.make_batch
        self.kept, self.shapes = [], []

    def __enter__(self):
        def plan(cfg, eidx, C, base=None):
            res = self.plan(cfg, eidx, C, base)
            self.kept.append(int(res[3].sum()))
            return res

        def batch(*a, **k):
            out = self.batch(*a, **k)
            self.shapes.append(tuple(out["targets"].shape))
            return out

        self.moe.dispatch_plan, self.trainer.make_batch = plan, batch
        return self

    def __exit__(self, *exc):
        self.moe.dispatch_plan, self.trainer.make_batch = (self.plan,
                                                           self.batch)


def run(name, d, dp, mesh=None, *, steps=STEPS, ckpt_every=100):
    """``train`` of case ``name`` from the checkpoint in ``d`` to
    ``steps`` over ``dp`` on ``mesh`` (the case's by default; one process
    with no ``dp``): the history, rank 0's whole final parameters (JAX's
    leaf order), each rank's parameter and m bytes, the data group's
    collectives, the kept slots a plan and the batches' shapes."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.convert import param_tree, stack_tree
    from repro_torch.pytree import leaves, unflatten
    from repro_torch.train.trainer import train, whole_params

    _, _, m, batch, seq = CASES[name]
    cfg = cfg_of(name)
    with Spy() as spy:
        out = train(cfg, ShapeSpec("tiny", seq, batch, "train"),
                    steps=steps, ckpt_dir=d, ckpt_every=ckpt_every, lr=T.LR,
                    log_every=1, device="cpu", dp=dp,
                    mesh=(m if mesh is None else mesh) if dp else None)
    rec = {k: [h[k] for h in out["history"]]
           for k in ("step", "loss", "ce", "aux", "grad_norm")}
    rec.update(kept=spy.kept, shapes=spy.shapes)
    model = out["model"]
    tree = param_tree(model, cfg)
    rec["param_bytes"] = sum(p.numel() * p.element_size()
                             for p in leaves(tree))
    if out["zero"] is None:
        flat = leaves(tree)
    else:
        r = out["ranks"]
        flat = whole_params(model, cfg, r, out["zero"])
        rec["m_bytes"] = out["zero"].nbytes(out["opt"]["m"])
        rec["data_calls"] = dict(r.data.stats["calls"])
    if flat is not None:
        rec["params"] = [t.detach().numpy().copy() for t in leaves(
            stack_tree(unflatten(tree, flat)))]
    return rec


def train_cases(rank, world, device, root):
    """Over 4 ranks: the (2 x 2) cases over all 4; the (2 x 1) cases,
    half over ranks 0-1 and half over ranks 2-3; the FSDP checkpoint
    written on (2 x 2) at RESUME_AT and resumed on (4 x 1) and in one
    process (rank 1), beside the straight run; the deepseek sequence
    case in one process (rank 3); the Functions at W = 2 and 4; a prefill
    and decode on the (2 x 2) FSDP cases' shards.  Returns
    {case: record} of this rank."""
    import torch.distributed as dist

    from repro_torch.train.dp import DP

    root = Path(root)
    pair = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    dp4 = DP(dist.group.WORLD, device)
    dp2 = DP(pair[rank // 2], device)
    out = {}
    for name in QUADS:
        out[name] = run(name, root / name, dp4)
    for name in PAIRS[rank // 2]:
        out[name] = run(name, root / name, dp2)
    if rank == 3:
        out["one/deepseek"] = run("seq/deepseek/2x1", root / "one_deepseek",
                                  None)
    ck = root / "resume"
    out["resume/a"] = run("fsdp/nemo/2x2", ck / "a", dp4, steps=RESUME_AT,
                          ckpt_every=RESUME_AT)
    if rank == 0:
        T.copy_dir(ck / "a", ck / "b")
        T.copy_dir(ck / "a", ck / "one")
    dp4.barrier()
    out["resume/b"] = run("fsdp/nemo/2x2", ck / "b", dp4,
                          {"data": 4, "model": 1}, steps=RESUME_TO)
    out["resume/straight"] = run("fsdp/nemo/2x2", ck / "straight", dp4,
                                 steps=RESUME_TO)
    if rank == 1:
        out["resume/one"] = run("fsdp/nemo/2x2", ck / "one", None,
                                steps=RESUME_TO)
    for W, dp in ((2, dp2), (4, dp4)):
        for fn in FUNCTIONS:
            out[("fn", fn, W)] = function_case(fn, dp)
    for name in DECODES:
        out[("decode", name)] = decode_shards(dp4, root / CASES[name][0]
                                              / "init", name)
    return out


def decode_shards(dp, init, name):
    """Case ``name``'s model (the step-0 checkpoint's weights) cut to
    each rank's FSDP and model slices on its mesh: a prefill of
    DECODE_S tokens and DECODE_STEPS decode steps of the rank's rows
    under ``use_dp`` of the data group (the batch is split over it, so
    the MoE's plan is over the global tokens, as JAX's), against the
    whole model's on this rank.  Returns the worst gap of
    the logits, and each rank's parameter bytes before and after (the
    slices the layers gathered are given back)."""
    from repro_torch.convert import param_tree
    from repro_torch.models import transformer as tr
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.pytree import leaves
    from repro_torch.serving.serve_step import prefill
    from repro_torch.sharding.context import use_dp
    from repro_torch.train.dp import Ranks
    from repro_torch.train.trainer import restore_state

    cfg = cfg_of(name)
    model = tr.Model(cfg, device="cpu")
    restore_state(init, 0, model, cfg, adamw_init(param_tree(model, cfg)))
    gen = torch.Generator().manual_seed(7)
    prompt = torch.randint(0, cfg.vocab_size, (DECODE_B, DECODE_S),
                           generator=gen, dtype=torch.int32)

    def steps(model, cache, rows):
        got = [prefill(cfg, model, {"tokens": prompt[rows]})]
        for t in range(DECODE_STEPS):
            inputs = {"tokens": prompt[rows, t:t + 1],
                      "pos": torch.full((DECODE_B,), t,
                                        dtype=torch.int32)[rows]}
            lg, cache = tr.decode_step(cfg, model, cache, inputs)
            got.append(lg)
        return got

    want = steps(model, tr.init_cache(cfg, DECODE_B, DECODE_S,
                                      device="cpu"), slice(None))
    ranks = Ranks(dp, CASES[name][2])
    model.cut_to(ranks)

    def nbytes():
        return sum(p.numel() * p.element_size()
                   for p in leaves(param_tree(model, cfg)))

    before = nbytes()
    with use_dp(ranks.data):        # the rows split: the MoE plan global
        got = steps(model, tr.init_cache(cfg, DECODE_B, DECODE_S,
                                         device="cpu", ranks=ranks),
                    ranks.data.rows(DECODE_B))
    gap = max(float((ranks.data.all_gather(g.contiguous(), 0) - w)
                    .abs().max()) for g, w in zip(got, want))
    return {"gap": gap, "bytes": (before, nbytes())}


# ---------------------------------------------------------------------------
# The Functions, forward and gradient, against one process
# ---------------------------------------------------------------------------
def _global(fn, W, gen):
    """(the global inputs of ``fn`` over W ranks, the one-process
    function of them giving every rank's output)."""
    from repro_torch.sharding.fsdp import _prefix

    if fn == "gather":                       # W slices of [2, 3] rows
        x = torch.randn((2 * W, 3), generator=gen, dtype=torch.float64)
        return [x], lambda x: [x] * W
    if fn == "owned":                        # rank 1's layer
        x = torch.randn((3, 4), generator=gen, dtype=torch.float64)
        return [x], lambda x: [x] * W
    if fn == "halo":                         # [1, 3 W, 2], halo of 2
        x = torch.randn((1, 3 * W, 2), generator=gen, dtype=torch.float64)
        pad = torch.cat([torch.zeros((1, 2, 2), dtype=x.dtype), x], 1)
        return [x], lambda x: [torch.cat([torch.zeros((1, 2, 2),
                                                      dtype=x.dtype), x],
                                         1)[:, 3 * r:3 * r + 2]
                               for r in range(W)]
    a = torch.rand((W, 2, 3), generator=gen, dtype=torch.float64)
    e = torch.randn((W, 2, 3), generator=gen, dtype=torch.float64)
    return [a, e], lambda a, e: [_prefix(a, e, r) for r in range(W)]


def _local(fn, dp, xs):
    """This rank's part of the global inputs and its output of ``fn``."""
    from repro_torch.sharding import fsdp
    from repro_torch.sharding.context import use_dp

    W, r = dp.world, dp.rank
    with use_dp(dp, None, fsdp=dp, seq=True):
        if fn == "gather":
            mine = xs[0][2 * r:2 * r + 2].clone().requires_grad_()
            p = torch.nn.Parameter(mine.detach().clone())
            p.fsdp = ((2 * W, 3), (0, 2 * r, 2), None)
            out = fsdp.whole(p)
            return [p], out
        if fn == "owned":
            owner = 1
            p = torch.nn.Parameter(xs[0].clone() if r == owner else
                                   torch.empty((0,), dtype=xs[0].dtype))
            p.fsdp = ((3, 4), () if r == owner else None, owner)
            return [p], fsdp.whole(p)
        if fn == "halo":
            p = torch.nn.Parameter(xs[0][:, 3 * r:3 * r + 3].clone())
            return [p], fsdp.halo(p, 2)
        a = torch.nn.Parameter(xs[0][r].clone())
        e = torch.nn.Parameter(xs[1][r].clone())
        return [a, e], fsdp.carry_in(a, e)


def function_case(fn, dp):
    """``fn`` over ``dp``'s W ranks on one seeded global input: every
    rank's output against the one-process function's, and the gradients
    of sum over ranks <out_r, c_r> (each rank its own c_r) against
    autograd's of the one-process function.  Returns the worst gaps."""
    W, r = dp.world, dp.rank
    gen = torch.Generator().manual_seed(31 + W)
    xs, one = _global(fn, W, gen)
    xs_g = [x.clone().requires_grad_() for x in xs]
    want = one(*xs_g)
    cs = [torch.randn(w.shape, generator=gen, dtype=torch.float64)
          for w in want]
    total = sum((w * c).sum() for w, c in zip(want, cs))
    grads = torch.autograd.grad(total, xs_g, allow_unused=True,
                                materialize_grads=True)
    mine, out = _local(fn, dp, xs)
    fwd = float((out - want[r]).abs().max())
    got = torch.autograd.grad((out * cs[r]).sum(), mine)
    if fn == "gather":
        ref = [grads[0][2 * r:2 * r + 2]]
    elif fn == "owned":
        ref = [grads[0] if r == 1 else torch.zeros((0,), dtype=torch.float64)]
    elif fn == "halo":
        ref = [grads[0][:, 3 * r:3 * r + 3]]
    else:
        ref = [grads[0][r], grads[1][r]]
    bwd = max(float((g - w).abs().max()) if g.numel() else 0.0
              for g, w in zip(got, ref))
    assert all(g.shape == w.shape for g, w in zip(got, ref)), fn
    return {"fwd": fwd, "bwd": bwd, "calls": dict(dp.stats["calls"])}
