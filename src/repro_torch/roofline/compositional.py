"""Compositional cost analysis on the meta device (port of
``repro/roofline/compositional.py``).

The same rule as the JAX package's:

    cost(cell) = cost(base) + sum_spec  n_layers(spec) * cost(layer(spec))

where cost(layer) is ONE of the port's blocks (``models/transformer.py``'s
``_block``, through ``layer_step`` as ``apply_model`` runs it): for train
its forward and backward, under ``torch.utils.checkpoint`` when
``cfg.remat == "unit"`` (so the backward recomputes the forward), plus
its AdamW slice (``optim/adamw.leaf_update``); for prefill the forward;
for decode one decode step over the block's cache.  cost(base) is the
``n_layers=0`` config's whole step (frontend, final norm, head and loss,
AdamW over the non-layer parameters).  Everything runs on the meta
device, so nothing is allocated and the counts hold at any size.

Two counts, by ``TorchDispatchMode``s over the aten ops:
  * ``flops``: ``torch.utils.flop_counter.FlopCounterMode``, which counts
    the GEMM-like ops (mm, bmm, addmm, convolution, attention) and not the
    elementwise ones (``flops_source: "gemm"``).  XLA's ``cost_analysis``
    counts every op, so the two packages' counts differ.
  * ``bytes_unfused``: the input and output bytes of every aten op, a
    view op counting zero.  An upper bound on HBM traffic: XLA counts per
    fused op, and an in-place op's destination is counted as read too.

Known approximations:
  * the global grad-norm pass over the layer parameters (a square and a
    sum a leaf) is counted by the base program only, as in the JAX
    package;
  * with ``frontend == "embed"`` the first layer's input needs no
    gradient, and the whole step skips its input-gradient GEMMs, which
    every layer here counts;
  * zamba2's weight-tied shared block: each ``mamba2+shared`` layer
    counts the shared block's forward and backward but not its AdamW
    slice; a one-off ``shared`` entry counts that slice once and the
    n - 1 gradient sums of its n calls.  (The JAX package counts the
    slice in every such layer.)
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import ModelConfig, input_specs
from repro_torch.convert import param_tree
from repro_torch.models import transformer as tfm
from repro_torch.optim.adamw import adamw_init, leaf_update
from repro_torch.pytree import leaves

F32 = torch.float32
META = torch.device("meta")


class ByteCounter(TorchDispatchMode):
    """Sums the input and output bytes of every aten op it sees; view ops
    (aliases of their input) count zero."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            for t in tree_flatten((args, kwargs, out))[0]:
                if isinstance(t, torch.Tensor):
                    self.bytes += t.numel() * t.element_size()
        return out


def count(fn, *args, **kwargs) -> dict:
    """{"flops", "bytes_unfused"} of ``fn(*args, **kwargs)``."""
    with FlopCounterMode(display=False) as fc, ByteCounter() as bc:
        fn(*args, **kwargs)
    return {"flops": float(fc.get_total_flops()),
            "bytes_unfused": float(bc.bytes)}


def meta_model(cfg: ModelConfig) -> tfm.Model:
    """The config's ``Model`` on the meta device (shapes only)."""
    return tfm.Model(cfg, device=META, generator=torch.Generator())


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def _zeros_like_f32(tree):
    return [torch.zeros(p.shape, dtype=F32, device=META)
            for p in leaves(tree)]


def _scalars():
    """adamw_update's clip scale and bias corrections (float32 scalars)."""
    return [torch.ones((), dtype=F32, device=META) for _ in range(3)]


def _adamw_slice(params, grads):
    """AdamW's update of ``params`` by ``grads`` (``leaf_update`` a leaf,
    as ``adamw_update`` runs it), its m, v and scalars made outside the
    count.  Returns a function to count."""
    m, v = _zeros_like_f32(params), _zeros_like_f32(params)
    scale, bc1, bc2 = _scalars()

    def run():
        for p, g, mm, vv in zip(params, grads, m, v):
            leaf_update(p, g, mm, vv, scale, bc1, bc2)
    return run


def _layer(cfg, spec):
    gen = torch.Generator()
    blk = tfm._block(cfg, spec, gen, META)
    shared = (tfm.SharedBlock(cfg, gen, META)
              if spec[0] == "mamba2+shared" else None)
    return blk, shared


def layer_cost_train(cfg: ModelConfig, spec, shape) -> dict:
    """One layer's forward + backward (with the remat recompute) + its
    AdamW slice."""
    B, S = shape.global_batch, shape.seq_len
    blk, shared = _layer(cfg, spec)
    own = list(blk.parameters())
    flat = own + (list(shared.parameters()) if shared else [])
    for p in flat:
        p.requires_grad_(True)
    # a non-leaf input, as every layer's is in the whole step (the flop
    # counter's module hooks refuse a leaf under autograd.grad)
    x = _meta((B, S, cfg.d_model), cfg.param_dtype).requires_grad_(
        True).clone()
    positions = torch.arange(S, device=META).expand(B, S)
    aux0 = torch.zeros((), dtype=F32, device=META)
    ct, one = torch.empty_like(x), torch.ones((), dtype=F32, device=META)
    grads = []

    def fwd_bwd():
        with torch.enable_grad():
            y, aux = tfm.layer_step(cfg, blk, x, positions, shared, aux0)
            outs, cts = ([y, aux], [ct, one]) if aux.requires_grad else (
                [y], [ct])
            grads.extend(torch.autograd.grad(
                outs, flat + [x], cts, allow_unused=True,
                materialize_grads=True))

    c = count(fwd_bwd)
    upd = count(_adamw_slice(own, grads[:len(own)]))
    return {"flops": c["flops"] + upd["flops"],
            "bytes_unfused": c["bytes_unfused"] + upd["bytes_unfused"]}


def layer_cost_prefill(cfg: ModelConfig, spec, shape) -> dict:
    B, S = shape.global_batch, shape.seq_len
    blk, shared = _layer(cfg, spec)
    x = _meta((B, S, cfg.d_model), cfg.param_dtype)
    positions = torch.arange(S, device=META).expand(B, S)
    aux0 = torch.zeros((), dtype=F32, device=META)
    with torch.no_grad():
        return count(tfm.layer_step, cfg, blk, x, positions, shared, aux0)


def layer_cost_decode(cfg: ModelConfig, spec, shape) -> dict:
    B, S = shape.global_batch, shape.seq_len
    blk, shared = _layer(cfg, spec)
    cache = tfm._block_cache_init(cfg, spec, B, S, META)
    x = _meta((B, 1, cfg.d_model), cfg.param_dtype)
    pos = _meta((B,), torch.int32)
    with torch.no_grad():
        return count(blk.decode, cfg, x, pos, cache, shared)


def shared_cost_train(cfg: ModelConfig, n_calls: int) -> dict:
    """The weight-tied shared block's one-off train cost: its AdamW slice
    once and the n_calls - 1 sums of its gradients."""
    params = list(tfm.SharedBlock(cfg, torch.Generator(), META).parameters())
    grads = [torch.empty_like(p) for p in params]

    def sums():
        for g in grads:
            for _ in range(n_calls - 1):
                g + g
    a, b = count(sums), count(_adamw_slice(params, grads))
    return {"flops": a["flops"] + b["flops"],
            "bytes_unfused": a["bytes_unfused"] + b["bytes_unfused"]}


def whole_step(cfg: ModelConfig, shape):
    """The whole step of a cell on the config's meta model: a function
    that runs it (the train step, prefill, or one decode step over a
    fresh cache), its inputs made outside it."""
    from repro_torch.serving.serve_step import prefill
    from repro_torch.train.step import train_step

    model = meta_model(cfg)
    inputs = input_specs(cfg, shape)
    if shape.kind == "train":
        opt = adamw_init(param_tree(model, cfg))
        return lambda: train_step(cfg, model, opt, inputs)
    if shape.kind == "prefill":
        return lambda: prefill(cfg, model, inputs)
    cache = tfm.init_cache(cfg, shape.global_batch, shape.seq_len,
                           device=META)
    return lambda: tfm.decode_step(cfg, model, cache, inputs)


def base_cost(cfg: ModelConfig, shape) -> dict:
    """The n_layers=0 program: frontend + final norm + head/loss (+ the
    optimizer over the non-layer parameters for train)."""
    cfg0 = cfg.scaled(n_layers=0, first_k_dense=0, shared_attn_every=0)
    return count(whole_step(cfg0, shape))


def compositional_cost(cfg: ModelConfig, shape) -> dict:
    """The global cost of the cell composed from the base and the
    per-spec layer costs."""
    uniq: dict = {}
    for s in cfg.layer_specs():
        uniq[s] = uniq.get(s, 0) + 1
    layer_cost = {"train": layer_cost_train, "prefill": layer_cost_prefill,
                  "decode": layer_cost_decode}[shape.kind]
    base = base_cost(cfg, shape)
    total = dict(base)
    per_layer = {"base": {"count": 1, **base}}
    parts = [(s, n, layer_cost(cfg, s, shape)) for s, n in uniq.items()]
    n_shared = uniq.get(("mamba2+shared", None), 0)
    if shape.kind == "train" and n_shared:
        parts.append((("shared",), 1, shared_cost_train(cfg, n_shared)))
    for s, n, c in parts:
        per_layer["/".join(str(x) for x in s)] = {"count": n, **c}
        for k in ("flops", "bytes_unfused"):
            total[k] += n * c[k]
    total["per_layer"] = per_layer
    total["flops_source"] = "gemm"
    return total
