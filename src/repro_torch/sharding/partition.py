"""The partition rules as a layout planner (port of
``repro/sharding/partition.py``): every parameter / optimizer / input /
cache leaf gets a spec over a mesh ("pod", "data", "model").

Parallelism map, as the JAX package's:
  * DP  — batch over ("pod", "data")
  * TP  — column/row parallel weights over "model" (Megatron layout)
  * EP  — MoE experts over "model"
  * SP  — sequence over "data" when batch==1 (long-context decode)
  * ZeRO-1 — optimizer state additionally sharded over "data"
  * FSDP — params additionally sharded over "data" (cfg.fsdp; required for
    the 1T-param config)

A mesh is a dict of axis sizes (``launch/mesh.py``).  A spec is a tuple
with one entry a dimension: ``None`` (replicated), an axis name, or a
tuple of names; a spec tree has the input tree's structure.  The JAX
package turns specs into ``NamedSharding``s and lets XLA place the
arrays; the port has no SPMD partitioner.  The specs plan
(``per_device_bytes`` is what each device would hold), and over ranks
they place: ``model_dims`` reads each leaf's "model" entry, ``shard_tree``
cuts a rank's slices by them, ``unshard_tree`` concatenates the slices
back to the whole leaves, and ``cut_model`` cuts a ``Model``'s weights
in place to its rank's shard (``sharding/tp.py``'s mark on each).

Rules are keyed on (leaf name, trailing ndim); stacked stage leaves
(leading [n_rep] axis) reuse the block rules with the prefix replicated.
The port's ``convert.param_tree`` holds a stack as a list of its layers'
tensors, so plan over ``convert.stack_like`` of it: JAX's shapes, on the
meta device.
"""
from __future__ import annotations

import math

import torch

from repro_torch.pytree import leaves_with_path, unflatten


def dp_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh)


def _axis_size(mesh, names) -> int:
    s = 1
    for n in (names if isinstance(names, tuple) else (names,)):
        s *= mesh[n]
    return s


# name -> (trailing_ndim, trailing spec)
_RULES: dict[tuple[str, int], tuple] = {
    # attention / mlp (column, row)
    ("wq", 2): (None, "model"),
    ("wk", 2): (None, "model"),
    ("wv", 2): (None, "model"),
    ("wo", 2): ("model", None),
    ("wi", 2): (None, "model"),
    ("wg", 2): (None, "model"),
    # MLA
    ("w_dkv", 2): (None, "model"),
    ("w_kr", 2): (None, None),
    ("w_uk", 2): (None, "model"),
    ("w_uv", 2): (None, "model"),
    # MoE (expert-parallel)
    ("router", 2): (None, None),
    ("e_wi", 3): ("model", None, None),
    ("e_wg", 3): ("model", None, None),
    ("e_wo", 3): ("model", None, None),
    # mamba1
    ("in_x", 2): (None, "model"),
    ("in_z", 2): (None, "model"),
    ("conv_w", 2): (None, "model"),
    ("conv_b", 1): ("model",),
    ("x_proj", 2): ("model", None),
    ("dt_proj", 2): (None, "model"),
    ("dt_bias", 1): ("model",),
    ("A_log", 2): ("model", None),
    ("A_log", 1): (None,),
    ("ssm_D", 1): ("model",),
    ("ssm_D", 2): ("model", None),
    ("out_proj", 2): ("model", None),
    # mamba2 extras
    ("in_B", 2): (None, "model"),
    ("in_C", 2): (None, "model"),
    ("in_dt", 2): (None, None),
    ("conv_xw", 2): (None, "model"),
    ("conv_xb", 1): ("model",),
    ("conv_Bw", 2): (None, "model"),
    ("conv_Bb", 1): ("model",),
    ("conv_Cw", 2): (None, "model"),
    ("conv_Cb", 1): ("model",),
    ("dt_bias", 2): (None, None),
}


def _leaf_name(path) -> str:
    """The last dict key of a path (list and tuple indices skipped)."""
    for p in reversed(path):
        if isinstance(p, str):
            return p
    return ""


def _top_name(path) -> str:
    return path[0] if path and isinstance(path[0], str) else ""


def _entry(e):
    return e[0] if isinstance(e, tuple) and len(e) == 1 else e


def _map_with_path(rule, tree):
    """``rule(path, leaf)`` over the leaves, each spec's one-name tuples
    written as the name (as ``PartitionSpec`` does)."""
    return unflatten(tree, [tuple(_entry(e) for e in rule(p, x))
                            for p, x in leaves_with_path(tree)])


def _with_extra_data(spec: tuple, shape, mesh, dp) -> tuple:
    """Add the data axis to the first unsharded dim divisible by it
    (ZeRO/FSDP extra sharding).  Falls back to the original spec."""
    dsz = _axis_size(mesh, dp)
    spec = list(spec)
    for i, (s, dim) in enumerate(zip(spec, shape)):
        if s is None and dim % dsz == 0 and dim >= dsz:
            spec[i] = dp if len(dp) > 1 else dp[0]
            return tuple(spec)
    return tuple(spec)


def param_pspecs(cfg, params_tree, mesh, *, extra_data: bool = False):
    """Spec tree for a params(-like) tree.  ``extra_data`` adds data-axis
    sharding (used for FSDP params and ZeRO-1 optimizer state)."""
    dp = dp_axes(mesh)
    msz = mesh.get("model", 1)

    def rule(path, leaf):
        shape = tuple(leaf.shape)
        name = _leaf_name(path)
        top = _top_name(path)
        if top in ("embed", "lm_head"):
            if name == "table" and len(shape) >= 2:
                if top == "embed":
                    spec = [None] * (len(shape) - 2) + ["model", None]
                else:
                    spec = [None] * (len(shape) - 2) + [None, "model"]
            else:
                spec = [None] * len(shape)
        else:
            hit = None
            for t in range(min(len(shape), 3), 0, -1):
                if (name, t) in _RULES:
                    hit = (t, _RULES[(name, t)])
                    break
            if hit is None:
                spec = [None] * len(shape)
            else:
                t, trailing = hit
                spec = [None] * (len(shape) - t) + list(trailing)
        # drop model sharding if not divisible
        for i, s in enumerate(spec):
            if s == "model" and (shape[i] % msz or shape[i] < msz):
                spec[i] = None
        spec = tuple(spec)
        if (extra_data or cfg.fsdp) and len(shape) >= 2 and dp:
            spec = _with_extra_data(spec, shape, mesh, dp)
        return spec

    return _map_with_path(rule, params_tree)


def opt_pspecs(cfg, params_tree, mesh):
    """Optimizer-state (m, v) specs: param specs + ZeRO-1 data sharding."""
    return param_pspecs(cfg, params_tree, mesh, extra_data=cfg.zero1)


def batch_pspec(mesh, global_batch: int):
    """Shard batch over as much of the dp axes as divisibility allows."""
    use = []
    rem = global_batch
    for a in dp_axes(mesh):
        if rem % mesh[a] == 0:
            use.append(a)
            rem //= mesh[a]
    return tuple(use)


def input_pspecs(cfg, shape_spec, inputs_tree, mesh):
    """Specs for the model inputs of a given shape cell."""
    dp = batch_pspec(mesh, shape_spec.global_batch)
    bspec = dp if dp else None
    seq_spec = None
    if not dp and shape_spec.global_batch == 1:
        seq_spec = dp_axes(mesh)    # SP: shard sequence instead (B==1)

    def rule(path, leaf):
        name = _leaf_name(path)
        if name in ("tokens", "targets", "embeds"):
            if leaf.ndim >= 2 and leaf.shape[1] > 1:
                return (bspec, seq_spec) + (None,) * (leaf.ndim - 2)
            return (bspec,) + (None,) * (leaf.ndim - 1)
        if name == "pos":
            return (bspec,)
        return (None,) * leaf.ndim

    return _map_with_path(rule, inputs_tree)


def cache_pspecs(cfg, shape_spec, cache_tree, mesh):
    """KV/SSM cache specs: batch over dp (or sequence over dp when B==1);
    heads/channels over model when divisible.  ``cache_tree`` is in the
    JAX package's layout (``convert.stage_layout`` of ``init_cache``,
    then ``convert.stack_like``)."""
    dp = batch_pspec(mesh, shape_spec.global_batch)
    bspec = dp if dp else None
    full_dp = dp_axes(mesh)
    sp_mode = (not dp) and shape_spec.global_batch == 1
    msz = mesh.get("model", 1)
    hint_seq = cfg.decode_cache_hint

    def rule(path, leaf):
        name = _leaf_name(path)
        shape = tuple(leaf.shape)
        nd = leaf.ndim
        # the batch dim: the first dim equal to global_batch (caches may
        # be stacked [n_rep, ...] inside scan stages)
        bdim = (shape.index(shape_spec.global_batch)
                if shape_spec.global_batch in shape else None)
        spec = [None] * nd
        if name in ("k", "v"):                  # [.., B, cap, Hkv, hd]
            if bdim is not None and not sp_mode:
                spec[bdim] = bspec
            if sp_mode and nd >= 3:
                spec[-3] = full_dp              # shard cache length
            if (hint_seq and not sp_mode and shape[-3] % msz == 0
                    and shape[-3] >= msz and bdim != nd - 3):
                spec[-3] = "model"              # flash-decode: seq over model
            elif shape[-2] % msz == 0 and shape[-2] >= msz:
                spec[-2] = "model"
            elif shape[-1] % msz == 0 and shape[-1] >= msz:
                spec[-1] = "model"
        elif name in ("ckv", "k_rope"):         # [.., B, cap, r]
            if bdim is not None and not sp_mode:
                spec[bdim] = bspec
            if sp_mode and nd >= 2:
                spec[-2] = full_dp
        elif name == "pos":                     # [.., B, cap]
            if bdim is not None and not sp_mode:
                spec[bdim] = bspec
            if sp_mode:
                spec[-1] = full_dp
            elif (hint_seq and shape[-1] % msz == 0 and shape[-1] >= msz
                  and bdim != nd - 1):
                spec[-1] = "model"
        elif name == "ssm":                     # [.., B, di, N] | [.., B,H,P,N]
            if bdim is not None:
                spec[bdim] = bspec
            ch_dim = nd - 3
            if shape[ch_dim] % msz == 0 and shape[ch_dim] >= msz:
                spec[ch_dim] = "model"
        elif name.startswith("conv"):           # [.., B, k-1, C]
            if bdim is not None:
                spec[bdim] = bspec
            if shape[-1] % msz == 0 and shape[-1] >= msz:
                spec[-1] = "model"
        return tuple(spec)

    return _map_with_path(rule, cache_tree)


def spec_at(specs, path):
    """The spec of the leaf at ``path`` (a ``pytree`` path) in a spec
    tree: a spec is a tuple, as a scanned stage is, so a spec tree is read
    by the paths of the tree it was made from."""
    for p in path:
        specs = specs[p]
    return specs


def per_device_bytes(tree, specs, mesh) -> int:
    """The bytes one device holds of ``tree`` laid out by ``specs``: each
    leaf's bytes over the product of the mesh axes its spec names (the
    rules shard only dims the axes divide)."""
    total = 0
    for path, leaf in leaves_with_path(tree):
        split = math.prod(_axis_size(mesh, s)
                          for s in spec_at(specs, path) if s is not None)
        total += leaf.numel() * leaf.element_size() // split
    return total


# ---------------------------------------------------------------------------
# The placer: a rank's slices of the "model" axis
# ---------------------------------------------------------------------------
def _jax_leaves(tree, specs):
    """[(port leaves, spec, stacked)] of ``convert.param_tree``'s layout,
    a stack (a list of layers' tensors) counting as one JAX leaf."""
    from repro_torch.convert import _is_stack
    out = []

    def walk(p, s):
        if _is_stack(p) or torch.is_tensor(p):
            out.append((p if _is_stack(p) else [p], s, _is_stack(p)))
        elif isinstance(p, dict):
            for k in sorted(p):
                walk(p[k], s[k])
        else:
            for x, sx in zip(p, s):
                walk(x, sx)

    walk(tree, specs)
    return out


def model_dims(cfg, tree, mesh) -> list:
    """For each port leaf of ``tree`` (``param_tree``'s layout, whole
    leaves), in tree order, the dim ``param_pspecs`` cuts over "model"
    (in the port leaf's own dims), or None.  A cut of a scanned stage's
    stack axis (the 2-D rules of ``ssm_D`` and Mamba-2's ``A_log`` match
    their stacked [n_rep, H] leaves) would hand whole layers to model
    indices; the port's per-layer leaves stay whole there."""
    from repro_torch.convert import stack_like
    specs = param_pspecs(cfg, stack_like(tree), mesh)
    dims = []
    for ts, spec, stacked in _jax_leaves(tree, specs):
        d = next((i for i, e in enumerate(spec) if e == "model"
                  or (isinstance(e, tuple) and "model" in e)), None)
        if d is not None and stacked:
            d = None if d == 0 else d - 1
        dims += [d] * len(ts)
    return dims


def _slice(t, d, r, m):
    if d is None:
        return t
    n = t.shape[d] // m
    return t.narrow(d, r * n, n)


def shard_tree(cfg, tree, mesh, r: int):
    """Model index ``r``'s slices of ``tree`` (whole leaves, on any
    device, the meta device too): views, in ``tree``'s structure."""
    from repro_torch.pytree import leaves
    m = mesh.get("model", 1)
    return unflatten(tree, [_slice(t, d, r, m) for t, d in zip(
        leaves(tree), model_dims(cfg, tree, mesh))])


def unshard_tree(shards: list, dims: list):
    """The inverse of ``shard_tree``: the model indices' slices (a list of
    trees, in index order) concatenated into whole leaves along
    ``dims`` (``model_dims`` of the whole tree)."""
    from repro_torch.pytree import leaves
    flat = [leaves(t) for t in shards]
    return unflatten(shards[0], [
        parts[0] if d is None else torch.cat(list(parts), d)
        for d, parts in zip(dims, zip(*flat))])


@torch.no_grad()
def cut_model(model, cfg, mesh, r: int) -> list:
    """Cut ``model``'s weights (whole) in place to model index ``r``'s
    slices, each marked with its dim (``sharding/tp.mark``); returns
    ``model_dims``.  A model axis of one cuts nothing."""
    from repro_torch.convert import param_tree
    from repro_torch.pytree import leaves
    from repro_torch.sharding.tp import mark
    m = mesh.get("model", 1)
    tree = param_tree(model, cfg)
    if m == 1:
        return [None] * len(leaves(tree))
    dims = model_dims(cfg, tree, mesh)
    for p, d in zip(leaves(tree), dims):
        if d is not None:
            p.data = _slice(p.data, d, r, m).clone()
            mark(p, d, m)
    return dims


@torch.no_grad()
def gather_leaves(flat, dims, group):
    """Whole leaves on model index 0 of ``group`` (the model group) from
    its ranks' slices ``flat`` (cut on ``dims``, None: whole), None on
    the other indices: one gather to index 0 a cut leaf, the collective
    form of ``unshard_tree``."""
    if group is None or group.world == 1:
        return list(flat)
    out = []
    for t, d in zip(flat, dims):
        if d is None:
            out.append(t)
            continue
        parts = group.gather(t.contiguous())
        out.append(None if parts is None else torch.cat(parts, d))
    return out if group.rank == 0 else None
