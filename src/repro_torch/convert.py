"""Carry state across from the JAX package: a store's state, and a
model's weights and decode cache; and back: a model's weights and its
AdamW state as the JAX package's trees (``params_to_numpy``,
``opt_to_numpy``), the layout of both packages' checkpoints.

Every function of the way in takes the state as numpy leaves with the
JAX package's field names — e.g. ``jax.tree.map(np.asarray, backend.group)``,
``jax.tree.map(np.asarray, backend.store)`` or
``jax.tree.map(np.asarray, params)`` — and builds the port's state on
``device``.  This module reads attributes and keys only; it imports
nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import data_plane as dp
from repro_torch.core import hash_index as hi
from repro_torch.core import index_group as ig
from repro_torch.core import kvstore as kv
from repro_torch.core import log as lg
from repro_torch.core import sorted_index as si
from repro_torch.pytree import tree_map


def _t(a, device):
    return torch.as_tensor(np.array(a, copy=True), device=device)


def _state(cls, src, device, r=None):
    """``cls`` from the same-named fields of ``src``; with ``r``, replica
    r of a state stacked along a leading [R] dimension."""
    return cls(*[_t(getattr(src, f) if r is None else getattr(src, f)[r],
                    device) for f in cls._fields])


def group_from_numpy(group, device) -> ig.IndexGroup:
    """An IndexGroup on ``device`` from a JAX IndexGroup's numpy leaves
    (hash, plog, sorted replicas and backup logs stacked [R, ...],
    alive); the stacks are split into R separate states."""
    R = np.asarray(group.blogs.tail).shape[0]
    return ig.IndexGroup(
        hash=_state(hi.HashIndex, group.hash, device),
        plog=_state(lg.UpdateLog, group.plog, device),
        sorted=tuple(_state(si.SortedIndex, group.sorted, device, r)
                     for r in range(R)),
        blogs=tuple(_state(lg.UpdateLog, group.blogs, device, r)
                    for r in range(R)),
        alive=_t(group.alive, device).bool(),
    )


def backend_from_numpy(group, vals, used, cfg, device, *,
                       pending_bound: int | None = None):
    """A LocalBackend on ``device`` holding a JAX LocalBackend's state:
    its group plus the value shard ``vals`` [cap, W] and the slot bitmap
    ``used`` [cap].  The servers' liveness comes from ``group.alive``, so
    a store in the middle of a failure carries across whole, and its key
    dtype comes from the carried keys (int64 from a JAX backend built
    under ``jax_enable_x64``).  ``pending_bound`` is the host-side bound
    on the backup logs' pending entries (default: their exact count)."""
    from repro_torch.core.client import LocalBackend

    vals = np.asarray(vals)
    carried = group_from_numpy(group, device)
    be = LocalBackend(vals.shape[0], cfg, vals.shape[1], device=device,
                      key_dtype=carried.sorted[0].keys.dtype)
    be.group = carried
    be.vals = _t(vals, be.device)
    be.used = _t(used, be.device).bool()
    alive = [bool(a) for a in np.asarray(group.alive)]
    be._primary_alive = alive[0]
    be._backups_alive = alive[1:]
    be._pending_bound = (be.pending_ops() if pending_bound is None
                         else pending_bound)
    return be


def store_from_numpy(store, cfg, device, comm=None) -> kv.KVStore:
    """A KVStore on ``device`` from a JAX KVStore's numpy leaves, their
    [G] and [R, G] layouts kept (hash, primary logs, the shifted sorted
    replicas and backup logs, the value plane, liveness and
    heartbeats).  With ``comm`` (``Comm``) each rank takes its L groups'
    rows of every sharded leaf and the replicated ``alive`` and
    ``sever`` whole."""
    def leaf(a, axis):
        a = np.asarray(a)
        if comm is not None and axis is not None:
            a = a.take(np.arange(comm.g0, comm.g0 + comm.L), axis)
        return _t(a, device)

    def state(cls, src, axis):
        return cls(*[leaf(getattr(src, f), axis) for f in cls._fields])

    ax, dax, d = kv.GROUP_AXES, dp.GROUP_AXES, store.data
    data = dp.DataPlane(**{
        f: (state(lg.UpdateLog, d.freeq, dax.freeq) if f == "freeq"
            else leaf(getattr(d, f), getattr(dax, f)))
        for f in dp.DataPlane._fields})
    return kv.KVStore(
        hash=state(hi.HashIndex, store.hash, ax.hash),
        plog=state(lg.UpdateLog, store.plog, ax.plog),
        bsorted=state(si.SortedIndex, store.bsorted, ax.bsorted),
        blog=state(lg.UpdateLog, store.blog, ax.blog),
        data=data,
        alive=leaf(store.alive, ax.alive).bool(),
        sever=leaf(store.sever, ax.sever).bool(),
        hb=leaf(store.hb, ax.hb),
    )


# the host-side liveness and lease state of a DistributedBackend (both
# packages use these attribute names); the stall timers travel as ages
LEASE_SETS = ("_dead", "_data_dead", "_severed", "_data_severed")
LEASE_ARRAYS = ("_last_hb", "_hb_misses", "_last_data_hb",
                "_data_hb_misses")
LEASE_TIMERS = ("_hb_t", "_data_hb_t")
LEASE_LISTS = ("detected", "detected_data")


def lease_state(backend) -> dict:
    """A DistributedBackend's host-side liveness and lease state as plain
    data (JSON-able): the servers masked dead and severed per plane, the
    heartbeat counters last seen, the stalled rounds, the seconds since
    each counter last advanced and the detector's demotions.  Reads
    attributes only, so it takes either package's backend."""
    import time

    now = time.monotonic()
    out = {f: sorted(int(g) for g in getattr(backend, f))
           for f in LEASE_SETS}
    out.update({f: [int(x) for x in np.asarray(getattr(backend, f))]
                for f in LEASE_ARRAYS})
    out.update({f: [float(now - x) for x in np.asarray(getattr(backend, f))]
                for f in LEASE_TIMERS})
    out.update({f: [int(g) for g in getattr(backend, f)]
                for f in LEASE_LISTS})
    return out


def distributed_backend_from_numpy(store, cfg, device, *,
                                   capacity_q: int = 64,
                                   scan_limit: int = 128,
                                   pending_bound: int | None = None,
                                   lease: dict | None = None, comm=None):
    """A DistributedBackend on ``device`` holding a JAX
    DistributedBackend's store (numpy leaves).  ``pending_bound`` is the
    host-side bound on the backup logs' pending entries (default: their
    exact count).  ``lease`` (``lease_state`` of the source backend)
    carries its liveness and lease state across, so a store taken in
    the middle of a failure goes on as the source would: the same
    servers dead and severed, the same stalled rounds, the stall timers
    as old as they were.  With ``comm`` (every rank calls it with the
    same leaves) each rank holds its L groups' rows and the whole
    replicated host state, as the backend over ranks does."""
    import time

    from repro_torch.core.client import DistributedBackend

    G, dcap = np.asarray(store.data.used).shape
    be = DistributedBackend(G, cfg, dcap, capacity_q=capacity_q,
                            scan_limit=scan_limit, device=device, comm=comm)
    be.store = store_from_numpy(store, cfg, be.device, comm)
    be._pending_bound = (be.pending_ops() if pending_bound is None
                         else pending_bound)
    if lease is not None:
        now = time.monotonic()
        for f in LEASE_SETS:
            setattr(be, f, set(lease[f]))
        for f in LEASE_ARRAYS:
            setattr(be, f, np.asarray(lease[f], np.int64))
        for f in LEASE_TIMERS:
            setattr(be, f, now - np.asarray(lease[f], np.float64))
        for f in LEASE_LISTS:
            setattr(be, f, list(lease[f]))
    return be


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------
def _tensor(a, device):
    """A tensor from a numpy leaf; bf16 arrives as ml_dtypes' bfloat16,
    which torch reads through its bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return _t(a, device)


def _layer_leaves(stages, cfg):
    """One leaf dict per layer, in layer order, from the JAX package's
    stage list: a "single" stage holds one layer's dict, a "scan" stage a
    tuple (one entry per pattern position) of dicts stacked [n_rep, ...];
    repeat r of the pattern runs its positions in order."""
    from repro_torch.configs.base import layer_plan

    plan = layer_plan(cfg)
    if len(plan) != len(stages):
        raise ValueError(f"{len(stages)} stages, the plan has {len(plan)}")
    out = []
    for st, sp in zip(plan, stages):
        if st.kind == "single":
            out.append(sp)
            continue
        for r in range(st.n_rep):
            for pos in range(len(st.pattern)):
                out.append(_tree_index(sp[pos], r))
    return out


def _tree_index(tree, r):
    if isinstance(tree, dict):
        return {k: _tree_index(v, r) for k, v in tree.items()}
    return np.asarray(tree)[r]


def _children(dst):
    """A module's or ParameterDict's leaves and sub-dicts by name: its
    parameters and child modules (an int field such as a block's window
    is neither)."""
    if isinstance(dst, torch.nn.ParameterDict):
        return {k: dst[k] for k in dst.keys()}
    out = dict(dst.named_parameters(recurse=False))
    out.update(dst.named_children())
    return out


def params_from_numpy(params, cfg, device=None):
    """A ``Model`` on ``device`` (the card unless the caller names another)
    holding a JAX ``init_params`` tree's weights (numpy leaves), the
    scanned stages' [n_rep, ...] leaves unstacked into layers: each
    layer's ``ln1`` (and ``ln2``) scale and its ``mixer`` (and ``ffn``)
    weights by name, nested leaves included (Mamba-2's ``norm``, MLA's
    ``kv_norm``, the MoE's ``shared`` MLP), and ``params["shared"]``, the
    weight-tied block, into ``model.shared``.  A config without a token
    frontend or without a tied table has no ``embed``; a tied one has no
    ``lm_head``."""
    from repro_torch.models.transformer import Model

    model = Model(cfg, device=device)
    load_stacked(param_tree(model, cfg), params)
    return model


def shard_params_from_numpy(params, cfg, ranks, device=None):
    """``params_from_numpy``'s ``Model``, cut to ``ranks``' model index's
    shard (``Model.cut_to``): a JAX tree carried onto one rank of a
    (data x model) mesh."""
    model = params_from_numpy(params, cfg, device)
    model.cut_to(ranks)
    return model


def _cache_tree(tree, dev):
    if isinstance(tree, dict):
        return {k: _cache_tree(v, dev) for k, v in tree.items()}
    return _tensor(tree, dev)


def cache_from_numpy(cache, cfg, device=None):
    """The port's decode cache (one dict per layer: {conv, ssm}, {conv_x,
    conv_B, conv_C, ssm}, {"mamba": ..., "shared": ...}, {k, v, pos} or
    {ckv, k_rope, pos}) on ``device`` from a JAX ``init_cache`` /
    ``decode_step`` cache (numpy leaves)."""
    from repro_torch.core.client import _resolve_device

    dev = _resolve_device(device, "cache_from_numpy")
    return [_cache_tree(layer, dev) for layer in _layer_leaves(cache, cfg)]


# ---------------------------------------------------------------------------
# The way back: a Model's weights and its AdamW state in JAX's layout
# ---------------------------------------------------------------------------
# the port's tensors that JAX holds as a norm's {"scale": ...} leaf
NORMS = ("ln1", "ln2", "norm", "kv_norm")


def _block_tree(dst) -> dict:
    """A block's (or ParameterDict's) parameters as the JAX package's
    leaf dict: a norm's (1 + scale) tensor as {"scale": it}."""
    out = {}
    for k, v in _children(dst).items():
        if isinstance(v, torch.Tensor):
            out[k] = {"scale": v} if k in NORMS else v
        else:
            out[k] = _block_tree(v)
    return out


def _stack_lists(trees):
    """Block trees of one structure -> one tree whose leaves are the
    lists of their leaves (a scanned stage's [n_rep, ...] stack)."""
    if isinstance(trees[0], dict):
        return {k: _stack_lists([t[k] for t in trees]) for k in trees[0]}
    return list(trees)


def stage_layout(per_layer, cfg) -> list:
    """A list of one tree a layer, in layer order, in the JAX package's
    stage layout (``layer_plan``): a single stage its layer's tree, a
    scanned stage a tuple, one tree a pattern position, whose leaves are
    lists of that position's leaf in each repeat (JAX's [n_rep, ...]
    stack).  For parameters (``param_tree``) and decode caches
    (``init_cache``'s list)."""
    from repro_torch.configs.base import layer_plan

    stages, i = [], 0
    for st in layer_plan(cfg):
        L = len(st.pattern)
        if st.kind == "single":
            stages.append(per_layer[i])
        else:
            stages.append(tuple(
                _stack_lists([per_layer[i + r * L + pos]
                              for r in range(st.n_rep)])
                for pos in range(L)))
        i += st.n_rep * L
    if i != len(per_layer):
        raise ValueError(f"the plan covers {i} layers, the model has "
                         f"{len(per_layer)}")
    return stages


def param_tree(model, cfg) -> dict:
    """The model's parameters (the tensors themselves) in the JAX
    package's params layout: ``embed``/``lm_head`` {"table"},
    ``final_norm`` {"scale"}, ``shared``, and ``stages`` by
    ``stage_layout``.  In ``pytree`` order these are JAX's leaves, a
    stack's layers in repeat order; AdamW and the global norm run over
    this tree."""
    tree = {}
    if hasattr(model, "embed"):
        tree["embed"] = {"table": model.embed}
    if hasattr(model, "lm_head"):
        tree["lm_head"] = {"table": model.lm_head}
    tree["final_norm"] = {"scale": model.final_norm}
    if model.shared is not None:
        tree["shared"] = _block_tree(model.shared)
    tree["stages"] = stage_layout([_block_tree(b) for b in model.layers],
                                  cfg)
    return tree


def _is_stack(x) -> bool:
    return isinstance(x, list) and len(x) > 0 and torch.is_tensor(x[0])


def _map_stacks(fn, tree):
    """``fn`` over the leaves of a tree of ``param_tree``'s structure, a
    list of layers' tensors (a stack) counting as one leaf."""
    if _is_stack(tree) or torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_stacks(fn, v) for k, v in tree.items()}
    return type(tree)(_map_stacks(fn, v) for v in tree)


def stack_tree(tree):
    """The tree in JAX's layout: each stack stacked along a new leading
    axis (new tensors), every leaf detached; ready to save."""
    return _map_stacks(lambda x: torch.stack([t.detach() for t in x])
                      if isinstance(x, list) else x.detach(), tree)


def stack_like(tree):
    """``stack_tree``'s shapes and dtypes as meta tensors: nothing is
    allocated."""
    def meta(x):
        one = x[0] if isinstance(x, list) else x
        lead = (len(x),) if isinstance(x, list) else ()
        return torch.empty(lead + tuple(one.shape), dtype=one.dtype,
                           device="meta")
    return _map_stacks(meta, tree)


@torch.no_grad()
def load_stacked(dst, src, path="params"):
    """Write ``src`` (JAX's layout, stacked; tensors or numpy arrays)
    into ``dst`` (``param_tree``'s structure), leaf for leaf: repeat r of
    a stack into the list's r-th tensor.  Shapes and dtypes must match."""
    if _is_stack(dst) or torch.is_tensor(dst):
        parts = dst if _is_stack(dst) else [dst]
        t = src if torch.is_tensor(src) else _tensor(src, parts[0].device)
        want = ((len(parts),) if _is_stack(dst) else ()) + tuple(
            parts[0].shape)
        if tuple(t.shape) != want or t.dtype != parts[0].dtype:
            raise ValueError(f"{path}: leaf {tuple(t.shape)} {t.dtype} does "
                             f"not fit {want} {parts[0].dtype}")
        for r, p in enumerate(parts):
            p.copy_(t[r] if _is_stack(dst) else t)
        return
    if isinstance(dst, dict):
        if not isinstance(src, dict) or set(src) != set(dst):
            raise ValueError(f"{path}: leaves {sorted(src)}, the port has "
                             f"{sorted(dst)}")
        for k in dst:
            load_stacked(dst[k], src[k], f"{path}/{k}")
        return
    if len(src) != len(dst):
        raise ValueError(f"{path}: {len(src)} entries, the port has "
                         f"{len(dst)}")
    for i, (d, s) in enumerate(zip(dst, src)):
        load_stacked(d, s, f"{path}/{i}")


def _numpy(t) -> np.ndarray:
    """A tensor as a numpy array; bf16, which numpy has no type for here,
    as float32 (every bf16 value is a float32 value)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def params_to_numpy(model, cfg) -> dict:
    """The model's weights as the JAX package's ``init_params`` tree of
    numpy arrays (``param_tree`` stacked): the inverse of
    ``params_from_numpy`` (bf16 weights come back as float32 arrays of
    the same values)."""
    return tree_map(_numpy, stack_tree(param_tree(model, cfg)))


def opt_to_numpy(opt) -> dict:
    """An AdamW state over ``param_tree`` ({"m", "v", "step"}) as the JAX
    package's ``adamw_init`` tree of numpy arrays."""
    return tree_map(_numpy, stack_tree(opt))


def opt_from_numpy(opt, model, cfg) -> dict:
    """The AdamW state over ``param_tree(model, cfg)`` from a JAX
    ``adamw_init`` / ``adamw_update`` state (numpy leaves), on the
    model's device."""
    from repro_torch.optim.adamw import adamw_init

    state = adamw_init(param_tree(model, cfg))
    load_stacked(state["m"], opt["m"], "opt/m")
    load_stacked(state["v"], opt["v"], "opt/v")
    state["step"] = _t(np.asarray(opt["step"], np.int32), model.device)
    return state
