"""Carry state across from the JAX package: a store's state, and a
model's weights and decode cache.

Every function takes the state as numpy leaves with the JAX package's
field names — e.g. ``jax.tree.map(np.asarray, backend.group)``,
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
    a store in the middle of a failure carries across whole.
    ``pending_bound`` is the host-side bound on the backup logs' pending
    entries (default: their exact count)."""
    from repro_torch.core.client import LocalBackend

    vals = np.asarray(vals)
    be = LocalBackend(vals.shape[0], cfg, vals.shape[1], device=device)
    be.group = group_from_numpy(group, be.device)
    be.vals = _t(vals, be.device)
    be.used = _t(used, be.device).bool()
    alive = [bool(a) for a in np.asarray(group.alive)]
    be._primary_alive = alive[0]
    be._backups_alive = alive[1:]
    be._pending_bound = (be.pending_ops() if pending_bound is None
                         else pending_bound)
    return be


def store_from_numpy(store, cfg, device) -> kv.KVStore:
    """A KVStore on ``device`` from a JAX KVStore's numpy leaves, their
    [G] and [R, G] layouts kept (hash, primary logs, the shifted sorted
    replicas and backup logs, the value plane, liveness and
    heartbeats)."""
    d = store.data
    data = dp.DataPlane(**{
        f: (_state(lg.UpdateLog, d.freeq, device) if f == "freeq"
            else _t(getattr(d, f), device)) for f in dp.DataPlane._fields})
    return kv.KVStore(
        hash=_state(hi.HashIndex, store.hash, device),
        plog=_state(lg.UpdateLog, store.plog, device),
        bsorted=_state(si.SortedIndex, store.bsorted, device),
        blog=_state(lg.UpdateLog, store.blog, device),
        data=data,
        alive=_t(store.alive, device).bool(),
        sever=_t(store.sever, device).bool(),
        hb=_t(store.hb, device),
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
                                   lease: dict | None = None):
    """A DistributedBackend on ``device`` holding a JAX
    DistributedBackend's store (numpy leaves).  ``pending_bound`` is the
    host-side bound on the backup logs' pending entries (default: their
    exact count).  ``lease`` (``lease_state`` of the source backend)
    carries its liveness and lease state across, so a store taken in
    the middle of a failure goes on as the source would: the same
    servers dead and severed, the same stalled rounds, the stall timers
    as old as they were."""
    import time

    from repro_torch.core.client import DistributedBackend

    G, dcap = np.asarray(store.data.used).shape
    be = DistributedBackend(G, cfg, dcap, capacity_q=capacity_q,
                            scan_limit=scan_limit, device=device)
    be.store = store_from_numpy(store, cfg, be.device)
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


def _load_tree(load, dst, src, path):
    """Load a JAX leaf tree into a module or ParameterDict, name for
    name: a norm's ``{"scale": a}`` leaf into its (1 + scale) parameter,
    a nested dict into a nested ParameterDict or module."""
    if isinstance(dst, torch.Tensor):
        if isinstance(src, dict):
            if set(src) != {"scale"}:
                raise ValueError(f"{path}: leaves {sorted(src)}, a norm "
                                 f"parameter takes {{'scale'}}")
            src = src["scale"]
        load(dst, src)
        return
    have = _children(dst)
    if not isinstance(src, dict) or set(src) != set(have):
        got = sorted(src) if isinstance(src, dict) else type(src).__name__
        raise ValueError(f"{path}: leaves {got}, the port has "
                         f"{sorted(have)}")
    for k, v in src.items():
        _load_tree(load, have[k], v, f"{path}.{k}")


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
    dev = model.device

    def load(param, a):
        t = _tensor(a, dev)
        if t.shape != param.shape or t.dtype != param.dtype:
            raise ValueError(f"leaf {tuple(t.shape)} {t.dtype} does not fit "
                             f"{tuple(param.shape)} {param.dtype}")
        param.data = t

    if hasattr(model, "embed"):
        load(model.embed, params["embed"]["table"])
    if hasattr(model, "lm_head"):
        load(model.lm_head, params["lm_head"]["table"])
    load(model.final_norm, params["final_norm"]["scale"])
    if ("shared" in params) != (model.shared is not None):
        raise ValueError("the JAX tree and the config disagree on the "
                         "shared block")
    if model.shared is not None:
        _load_tree(load, model.shared, params["shared"], "shared")
    layers = _layer_leaves(params["stages"], cfg)
    if len(layers) != len(model.layers):
        raise ValueError(f"{len(layers)} layers, the model has "
                         f"{len(model.layers)}")
    for i, (block, leaves) in enumerate(zip(model.layers, layers)):
        _load_tree(load, block, leaves, f"layer {i}")
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
