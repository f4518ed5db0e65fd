"""AdamW with global-norm clipping (port of ``repro/optim/adamw.py``).

Not ``torch.optim.AdamW``: this is the JAX package's function.  The
gradients are clipped by their global norm first; weight decay sits
inside the step, ``delta = mh / (sqrt(vh) + eps) + wd * p``; a parameter
takes the float32 step and is rounded to its own dtype,
``(p.f32 - lr * delta).to(p.dtype)``, so a bf16 parameter has no float32
master copy.  m and v are float32 whatever the parameter's dtype, and
the bias corrections are float32 powers of the int32 step count.

A tree is nested dicts, lists and tuples of tensors (``pytree``); the
leaves go in the JAX package's tree order, and the global norm sums them
in that order.  The update runs leaf by leaf, so its float32 temporaries
are one leaf's size.  Where the JAX function returns new arrays, this one
writes each parameter, m and v in place (a tensor is mutable, and the
model's parameters are the tensors to update): every leaf's new value is
computed from the old ones as JAX computes it, then written over them.

ZeRO-1 over ranks (``Zero1``, as ``cfg.zero1`` asks): each rank holds
and updates only its slice of m and v and of the parameters, then the
parameter slices are all-gathered.  The slices are the JAX plan,
``sharding/partition.opt_pspecs`` of the state over the mesh
{"data": W, "model": 1} (the specs ``make_sharded_step`` gives its m
and v): the data axis on the first unsharded dim it divides of JAX's
stacked shape.  Where that dim is a scanned stage's stack axis, a rank's
slice is a set of whole layers of the port's list layout
(``convert.param_tree``); a leaf with no such dim is updated whole on
every rank, as JAX's spec falls back to replicated.  The gradients are
the summed ones on every rank, so their global norm, taken before the
update, is the same on every rank.

Over a (data x model) mesh (``model``, the model group, and ``dims``,
each port leaf's cut over it: ``Model.cut_to``) a rank's leaves are its
model slices, the plan is ``opt_pspecs`` over {"data": d, "model": m}
of the whole shapes, and the data axis goes on the first dim the model
axis leaves whole (``_with_extra_data``: it may be another dim than at
m = 1).  m and v follow the parameter's model cut: JAX's ``opt_pspecs``
reads the state under its "m" key, so its embedding and head tables
lose their model entry there (replicated over model, the data axis on
the vocab), where the port's rank holds the data slice of its own
vocab rows; a leaf whose model slice the data axis does not divide
stays whole.  The global norm counts a cut leaf once, as the sum over model
of its slices' sums of squares, and a whole leaf once.
"""
from __future__ import annotations

import torch

from repro_torch.pytree import leaves, tree_map

F32 = torch.float32


def adamw_init(params) -> dict:
    """{"m", "v": float32 zeros of every leaf, "step": int32 0}."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=F32, device=p.device)

    dev = leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree, model=None, dims=None):
    """sqrt of the float32 sum, over the leaves in tree order, of each
    leaf's float32 sum of squares; over the model group ``model`` a leaf
    cut over it (``dims``) counts the sum of its slices' sums (one
    all-reduce)."""
    parts = torch.stack([torch.sum(torch.square(x.float()))
                         for x in leaves(tree)])
    if model is not None and model.world > 1:
        cut = torch.tensor([d is not None for d in dims],
                           device=parts.device)
        whole = model.sum_(torch.where(cut, parts, 0.0))
        parts = torch.where(cut, whole, parts)
    return torch.sqrt(torch.sum(parts))


@torch.no_grad()
def adamw_update(params, grads, state, *, lr=3e-4, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1, clip_norm=1.0):
    """One AdamW step over the tree.  Returns (params, the new state, the
    gradients' global norm before clipping); ``params`` and the state's m
    and v are the same tensors, written in place."""
    step, gnorm, scale, bc1, bc2 = _step_scalars(state, grads, b1, b2,
                                                 clip_norm)
    for p, g, m, v in zip(leaves(params), leaves(grads),
                          leaves(state["m"]), leaves(state["v"])):
        leaf_update(p, g, m, v, scale, bc1, bc2, lr=lr, b1=b1, b2=b2,
                    eps=eps, weight_decay=weight_decay)
    return params, {"m": state["m"], "v": state["v"], "step": step}, gnorm


def _step_scalars(state, grads, b1, b2, clip_norm, model=None, dims=None):
    """(the new step count, the gradients' global norm, the clip scale,
    the two bias corrections), float32 scalars but the int32 step."""
    step = state["step"] + 1
    gnorm = global_norm(grads, model, dims)
    one = torch.ones((), dtype=F32, device=gnorm.device)
    scale = torch.minimum(one, (one * clip_norm)
                          / torch.maximum(gnorm, one * 1e-9))
    stepf = step.to(F32)
    bc1 = 1.0 - torch.pow(one * b1, stepf)
    bc2 = 1.0 - torch.pow(one * b2, stepf)
    return step, gnorm, scale, bc1, bc2


@torch.no_grad()
def leaf_update(p, g, m, v, scale, bc1, bc2, *, lr=3e-4, b1=0.9, b2=0.95,
                eps=1e-8, weight_decay=0.1):
    """``adamw_update``'s step of one leaf, in place: the clip ``scale``
    and the bias corrections ``bc1``, ``bc2`` are the step's float32
    scalars."""
    g = g.to(F32) * scale
    m_new = b1 * m + (1 - b1) * g
    v_new = b2 * v + (1 - b2) * g * g
    mh = m_new / bc1
    vh = v_new / bc2
    pf = p.to(F32)
    delta = mh / (torch.sqrt(vh) + eps) + weight_decay * pf
    p.copy_((pf - lr * delta).to(p.dtype))
    m.copy_(m_new)
    v.copy_(v_new)


# ---------------------------------------------------------------------------
# ZeRO-1 over ranks
# ---------------------------------------------------------------------------
WHOLE = ()                  # a view: the whole leaf


def _narrow(t, view):
    return t if view == WHOLE else t.narrow(*view)


def _data_dim(spec):
    """The dim a spec puts the data axis on, or None."""
    for i, e in enumerate(spec):
        if e == "data" or (isinstance(e, tuple) and "data" in e):
            return i
    return None


class Zero1:
    """The ZeRO-1 plan of ``params`` (``convert.param_tree``'s layout)
    over ``dp``'s ranks.  For each JAX leaf (a stack of layers counts as
    one), ``shards`` holds (its first port leaf, its port leaves, whether
    it is a stack, the data dim of its stacked shape or None); for each
    port leaf, ``views`` holds this rank's slice: ``WHOLE``, (dim, start,
    size), or None where the layer is another rank's.  The state is
    {"m": [a float32 slice or None a port leaf], "v": [...], "step"}."""

    def __init__(self, cfg, params, dp, model=None, dims=None):
        from repro_torch.convert import _is_stack, stack_like
        from repro_torch.pytree import unflatten
        from repro_torch.sharding.partition import opt_pspecs

        self.dp, self.model = dp, model
        W, r = dp.world, dp.rank
        m = 1 if model is None else model.world
        flat = leaves(params)
        self.dims = dims if dims is not None else [None] * len(flat)
        whole = unflatten(params, [
            torch.empty(tuple(n * (m if i == d else 1)
                              for i, n in enumerate(t.shape)),
                        dtype=t.dtype, device="meta")
            for t, d in zip(flat, self.dims)])
        mesh = {"data": W, "model": m}
        self.whole_like = stack_like(whole)   # JAX's shapes, meta tensors
        specs = opt_pspecs(cfg, {"m": self.whole_like}, mesh)["m"]
        self.shards, self.views = [], []

        def walk(p, s):
            if _is_stack(p) or torch.is_tensor(p):
                ts = p if _is_stack(p) else [p]
                d = _data_dim(s)
                if d is not None and not (_is_stack(p) and d == 0):
                    e = d - 1 if _is_stack(p) else d
                    if ts[0].shape[e] % W:      # the model slice does
                        d = None                # not divide: kept whole
                self.shards.append((len(self.views), len(ts), _is_stack(p),
                                    d))
                for j, t in enumerate(ts):
                    if d is None:
                        self.views.append(WHOLE)
                    elif _is_stack(p) and d == 0:
                        per = len(ts) // W
                        self.views.append(WHOLE if j // per == r else None)
                    else:
                        e = d - 1 if _is_stack(p) else d
                        size = t.shape[e] // W
                        self.views.append((e, r * size, size))
                return
            if isinstance(p, dict):
                for k in sorted(p):
                    walk(p[k], s[k])
            else:
                for x, sx in zip(p, s):
                    walk(x, sx)

        walk(params, specs)

    def init(self, params) -> dict:
        """Zeros of this rank's slices; step 0."""
        def zeros(p, view):
            if view is None:
                return None
            return torch.zeros(_narrow(p, view).shape, dtype=F32,
                               device=p.device)

        flat = leaves(params)
        return {"m": [zeros(p, w) for p, w in zip(flat, self.views)],
                "v": [zeros(p, w) for p, w in zip(flat, self.views)],
                "step": torch.zeros((), dtype=torch.int32,
                                    device=flat[0].device)}

    @staticmethod
    def nbytes(slices) -> int:
        """The bytes of one rank's m (or v) slices."""
        return sum(x.numel() * x.element_size() for x in slices
                   if x is not None)

    @torch.no_grad()
    def update(self, params, grads, state, *, lr=3e-4, b1=0.9, b2=0.95,
               eps=1e-8, weight_decay=0.1, clip_norm=1.0):
        """``adamw_update`` on this rank's slices, then the parameters'
        slices all-gathered.  Returns (the new state, the global norm)."""
        step, gnorm, scale, bc1, bc2 = _step_scalars(
            state, grads, b1, b2, clip_norm, self.model, self.dims)
        for p, g, m, v, view in zip(leaves(params), leaves(grads),
                                    state["m"], state["v"], self.views):
            if view is not None:
                leaf_update(_narrow(p, view), _narrow(g, view), m, v, scale,
                            bc1, bc2, lr=lr, b1=b1, b2=b2, eps=eps,
                            weight_decay=weight_decay)
        self._gather_params([p.detach() for p in leaves(params)])
        return {"m": state["m"], "v": state["v"], "step": step}, gnorm

    def _gather_params(self, flat):
        """The parameters' slices all-gathered in place."""
        dp, W, r = self.dp, self.dp.world, self.dp.rank
        if W == 1:
            return
        for first, n, stacked, d in self.shards:
            ts = flat[first:first + n]
            if d is None:               # updated whole on every rank
                continue
            if stacked and d == 0:
                per = n // W
                for j in range(per):
                    dp.all_gather_into([ts[q * per + j] for q in range(W)],
                                       ts[r * per + j])
                continue
            for t, (e, start, size) in zip(ts, self.views[first:first + n]):
                mine = t.narrow(e, start, size)
                bufs = [torch.empty(mine.shape, dtype=t.dtype, device=t.device)
                        for _ in range(W)]
                dp.all_gather_into(bufs, mine)
                for q in range(W):
                    t.narrow(e, q * size, size).copy_(bufs[q])

    def _gather_to_root(self, k, slices, to):
        """JAX leaf ``k``'s (``shards``' order) port leaves whole, float32
        on ``to``, from the ranks' ``slices`` of them: a list on rank 0,
        None on the others.  Each slice goes to rank 0 only."""
        dp, W = self.dp, self.dp.world
        first, n, stacked, d = self.shards[k]
        mine = slices[first:first + n]
        root = dp.rank == 0
        if d is None:                   # whole on every rank
            return [x.to(to, copy=True) for x in mine] if root else None
        out = [None] * n
        if stacked and d == 0:          # a rank's slice is whole layers
            per = n // W
            for j in range(per):
                parts = dp.gather(mine[dp.rank * per + j])
                for q in range(W if root else 0):
                    out[q * per + j] = parts[q].to(to)
        else:
            for j, (e, _, _) in enumerate(self.views[first:first + n]):
                parts = dp.gather(mine[j])
                if root:
                    out[j] = torch.cat(parts, e).to(to)
        return out if root else None

    @torch.no_grad()
    def gather_state(self, params, state, to="cpu"):
        """The whole state on rank 0, in ``param_tree``'s structure
        ({"m", "v", "step"}, float32 tensors on ``to``), None on the
        other ranks: a collective, leaf by leaf (over data, then, on
        data index 0, over model on the device); no rank but 0 holds
        more than its slices.  Every tensor is a copy of its own."""
        from repro_torch.pytree import unflatten
        from repro_torch.sharding.partition import gather_leaves
        over_model = self.model is not None and self.model.world > 1
        at = state["step"].device if over_model else to
        whole = {}
        for key in ("m", "v"):
            got = [self._gather_to_root(k, state[key], at)
                   for k in range(len(self.shards))]
            flat = None if got[0] is None else [x for g in got for x in g]
            if over_model and flat is not None:
                flat = gather_leaves(flat, self.dims, self.model)
                flat = None if flat is None else [x.to(to) for x in flat]
            whole[key] = None if flat is None else unflatten(params, flat)
        if whole["m"] is None:
            return None
        return dict(whole, step=state["step"].to(to, copy=True))

    @torch.no_grad()
    def cut(self, k, full, device) -> list:
        """This rank's slices of JAX leaf ``k`` (``shards``' order) from
        ``full``, its whole stacked tensor on any device: float32 tensors
        on ``device``, None for another rank's layers."""
        first, n, stacked, _ = self.shards[k]
        parts = list(full.unbind(0)) if stacked else [full]
        parts = [self.model_slice(x, d) for x, d in
                 zip(parts, self.dims[first:first + n])]
        return [None if w is None else
                _narrow(x, w).to(device, F32).contiguous().clone()
                for x, w in zip(parts, self.views[first:first + n])]

    def model_slice(self, t, d):
        """This rank's model slice of a whole port leaf ``t`` cut on
        ``d`` (None: whole)."""
        if d is None or self.model is None or self.model.world == 1:
            return t
        size = t.shape[d] // self.model.world
        return t.narrow(d, self.model.rank * size, size)

