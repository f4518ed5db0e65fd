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
in that order.  The update runs leaf by leaf, a large leaf in blocks of
rows, so its float32 temporaries are about LEAF_ELEMS elements.  Where
the JAX function returns new arrays, this one writes each parameter, m
and v in place (a tensor is mutable, and the model's parameters are the
tensors to update): every leaf's new value is computed from the old ones
as JAX computes it, then written over them.

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

Under FSDP (``cfg.fsdp``, ``sharding/fsdp.py``) the parameters hold the
same slices as m and v (``opt_pspecs`` equals ``param_pspecs`` there):
the update writes each parameter's slice in place, and no gather
follows; a gradient arrives as its slice, summed over data, and the
global norm sums a sliced leaf's squares over data before it sums over
model.
"""
from __future__ import annotations

import torch

from repro_torch.pytree import leaves, tree_map
from repro_torch.sharding.fsdp import WHOLE, plan

F32 = torch.float32
LEAF_ELEMS = 1 << 26        # elements of one leaf_update's float32 temporaries


def adamw_init(params) -> dict:
    """{"m", "v": float32 zeros of every leaf, "step": int32 0}."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=F32, device=p.device)

    dev = leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree, model=None, dims=None, data=None, sliced=None):
    """sqrt of the float32 sum, over the leaves in tree order, of each
    leaf's float32 sum of squares; over the data group ``data`` a leaf
    cut over it (``sliced``, FSDP) counts the sum of its slices' sums,
    and then over the model group ``model`` a leaf cut over it
    (``dims``) the sum of its slices' sums (one all-reduce each)."""
    parts = torch.stack([torch.sum(torch.square(x.float()))
                         for x in leaves(tree)])
    if data is not None and data.world > 1:
        cut = torch.tensor(sliced, device=parts.device)
        whole = data.sum_(torch.where(cut, parts, 0.0))
        parts = torch.where(cut, whole, parts)
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


def _step_scalars(state, grads, b1, b2, clip_norm, model=None, dims=None,
                  data=None, sliced=None):
    """(the new step count, the gradients' global norm, the clip scale,
    the two bias corrections), float32 scalars but the int32 step."""
    step = state["step"] + 1
    gnorm = global_norm(grads, model, dims, data, sliced)
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
    scalars.  A leaf of more than LEAF_ELEMS elements goes in blocks of
    rows, so that its float32 temporaries stay that size (the step is
    elementwise: the same values)."""
    rows = max(1, LEAF_ELEMS // max(1, p[:1].numel()))
    if p.numel() > LEAF_ELEMS and p.shape[0] > rows:
        for i in range(0, p.shape[0], rows):
            leaf_update(p[i:i + rows], g[i:i + rows], m[i:i + rows],
                        v[i:i + rows], scale, bc1, bc2, lr=lr, b1=b1,
                        b2=b2, eps=eps, weight_decay=weight_decay)
        return
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
def _narrow(t, view):
    return t if view == WHOLE else t.narrow(*view)


class Zero1:
    """The ZeRO-1 plan of ``params`` (``convert.param_tree``'s layout)
    over ``dp``'s ranks: ``sharding/fsdp.plan``, the one plan FSDP cuts
    the parameters by.  For each JAX leaf (a stack of layers counts as
    one), ``shards`` holds (its first port leaf, its port leaves, whether
    it is a stack, the data dim of its stacked shape or None); for each
    port leaf, ``views`` holds this rank's slice: ``WHOLE``, (dim, start,
    size), or None where the layer is another rank's.  The state is
    {"m": [a float32 slice or None a port leaf], "v": [...], "step"}.
    With ``fsdp`` the parameters themselves hold their slices
    (``Model.cut_to``): the update writes them, and nothing is gathered
    after it."""

    def __init__(self, cfg, params, dp, model=None, dims=None, fsdp=False):
        self.dp, self.model, self.fsdp = dp, model, fsdp
        m = 1 if model is None else model.world
        self.dims = (dims if dims is not None
                     else [None] * len(leaves(params)))
        self.whole_like, self.shards, self.views, self.owners = plan(
            cfg, params, dp.world, dp.rank, m, self.dims)

    def _mine(self, t, view):
        """This rank's slice of a parameter or gradient leaf ``t``: the
        leaf itself under FSDP (it holds its slice)."""
        return t if self.fsdp else _narrow(t, view)

    def init(self, params) -> dict:
        """Zeros of this rank's slices; step 0."""
        def zeros(p, view):
            if view is None:
                return None
            return torch.zeros(self._mine(p, view).shape, dtype=F32,
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
        slices all-gathered (under FSDP each rank keeps its slices).
        Returns (the new state, the global norm)."""
        step, gnorm, scale, bc1, bc2 = _step_scalars(
            state, grads, b1, b2, clip_norm, self.model, self.dims,
            self.dp if self.fsdp else None,
            [v != WHOLE or o is not None
             for v, o in zip(self.views, self.owners)])
        for p, g, m, v, view in zip(leaves(params), leaves(grads),
                                    state["m"], state["v"], self.views):
            if view is not None:
                leaf_update(self._mine(p, view), self._mine(g, view), m, v,
                            scale, bc1, bc2, lr=lr, b1=b1, b2=b2, eps=eps,
                            weight_decay=weight_decay)
        if not self.fsdp:
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
        """JAX leaf ``k``'s (``shards``' order) port leaves whole on
        ``to``, from the ranks' ``slices`` of them (None: another rank's
        layer): a list on rank 0, None on the others.  Each slice goes to
        rank 0 only."""
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
    def gather_tree(self, slices, to="cpu") -> list | None:
        """The whole port leaves (``param_tree`` order) on rank 0 from
        every rank's ``slices`` of them (this plan's views; None: another
        rank's layer), on ``to``; None on the other ranks: a collective,
        leaf by leaf, over data, then, on data index 0, over model on the
        device.  Every tensor is a copy of its own."""
        from repro_torch.sharding.partition import gather_leaves
        over_model = self.model is not None and self.model.world > 1
        at = (next(x.device for x in slices if x is not None)
              if over_model else to)
        got = [self._gather_to_root(k, slices, at)
               for k in range(len(self.shards))]
        flat = None if got[0] is None else [x for g in got for x in g]
        if over_model and flat is not None:
            flat = gather_leaves(flat, self.dims, self.model)
            flat = None if flat is None else [x.to(to) for x in flat]
        return flat

    @torch.no_grad()
    def gather_state(self, params, state, to="cpu"):
        """The whole state on rank 0, in ``param_tree``'s structure
        ({"m", "v", "step"}, float32 tensors on ``to``), None on the
        other ranks (``gather_tree``): no rank but 0 holds more than its
        slices."""
        from repro_torch.pytree import unflatten
        whole = {}
        for key in ("m", "v"):
            flat = self.gather_tree(state[key], to)
            whole[key] = None if flat is None else unflatten(params, flat)
        if whole["m"] is None:
            return None
        return dict(whole, step=state["step"].to(to, copy=True))

    def slices(self, k, full, data: bool = True) -> list:
        """This rank's slices of JAX leaf ``k`` (``shards``' order) from
        ``full``, its whole stacked tensor: views of it, one a port leaf,
        each its model slice and, with ``data``, its data slice of that
        (None for another rank's layers)."""
        first, n, stacked, _ = self.shards[k]
        parts = list(full.unbind(0)) if stacked else [full]
        parts = [self.model_slice(x, d) for x, d in
                 zip(parts, self.dims[first:first + n])]
        if not data:
            return parts
        return [None if w is None else _narrow(x, w)
                for x, w in zip(parts, self.views[first:first + n])]

    @torch.no_grad()
    def cut(self, k, full, device) -> list:
        """``slices`` of JAX leaf ``k`` as float32 tensors of their own on
        ``device`` (None for another rank's layers): m's or v's."""
        return [None if x is None else
                x.to(device, F32).contiguous().clone()
                for x in self.slices(k, full)]

    def model_slice(self, t, d):
        """This rank's model slice of a whole port leaf ``t`` cut on
        ``d`` (None: whole)."""
        if d is None or self.model is None or self.model.world == 1:
            return t
        size = t.shape[d] // self.model.world
        return t.narrow(d, self.model.rank * size, size)
