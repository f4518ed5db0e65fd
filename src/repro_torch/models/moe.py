"""Mixture-of-Experts FFN with sort-based capacity dispatch (port of
``repro/models/moe.py``).

The router (float32) picks each token's top-k experts; the (token,
expert) slots are sorted by expert, ranked within their expert and
written into a fixed-capacity [E, C, D] buffer; slots past an expert's
capacity C are dropped.  The router adds the load-balance and z losses.
``params`` holds ``router`` [D, E] float32, ``e_wi``/``e_wg`` [E, D, F],
``e_wo`` [E, F, D] and, with shared experts, ``shared`` (a SwiGLU MLP of
width F * n_shared_experts), a dict or a ``ParameterDict``.

Every ``moe_impl`` takes the sort dispatch: JAX's shard_map dispatch
(``_dispatch_smap``) runs only with a mesh set, and the port has none, so
JAX without a mesh and the port compute the same function.

Three rules hold the port to JAX's answer:

  * top-k keeps JAX's tie rule, the lower expert first among equal
    probabilities (bf16 router logits tie often): the first k of a stable
    descending sort, where ``torch.topk`` promises no order for ties;
  * the sort by expert is stable, as ``jnp.argsort`` is, and the dispatch
    write uses ``core/scatter.py``'s drop emulation (the targets of the
    kept slots are unique);
  * the combine adds each token's k contributions in the sorted order
    (ascending expert), one by one in the activations' dtype from zeros,
    as JAX's ``.at[t_s].add`` applies its updates; no ``index_add_``,
    whose order on the card is not fixed.

Over ranks (a group of W > 1 set by ``sharding/context.py``'s
``use_dp`` while a loss and its gradient are taken, the backward's
recompute included) each rank holds its rows of the global batch, and
the MoE keeps the global semantics GSPMD gives the JAX step: one
``all_gather`` of the ranks' [E] expert counts gives the global density
(no gradient), the capacity ``_capacity(cfg, T_global)``, and each
slot's rank within its expert in JAX's global sort: its rank on this
rank plus the counts that lower ranks route to that expert.  So the
slots kept are exactly those the global sort keeps.  ``p_mean`` and the
z-loss are the rank's sums over the global token count: the ranks' aux
losses sum to the global one.  The experts are row-wise, so each rank
runs only its own kept slots, in an [E, min(C, T_local), D] buffer.

The expert products JAX takes with ``preferred_element_type=F32`` run in
groups of experts: ``h`` and ``ys`` as matmuls in the activations' dtype
(float32 accumulation, one rounding: JAX's cast), the gate ``g`` as a
float32 matmul of float32 copies (JAX keeps it float32); a group's
float32 weights hold at most ``EXPERT_ELEMS`` elements.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.scatter import drop_set_rows
from repro_torch.models.layers import dot, mlp_apply, mlp_init, normal
from repro_torch.sharding.context import current_dp

F32 = torch.float32
EXPERT_ELEMS = 1 << 28     # float32 gate weights of one expert group (1 GiB)


def moe_init(cfg, generator, device) -> dict:
    dt = cfg.param_dtype
    D, E, Fd = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    s_in, s_ff = D ** -0.5, Fd ** -0.5
    p = {
        "router": normal((D, E), s_in, F32, generator, device),
        "e_wi": normal((E, D, Fd), s_in, dt, generator, device),
        "e_wg": normal((E, D, Fd), s_in, dt, generator, device),
        "e_wo": normal((E, Fd, D), s_ff, dt, generator, device),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(generator, D, Fd * cfg.n_shared_experts, dt,
                               device)
    return p


def _capacity(cfg, T: int) -> int:
    c = int(T * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, (c + 7) // 8 * 8)


def route(cfg, params, xf):
    """The router: (logits [T,E] float32, probs, top-k experts [T,k] with
    the lower index first on ties, their normalised gates)."""
    logits = dot(xf, params["router"]).float()                      # [T,E]
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = top.values[:, :cfg.top_k], top.indices[:, :cfg.top_k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, eidx, gate


def expert_counts(e_flat, E):
    """Each expert's slot count, int64 [E]: ``torch.bincount``'s answer
    as a sum of one-hot rows, which has a meta kernel (the dry run counts
    this module on the meta device)."""
    return torch.sum(e_flat[:, None] == torch.arange(E, device=e_flat.device),
                     dim=0)


def moe_apply(cfg, params, x):
    """x: [B,S,D] -> (y [B,S,D], aux_loss scalar float32)."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    xf = x.reshape(T, D)
    logits, probs, eidx, gate = route(cfg, params, xf)
    dp = current_dp()
    if dp is not None and dp.world > 1:
        aux_loss, C, base = _global_stats(cfg, dp, logits, probs, eidx)
        out = _dispatch(cfg, params, xf, eidx, gate, C, base)
    else:
        # aux losses: load-balance (Switch) + router z-loss
        density = expert_counts(eidx.reshape(-1), E).float() / (T * k)
        aux = E * torch.sum(density * probs.mean(0))
        zloss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
        aux_loss = 0.01 * aux + 0.001 * zloss
        out = _dispatch(cfg, params, xf, eidx, gate, _capacity(cfg, T))
    if cfg.n_shared_experts:
        out = out + mlp_apply(params["shared"], xf)
    return out.reshape(B, S, D), aux_loss


def _global_stats(cfg, dp, logits, probs, eidx):
    """The router statistics over ``dp``'s ranks (every rank holds T
    tokens): (this rank's share of the aux loss, the global capacity,
    the [E] counts lower ranks route to each expert)."""
    T, k = eidx.shape
    E = cfg.n_experts
    T_all = T * dp.world
    with torch.no_grad():
        counts = dp.all_gather(expert_counts(eidx.reshape(-1), E)[None])
    density = counts.sum(0).float() / (T_all * k)
    aux = E * torch.sum(density * (probs.sum(0) / T_all))
    zloss = torch.sum(torch.logsumexp(logits, dim=-1) ** 2) / T_all
    return (0.01 * aux + 0.001 * zloss, _capacity(cfg, T_all),
            counts[:dp.rank].sum(0))


def buffer_rows(C, T, base):
    """Rows of an expert's dispatch buffer: C, or over ranks (``base``
    given) min(C, T): a rank keeps at most C - base of an expert's slots,
    and routes at most T there."""
    return C if base is None else min(C, T)


def dispatch_plan(cfg, eidx, C, base=None):
    """The sort dispatch's bookkeeping: (order, the sorted slots' experts,
    tokens and ranks, keep, dest).  Slot i = t * k + j is token t's j-th
    choice; ``dest`` is its row of the [E * rows] buffer
    (``buffer_rows``), E * rows where dropped.  ``base`` (over ranks)
    holds the slots lower ranks route to each expert: a slot is kept
    where its rank in the global sort, base plus its rank here, is
    below C."""
    T, k = eidx.shape
    E = cfg.n_experts
    e_flat = eidx.reshape(-1)
    order = torch.sort(e_flat, stable=True).indices
    e_s = e_flat[order]
    t_s = order // k
    counts = expert_counts(e_flat, E)
    starts = torch.cumsum(counts, 0) - counts                      # exclusive
    rank = torch.arange(T * k, device=eidx.device) - starts[e_s]
    rows = buffer_rows(C, T, base)
    keep = rank < C if base is None else base[e_s] + rank < C
    dest = torch.where(keep, e_s * rows + rank, E * rows)
    return order, e_s, t_s, keep, dest


def _experts(params, xs):
    """The SwiGLU experts on their [E, C, D] buffer, in groups of experts
    whose float32 gate weights hold at most EXPERT_ELEMS elements."""
    E, _, D = xs.shape
    Fd = params["e_wi"].shape[2]
    ys = torch.empty_like(xs)
    step = max(1, EXPERT_ELEMS // (D * Fd))
    for a in range(0, E, step):
        b = min(a + step, E)
        xa = xs[a:b]
        h = torch.bmm(xa, params["e_wi"][a:b].to(xs.dtype))
        g = torch.bmm(xa.float(), params["e_wg"][a:b].float())
        h = h * F.silu(g).to(h.dtype)
        ys[a:b] = torch.bmm(h, params["e_wo"][a:b].to(xs.dtype))
    return ys


def _dispatch(cfg, params, xf, eidx, gate, C, base=None):
    """Global sort-based dispatch into the [E, C, D] buffer, the experts,
    and the combine in JAX's update order.  Over ranks (``base``) the
    buffer holds this rank's kept slots (``dispatch_plan``)."""
    T, D = xf.shape
    E, k = cfg.n_experts, cfg.top_k
    order, e_s, t_s, keep, dest = dispatch_plan(cfg, eidx, C, base)
    rows = buffer_rows(C, T, base)
    g_s = gate.reshape(-1)[order]
    xs = drop_set_rows(torch.zeros((E * rows, D), dtype=xf.dtype,
                                   device=xf.device), dest, xf[t_s])
    ys = _experts(params, xs.view(E, rows, D))
    ys_flat = torch.cat([ys.reshape(E * rows, D),
                         torch.zeros((1, D), dtype=xf.dtype,
                                     device=xf.device)])
    contrib = ys_flat[dest] * (g_s * keep)[:, None].to(xf.dtype)   # sorted
    # each token's k slots in sorted order: its experts ascending
    at = torch.empty_like(order)
    at[order] = torch.arange(T * k, device=xf.device)       # slot -> sorted
    seq = torch.sort(at.view(T, k), dim=1).values
    out = torch.zeros((T, D), dtype=xf.dtype, device=xf.device)
    for j in range(k):
        out = out + contrib[seq[:, j]]
    return out
