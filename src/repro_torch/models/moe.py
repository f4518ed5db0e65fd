"""Mixture-of-Experts FFN with sort-based capacity dispatch (port of
``repro/models/moe.py``).

The router (float32) picks each token's top-k experts; the (token,
expert) slots are sorted by expert, ranked within their expert and
written into a fixed-capacity [E, C, D] buffer; slots past an expert's
capacity C are dropped.  The router adds the load-balance and z losses.
``params`` holds ``router`` [D, E] float32, ``e_wi``/``e_wg`` [E, D, F],
``e_wo`` [E, F, D] and, with shared experts, ``shared`` (a SwiGLU MLP of
width F * n_shared_experts), a dict or a ``ParameterDict``.

Every ``moe_impl`` takes the sort dispatch but ``"smap"`` under
``sharding/context.use_mesh`` (JAX's ``_dispatch_smap``, which runs only
where ``get_mesh()`` is set; JAX's trainer never sets it, so training
takes the sort dispatch there too, on any mesh).

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

Over the model axis the experts are cut (``e_wi``, ``e_wg``, ``e_wo``
hold the rank's E / m experts; the router is whole).  The sort dispatch
keeps its global plan and each model rank runs only its experts' kept
slots; the combine is all-reduced over model, so the drops are one
process's.  The shard_map dispatch (``_dispatch_smap``, under
``use_mesh``) is JAX's: each (data shard, expert shard) selects its own
tokens with a capacity per data shard and expert, C = max(8,
(int(Tl * k * cf) // E + 7) // 8 * 8), Tl the shard's tokens, in the
order ``lexsort((pos, e_loc))``, and the output is summed over model; it
falls back to the sort dispatch where E % m is not 0 (T % data is 0 by
construction: a rank holds its data shard's rows), as JAX does.
``smap_stacked`` is its one-process form, the data and expert shards
leading loop axes: the plain version the rank form is held against.

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
from repro_torch.sharding import tp
from repro_torch.sharding.context import current_dp, get_mesh

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
    else:
        # aux losses: load-balance (Switch) + router z-loss
        density = expert_counts(eidx.reshape(-1), E).float() / (T * k)
        aux = E * torch.sum(density * probs.mean(0))
        zloss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
        aux_loss = 0.01 * aux + 0.001 * zloss
        C, base = _capacity(cfg, T), None
    mesh = get_mesh()
    if (cfg.moe_impl == "smap" and mesh is not None
            and E % mesh.model.world == 0):
        out = _dispatch_smap(cfg, params, xf, eidx, gate, mesh.model.rank,
                             mesh.model.world)
    else:
        out = _dispatch(cfg, params, xf, eidx, gate, C, base)
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
    buffer holds this rank's kept slots (``dispatch_plan``); over the
    model axis, those of its experts, the combine summed over model."""
    T, D = xf.shape
    k = cfg.top_k
    order, e_s, t_s, keep, dest = dispatch_plan(cfg, eidx, C, base)
    rows = buffer_rows(C, T, base)
    g_s = gate.reshape(-1)[order]
    E_l = params["e_wi"].shape[0]
    cut = tp.cut(params["e_wi"]) is not None
    if cut:
        j = tp.rank_parts()[0]
        keep = keep & (e_s // E_l == j)
        dest = torch.where(keep, dest - j * E_l * rows, E_l * rows)
        xf, g_s = tp.copy(xf), tp.copy(g_s)
    out = _run(params, xf, order, t_s, keep, dest, g_s, E_l, rows, k)
    return tp.reduce(out) if cut else out


def _run(params, xf, order, t_s, keep, dest, g_s, E_l, rows, k):
    """The dispatch write into the [E_l * rows] buffer, the experts, and
    each token's k contributions added in the sorted order."""
    T, D = xf.shape
    xs = drop_set_rows(torch.zeros((E_l * rows, D), dtype=xf.dtype,
                                   device=xf.device), dest, xf[t_s])
    ys = _experts(params, xs.view(E_l, rows, D))
    ys_flat = torch.cat([ys.reshape(E_l * rows, D),
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


def _smap_shard(cfg, params, x_l, e_l, g_l, j, m):
    """One (data shard, expert shard j of m) of JAX's ``_dispatch_smap``
    body, before the sum over model: the shard's tokens ``x_l`` [Tl, D],
    their experts and gates; ``params`` holds the shard's E / m experts
    (or all E, of which it takes its own)."""
    Tl = x_l.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    E_l = E // m
    if params["e_wi"].shape[0] != E_l:
        params = {n: params[n][j * E_l:(j + 1) * E_l]
                  for n in ("e_wi", "e_wg", "e_wo")}
    C = max(8, (int(Tl * k * cfg.capacity_factor) // E + 7) // 8 * 8)
    e_flat = e_l.reshape(-1)
    mine = (e_flat >= j * E_l) & (e_flat < (j + 1) * E_l)
    e_loc = torch.where(mine, e_flat - j * E_l, E_l)
    order = torch.sort(e_loc, stable=True).indices      # lexsort((pos, e))
    e_s = e_loc[order]
    t_s = order // k
    counts = expert_counts(e_loc, E_l + 1)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(Tl * k, device=x_l.device) - starts[e_s]
    keep = (e_s < E_l) & (rank < C)
    dest = torch.where(keep, e_s * C + rank, E_l * C)
    g_s = g_l.reshape(-1)[order]
    return _run(params, x_l, order, t_s, keep, dest, g_s, E_l, C, k), keep


def _dispatch_smap(cfg, params, xf, eidx, gate, j, m):
    """JAX's shard_map dispatch on this rank: its data shard's tokens,
    its expert shard j of m; the output summed over model."""
    g = gate.to(xf.dtype)
    if tp.cut(params["e_wi"]) is not None:
        xf, g = tp.copy(xf), tp.copy(g)
    out, _ = _smap_shard(cfg, params, xf, eidx, g, j, m)
    return tp.reduce(out)


def smap_stacked(cfg, params, xf, eidx, gate, d: int, m: int):
    """``_dispatch_smap`` in one process over a (d data x m model) mesh:
    the d data shards of the tokens and the m expert shards as loop axes,
    each data shard's m partial outputs summed in model order.  Returns
    (the output [T, D], each shard's kept slots [d, m, Tl * k] in its
    sorted order)."""
    T, D = xf.shape
    Tl = T // d
    g = gate.to(xf.dtype)
    outs, keeps = [], []
    for i in range(d):
        rows = slice(i * Tl, (i + 1) * Tl)
        acc, ks = None, []
        for j in range(m):
            o, kp = _smap_shard(cfg, params, xf[rows], eidx[rows], g[rows],
                                j, m)
            acc = o if acc is None else acc + o
            ks.append(kp)
        outs.append(acc)
        keeps.append(torch.stack(ks))
    return torch.cat(outs), torch.stack(keeps)
