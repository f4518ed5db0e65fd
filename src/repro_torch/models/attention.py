"""Attention (port of ``repro/models/attention.py``): global and
sliding-window GQA and MLA for prefill (the blockwise online-softmax
"flash" formulation, its divide-and-conquer causal variant and the
materialised-scores oracle) and single-token decode over a
position-tagged ring-buffer KV cache.

Plain functions on tensors.  ``params`` is a block's mixer weights by the
JAX package's names, a dict or a ``ParameterDict``: GQA's ``wq``
[D, H*hd], ``wk`` and ``wv`` [D, Hkv*hd], ``wo`` [H*hd, D]; MLA's ``wq``
[D, H*(nope+rope)], ``w_dkv`` [D, r], ``w_kr`` [D, rope], ``w_uk``
[r, H*nope], ``w_uv`` [r, H*hv], ``wo`` [H*hv, D] and ``kv_norm``, the
latent's RMSNorm (1 + scale) tensor (JAX's ``{"scale"}`` leaf).  Query
head h = kv * G + g: each of the Hkv key heads serves G = H // Hkv
consecutive query heads.

MLA prefills decompressed (keys and values up-projected from the latent,
the rope key shared by every head) through the same attention functions,
with a value width (``v_head_dim``) other than the key width
(``qk_nope_dim + qk_rope_dim``); the naive oracle keeps JAX's reshape to
the key width, so it raises where the two differ, as JAX's does.  MLA
decodes in the absorbed form over the compressed cache {ckv, k_rope,
pos}: ``w_uk`` folded into the query and ``w_uv`` applied after the
weighted sum, with JAX's casts after each float32-accumulated product.

The products JAX takes with ``preferred_element_type=F32`` (the scores
and P @ V) are float32 matmuls of float32 copies of their inputs: a
product of two bf16 numbers is exact in float32, so the sums are JAX's up
to their order.  The casts to the inputs' dtype sit where JAX's do (P
before P @ V, each q block's output, the window's and the oracle's
outputs).

Where JAX scans the q blocks and, inside each, the kv blocks, this module
carries the q blocks as a tensor axis and loops over the kv blocks only:
each kv step updates the float32 running (max, sum, acc) of every q block
it reaches, in JAX's kv order and with JAX's arithmetic per element, so a
layer takes about nkv Python steps instead of nq x nkv (64 instead of
4096 at S = 32768 with 512-blocks).  A causal kv step leaves out the q
blocks it cannot reach, whose scores are all masked: after kv block 0,
which every query reaches, such a step leaves (max, sum, acc) exactly as
they were, so leaving it out changes no bit; and it masks only the q
blocks that see part of the kv block (JAX's mask is all true elsewhere).
The q blocks of one step go in chunks of at most ``SCORE_ELEMS`` scores,
which bounds the memory.
``_sliding_window`` gathers every q block's ``nwin`` kv blocks with one
``unfold`` of the left-padded k and v.

Over the model axis (``sharding/tp.py``; the weights cut by
``sharding/partition.cut_model``): ``wq``, ``wk``, ``wv`` (MLA: ``wq``,
``w_dkv``, ``w_uk``, ``w_uv``) are column-cut and ``wo`` row-cut, one
all-reduce a block.  Where the cut falls on query heads (H divisible by
the model size) a rank attends over its own heads: the keys and values
it needs come from its own columns where the key heads are cut too, and
otherwise (a cut inside a key head, as tiny mistral-nemo's 2 key heads
at 4 ranks) the key and value columns are gathered to whole heads and
the rank takes the heads its queries read (``_kv_sel``).  Where it does
not, every projection is gathered whole, the attention runs on every
head, and the output is split again for the row-cut ``wo``.  MLA's
latent (``w_dkv``) is gathered whole for its norm; its rope key
(``w_kr``) is whole.  The GQA decode cache holds the rank's key heads
(or every head), MLA's the whole latent.

Under ``sharding/context.use_mesh`` with ``cfg.decode_cache_hint`` (JAX's
``_seq_shard_ok``: the slots divide over the model axis and the batch
over data) a GQA cache is cut along its slots over the model axis
(``init_cache`` marks it): the token's slot is written on its owner
only (``_sharded_cache_update``), each rank scores its slots, and the
softmax's max and sum and the weighted partials are all-reduced.  MLA's
cache keeps only the data cut, as JAX's constraint does.  Left out:
``unroll``, a knob of XLA's cost analysis.

Under the sequence cut over data (``sharding/context.current_seq``, a
global batch of 1) each rank holds a block of the queries; GQA gathers
its keys and values, MLA its latent and rope key, from position 0 to
the rank's last (``fsdp.seq_prefix``), and the causal masks and the
windows take the queries' global positions.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (apply_rope, dot, normal, rmsnorm,
                                       rmsnorm_init)
from repro_torch.sharding import fsdp, tp
from repro_torch.sharding.context import current_model, current_seq

F32 = torch.float32
NEG_INF = -1e30
SCORE_ELEMS = 1 << 28      # float32 scores of one chunk of q blocks (1 GiB)


def _f32(t):
    return t if t.dtype == F32 else t.float()


def _blocks(what, n, blk):
    """n // blk, raising where JAX's reshape into blocks fails."""
    if n % blk:
        raise ValueError(f"{what} length {n} is not a multiple of its "
                         f"block {blk} (the JAX package's reshape fails too)")
    return n // blk


def _chunk(per_block: int) -> int:
    """q blocks a chunk, for ``per_block`` scores each."""
    return max(1, SCORE_ELEMS // max(per_block, 1))


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------
def attn_init(cfg, generator, device, kind: str = "gqa") -> dict:
    dt = cfg.param_dtype
    D = cfg.d_model
    if kind == "mla":
        H, r = cfg.n_heads, cfg.kv_lora_rank
        nope, rope, hv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        s = D ** -0.5
        return {
            "wq": normal((D, H * (nope + rope)), s, dt, generator, device),
            "w_dkv": normal((D, r), s, dt, generator, device),
            "w_kr": normal((D, rope), s, dt, generator, device),
            "w_uk": normal((r, H * nope), r ** -0.5, dt, generator, device),
            "w_uv": normal((r, H * hv), r ** -0.5, dt, generator, device),
            "wo": normal((H * hv, D), (H * hv) ** -0.5, dt, generator,
                         device),
            "kv_norm": rmsnorm_init(r, device),
        }
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    s = D ** -0.5
    return {
        "wq": normal((D, H * hd), s, dt, generator, device),
        "wk": normal((D, Hkv * hd), s, dt, generator, device),
        "wv": normal((D, Hkv * hd), s, dt, generator, device),
        "wo": normal((H * hd, D), (H * hd) ** -0.5, dt, generator, device),
    }


# ---------------------------------------------------------------------------
# Blockwise (flash-style) attention
# ---------------------------------------------------------------------------
def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_block: int = 512, kv_block: int = 512,
                    return_stats: bool = False, q_offset: int = 0):
    """q: [B,Sq,H,hdq]; k: [B,Skv,Hkv,hdq]; v: [B,Skv,Hkv,hdv] -> [B,Sq,H,hdv].

    ``causal`` assumes Skv == q_offset + Sq: the queries are positions
    q_offset .. q_offset + Sq - 1 of the keys' sequence (0 but under the
    sequence cut).  ``window`` > 0 restricts each query to the last
    ``window`` keys (implies causal).  With ``return_stats`` also
    returns the per-row online-softmax stats (m, l), [B, Sq, Hkv, G]
    float32 (used by the divide-and-conquer merge).
    """
    B, Sq, H, hdq = q.shape
    Skv, Hkv, hdv = k.shape[1], k.shape[2], v.shape[3]
    G = H // Hkv
    qb = min(q_block, Sq)
    kvb = min(kv_block, Skv)
    nq = _blocks("query", Sq, qb)
    scale = hdq ** -0.5
    # [B, Hkv, nq, qb, G, hd]: each key head's queries, blocked
    qh = _f32(q * scale).reshape(B, nq, qb, Hkv, G, hdq).permute(
        0, 3, 1, 2, 4, 5).contiguous()

    if window:
        assert Skv == q_offset + Sq
        return _sliding_window(qh, k, v, window, qb, q_offset)

    nkv = _blocks("key", Skv, kvb)
    kt = _f32(k).reshape(B, nkv, kvb, Hkv, hdq).permute(0, 3, 1, 4, 2)
    vh = v.reshape(B, nkv, kvb, Hkv, hdv).permute(0, 3, 1, 2, 4)
    step = _chunk(B * Hkv * qb * G * kvb)
    nchunk = -(-nq // step)
    ar_q = (q_offset + torch.arange(Sq, device=q.device)).view(nq, qb)
    ar_kv = torch.arange(kvb, device=q.device)
    # chunk c of the q blocks, [c * step, (c + 1) * step), holds the
    # running (max, sum, acc) of its blocks from lo on: each kv step hands
    # the blocks it reaches new tensors, so that nothing autograd saved is
    # written over, and a block no later kv step reaches is finished
    # (divided by its sum) and leaves the state
    state = {}                                  # c -> (lo, m, l, acc)
    outs, ms, ls = [], [], []

    def finish(c, upto):
        lo, mc, lc, ac = state.pop(c)
        k = min(upto - lo, mc.shape[2])
        outs.append((ac[:, :, :k] / torch.clamp(lc[:, :, :k], min=1e-30)
                     [..., None]).to(q.dtype))
        ms.append(mc[:, :, :k])
        ls.append(lc[:, :, :k])
        if k < mc.shape[2]:
            state[c] = (lo + k, mc[:, :, k:], lc[:, :, k:], ac[:, :, k:])

    for kj in range(nkv):
        kb = kt[:, :, kj]                                   # [B,Hkv,hd,kvb]
        vb = _f32(vh[:, :, kj])                             # [B,Hkv,kvb,hdv]
        # the q blocks this kv block reaches: all, or those whose last
        # position is at or past the block's first
        first = max(0, (kj * kvb - q_offset) // qb) if causal else 0
        for c in sorted(state):
            if state[c][0] < first:
                finish(c, first)
        for c in range(first // step, nchunk):
            a, b = max(first, c * step), min((c + 1) * step, nq)
            n = b - a
            s = torch.matmul(qh[:, :, a:b].reshape(B, Hkv, n * qb * G, hdq),
                             kb).view(B, Hkv, n, qb, G, kvb)
            # only the q blocks before the first that sees the whole kv
            # block have masked scores (the product's own output, which
            # its backward does not read)
            d = (min(b, -(-((kj + 1) * kvb - 1 - q_offset) // qb))
                 if causal else a)
            if d > a:
                mask = ar_q[a:d, :, None] >= (kj * kvb + ar_kv)
                s[:, :, :d - a].masked_fill_(~mask[:, :, None, :], NEG_INF)
            if c in state:
                _, m_old, l_old, acc_old = state[c]
            else:
                m_old = torch.full((B, Hkv, n, qb, G), NEG_INF, dtype=F32,
                                   device=q.device)
                l_old = torch.zeros_like(m_old)
                acc_old = torch.zeros((B, Hkv, n, qb, G, hdv), dtype=F32,
                                      device=q.device)
            m_new = torch.maximum(m_old, s.amax(dim=-1))
            alpha = torch.exp(m_old - m_new)
            p = torch.exp(s - m_new[..., None])
            del s
            l_new = l_old * alpha + p.sum(dim=-1)
            pv = torch.matmul(_f32(p.to(v.dtype)).view(B, Hkv, n * qb * G,
                                                       kvb), vb)
            del p
            acc_new = (acc_old * alpha[..., None]
                       + pv.view(B, Hkv, n, qb, G, hdv))
            state[c] = (a, m_new, l_new, acc_new)
            del m_old, l_old, acc_old
    for c in sorted(state):
        finish(c, nq)
    out = torch.cat(outs, dim=2)
    m, l = torch.cat(ms, dim=2), torch.cat(ls, dim=2)
    # [B, Hkv, nq, qb, G, hdv] -> [B, Sq, H, hdv]
    out = out.permute(0, 2, 3, 1, 4, 5).reshape(B, Sq, H, hdv)
    if return_stats:
        def rows(t):
            return t.permute(0, 2, 3, 1, 4).reshape(B, Sq, Hkv, G)
        return out, rows(m), rows(l)
    return out


def _merge_two(o1, m1, l1, o2, m2, l2, out_dtype):
    """Merge two normalised online-softmax partial results over the same
    queries but disjoint key sets."""
    m = torch.maximum(m1, m2)
    w1 = l1 * torch.exp(m1 - m)
    w2 = l2 * torch.exp(m2 - m)
    denom = torch.clamp(w1 + w2, min=1e-30)
    B, S, H, _ = o1.shape            # stats are [B, S, Hkv, G]
    w1e = w1.reshape(B, S, H)[..., None]
    w2e = w2.reshape(B, S, H)[..., None]
    de = denom.reshape(B, S, H)[..., None]
    o = (_f32(o1) * w1e + _f32(o2) * w2e) / de
    return o.to(out_dtype), m, w1 + w2


def causal_divide_conquer(q, k, v, *, q_block: int = 512, leaf: int = 2048,
                          return_stats: bool = False):
    """Exact causal attention via causal(S) = [causal(front half)] ++
    [merge(causal(back half), rect(back q x front kv))]: the strictly
    upper half of the score matrix is never computed.  The recursion
    bottoms out at ``leaf``, where the masked flash path runs.  Keys
    longer than the queries (the sequence cut: the queries are the last
    Sq positions) take the same merge: causal(own block) with
    rect(q x the keys before it)."""
    S = q.shape[1]
    off = k.shape[1] - S
    if off:
        diag = causal_divide_conquer(q, k[:, off:], v[:, off:],
                                     q_block=q_block, leaf=leaf,
                                     return_stats=True)
        rect = flash_attention(q, k[:, :off], v[:, :off], causal=False,
                               q_block=q_block, kv_block=q_block,
                               return_stats=True)
        o, m, l = _merge_two(*diag, *rect, q.dtype)
        return (o, m, l) if return_stats else o
    if S <= leaf:
        return flash_attention(q, k, v, causal=True, q_block=q_block,
                               kv_block=q_block, return_stats=return_stats)
    h = S // 2
    front = causal_divide_conquer(q[:, :h], k[:, :h], v[:, :h],
                                  q_block=q_block, leaf=leaf,
                                  return_stats=True)
    back_diag = causal_divide_conquer(q[:, h:], k[:, h:], v[:, h:],
                                      q_block=q_block, leaf=leaf,
                                      return_stats=True)
    back_rect = flash_attention(q[:, h:], k[:, :h], v[:, :h], causal=False,
                                q_block=q_block, kv_block=q_block,
                                return_stats=True)
    o_b, m_b, l_b = _merge_two(*back_diag, *back_rect, q.dtype)
    o_f, m_f, l_f = front
    out = torch.cat([o_f, o_b], dim=1)
    if return_stats:
        return out, torch.cat([m_f, m_b], 1), torch.cat([l_f, l_b], 1)
    return out


def _sliding_window(qh, k, v, window: int, qb: int, q_offset: int = 0):
    """Local attention: q block qi takes the nwin kv blocks covering
    [qi*qb - window + 1, (qi+1)*qb) and masks exactly.  O(S * window).
    ``qh``: the scaled queries, float32 [B, Hkv, nq, qb, G, hd], at
    positions ``q_offset`` on of the keys' sequence; only the keys a
    window reaches are read."""
    B, Hkv, nq, _, G, hdq = qh.shape
    hdv = v.shape[3]
    S = nq * qb
    nwin = (window + qb - 1) // qb + 1           # kv blocks per q block
    pad = (nwin - 1) * qb
    L = nwin * qb
    have = min(pad, q_offset)                    # real keys before q 0
    k, v = k[:, q_offset - have:], v[:, q_offset - have:]
    pad -= have
    # the windows of every q block: [B, Hkv, nq, hd, L] and [.., L, hdv]
    kw = F.pad(_f32(k), (0, 0, 0, 0, pad, 0)).unfold(1, L, qb).permute(
        0, 2, 1, 3, 4)
    vw = F.pad(v, (0, 0, 0, 0, pad, 0)).unfold(1, L, qb).permute(
        0, 2, 1, 4, 3)
    q_pos = (q_offset + torch.arange(S, device=qh.device)).view(nq, qb)
    kv_pos = (q_pos[:, :1] - (pad + have)
              + torch.arange(L, device=qh.device))        # [nq, L] logical
    out = torch.empty((B, Hkv, nq, qb, G, hdv), dtype=k.dtype,
                      device=qh.device)
    step = _chunk(B * Hkv * qb * G * L)
    for a in range(0, nq, step):
        b = min(a + step, nq)
        n = b - a
        s = torch.matmul(qh[:, :, a:b].reshape(B, Hkv, n, qb * G, hdq),
                         kw[:, :, a:b]).view(B, Hkv, n, qb, G, L)
        qp, kp = q_pos[a:b, :, None], kv_pos[a:b, None, :]
        mask = (qp >= kp) & (qp - kp < window) & (kp >= 0)   # [n, qb, L]
        s = torch.where(mask[:, :, None, :], s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        del s
        l = p.sum(dim=-1)
        pv = torch.matmul(_f32(p.to(v.dtype)).view(B, Hkv, n, qb * G, L),
                          _f32(vw[:, :, a:b]))
        del p
        out[:, :, a:b] = (pv.view(B, Hkv, n, qb, G, hdv)
                          / torch.clamp(l, min=1e-30)[..., None]).to(k.dtype)
    return out.permute(0, 2, 3, 1, 4, 5).reshape(B, S, Hkv * G, hdv)


# ---------------------------------------------------------------------------
# GQA block (prefill)
# ---------------------------------------------------------------------------
def _qkv(cfg, params, x, positions, T, plan=None):
    """q, k, v of a GQA block, rope applied: every head, or with ``plan``
    (``_gqa_local``) this rank's query heads and the key heads they
    read."""
    B = x.shape[0]
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    if plan is not None:
        _, H_l, kv = plan
        xc = tp.copy(x)
        q = dot(xc, params["wq"]).reshape(B, T, H_l, hd)
        k, v = (_kv_local(x, xc, params[n], B, T, Hkv, hd, kv)
                for n in ("wk", "wv"))
    elif any(tp.cut(params[n]) is not None for n in ("wq", "wk", "wv")):
        q = _proj(x, params["wq"]).reshape(B, T, H, hd)
        k = _proj(x, params["wk"]).reshape(B, T, Hkv, hd)
        v = _proj(x, params["wv"]).reshape(B, T, Hkv, hd)
    else:
        q = dot(x, params["wq"]).reshape(B, T, H, hd)
        k = dot(x, params["wk"]).reshape(B, T, Hkv, hd)
        v = dot(x, params["wv"]).reshape(B, T, Hkv, hd)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _proj(x, w):
    """``dot(x, w)`` whole on every rank: a column-cut weight's slices
    gathered."""
    if tp.cut(w) is None:
        return dot(x, w)
    return tp.gather(dot(tp.copy(x), w), -1)


def _kv_local(x, xc, w, B, T, Hkv, hd, kv):
    """The key (or value) heads this rank's queries read: its own
    columns (``kv`` None), or those heads of the whole projection."""
    if kv is None:
        return dot(xc, w).reshape(B, T, -1, hd)
    whole = (tp.gather(dot(xc, w), -1) if tp.cut(w) is not None
             else dot(x, w))
    return tp.copy(whole).reshape(B, T, Hkv, hd)[:, :, kv]


def _kv_sel(h0: int, n: int, per: int):
    """The key heads that query heads h0 .. h0 + n - 1 read (each key
    head serves ``per`` consecutive query heads), one entry for each
    group of queries that shares one; where the queries split a key
    head's group unevenly, one entry a query."""
    idx = [(h0 + i) // per for i in range(n)]
    uniq = sorted(set(idx))
    if n % len(uniq) == 0 and all(idx.count(u) == n // len(uniq)
                                  for u in uniq):
        return uniq
    return idx


def _gqa_local(cfg, params):
    """(h0, H_l, the key heads to take or None) where the model axis cuts
    the query heads evenly (this rank runs heads h0 .. h0 + H_l - 1), or
    None: the block runs every head."""
    if tp.cut(params["wq"]) is None:
        return None
    r, m = tp.rank_parts()
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    if H % m:
        return None
    H_l = H // m
    aligned = tp.cut(params["wk"]) is not None and Hkv % m == 0
    return r * H_l, H_l, None if aligned else _kv_sel(r * H_l, H_l,
                                                      H // Hkv)


def _attend(cfg, q, k, v, window: int = 0):
    """Causal attention by ``cfg``'s choice: the oracle, the
    divide-and-conquer path (global layers) or the flash path.  Under
    the sequence cut ``k`` and ``v`` run from position 0 to the queries'
    last (``fsdp.seq_prefix``), and the blocks are JAX's, of the global
    length, where they divide the rank's block (else the largest length
    that divides both: the blocking changes the order of the sums
    only)."""
    qb, kvb = cfg.attn_q_block, cfg.attn_kv_block
    g = current_seq()
    off = k.shape[1] - q.shape[1]
    if g is not None:
        S, S_all = q.shape[1], q.shape[1] * g.world
        _blocks("query", S_all, min(qb, S_all))
        _blocks("key", S_all, min(kvb, S_all))
        qb, kvb = (fsdp.local_chunk(qb, S_all, S),
                   fsdp.local_chunk(kvb, S_all, S))
    if cfg.attn_impl == "naive":
        return _naive_attention(q, k, v, window)
    if cfg.attn_block_skip and not window:
        return causal_divide_conquer(q, k, v, q_block=qb,
                                     leaf=2 * cfg.attn_q_block)
    return flash_attention(q, k, v, causal=True, window=window,
                           q_block=qb, kv_block=kvb, q_offset=off)


def gqa_apply(cfg, params, x, positions, *, window: int = 0):
    B, S, _ = x.shape
    plan = _gqa_local(cfg, params)
    q, k, v = _qkv(cfg, params, x, positions, S, plan)
    k, v = fsdp.seq_prefix(k), fsdp.seq_prefix(v)
    o = _attend(cfg, q, k, v, window)
    return tp.row(o.reshape(B, S, -1), params["wo"], plan is not None)


def _naive_attention(q, k, v, window: int = 0):
    """Materialised-scores oracle (tests and tiny shapes only)."""
    B, S, H, hd = q.shape
    Hkv, Skv = k.shape[2], k.shape[1]
    G = H // Hkv
    qg = q.reshape(B, S, Hkv, G, hd)
    s = torch.einsum("bqhgd,bkhd->bqhgk", _f32(qg), _f32(k)) * hd ** -0.5
    qp = Skv - S + torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(Skv, device=q.device)[None, :]
    mask = qp >= kp
    if window:
        mask &= (qp - kp) < window
    s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqhgk,bkhd->bqhgd", _f32(p.to(v.dtype)),
                     _f32(v)).to(q.dtype)
    return o.reshape(B, S, H, hd)


# ---------------------------------------------------------------------------
# GQA decode (single token, ring-buffer cache)
# ---------------------------------------------------------------------------
def gqa_cache_init(cfg, batch: int, seq_len: int, device, *,
                   window: int = 0, heads=None, seq_parts: int = 1) -> dict:
    """``cap = min(window, seq_len)`` slots (``seq_len`` without a
    window), each tagged with the position it holds (-1: empty); of
    ``heads`` key heads (all by default), or of cap / ``seq_parts`` slots
    marked as a cut along the slots (``use_mesh`` and the hint)."""
    cap = min(window, seq_len) if window else seq_len
    Hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    Hkv = Hkv if heads is None else heads
    dt = cfg.param_dtype
    c = {"k": torch.zeros((batch, cap // seq_parts, Hkv, hd), dtype=dt,
                          device=device),
         "v": torch.zeros((batch, cap // seq_parts, Hkv, hd), dtype=dt,
                          device=device),
         "pos": torch.full((batch, cap // seq_parts), -1, dtype=torch.int32,
                           device=device)}
    return _mark_seq(c, seq_parts)


def _mark_seq(c, parts):
    if parts > 1:
        for t in c.values():
            tp.mark(t, 1, parts)
    return c


def gqa_cache_layout(cfg, seq_len: int, window: int, r: int, m: int,
                     seq: bool) -> dict:
    """``gqa_cache_init``'s keywords for model index ``r`` of ``m``:
    the slots cut where ``seq`` (the hint under ``use_mesh``) and they
    divide, else the key heads this rank's queries read (``_gqa_local``
    of a model cut by ``cut_model``), else every head."""
    cap = min(window, seq_len) if window else seq_len
    if m == 1:
        return {}
    if seq and cap % m == 0 and cap >= m:
        return {"seq_parts": m}
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    if (H * hd) % m or H % m:
        return {}
    H_l = H // m
    if (Hkv * hd) % m == 0 and Hkv % m == 0:
        return {"heads": Hkv // m}
    return {"heads": len(_kv_sel(r * H_l, H_l, H // Hkv))}


def gqa_decode(cfg, params, x, pos, cache, *, window: int = 0):
    """x: [B, 1, D]; pos: [B] current position.  Returns (out [B,1,D], the
    new cache): the token's k and v go to slot pos % cap of each row (one
    target a row), then it attends over the slots whose tag is at most
    pos (and, with a window, within it)."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    seq = tp.cut(cache["k"]) is not None
    plan = None if seq else _gqa_local(cfg, params)
    q, k, v = _qkv(cfg, params, x, pos[:, None], 1, plan)
    H, Hkv = q.shape[2], k.shape[2]
    G = H // Hkv
    pos = pos.to(torch.int32)
    if seq:
        k_cache, v_cache, pos_buf = _sharded_cache_update(
            cache, k[:, 0], v[:, 0], pos)
    else:
        cap = cache["k"].shape[1]
        slot = (pos % cap).long()
        bidx = torch.arange(B, device=x.device)
        k_cache = cache["k"].index_put((bidx, slot), k[:, 0])
        v_cache = cache["v"].index_put((bidx, slot), v[:, 0])
        pos_buf = cache["pos"].index_put((bidx, slot), pos)
    qg = q.reshape(B, Hkv, G, hd) * hd ** -0.5
    s = torch.einsum("bhgd,bkhd->bhgk", _f32(qg), _f32(k_cache))
    valid = (pos_buf >= 0) & (pos_buf <= pos[:, None])
    if window:
        valid &= (pos[:, None] - pos_buf) < window
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    if seq:
        o = _seq_softmax_pv(s, v_cache, x.dtype)
    else:
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgk,bkhd->bhgd", _f32(p.to(v.dtype)),
                         _f32(v_cache)).to(x.dtype)
    out = tp.row(o.reshape(B, 1, H * hd), params["wo"], plan is not None)
    return out, _mark_seq({"k": k_cache, "v": v_cache, "pos": pos_buf},
                          cache["k"].model_parts if seq else 1)


def _sharded_cache_update(cache, k_new, v_new, pos):
    """JAX's ``_sharded_cache_update``: the token's slot written only on
    the model index that holds it (this rank holds slots r * capl ..
    (r + 1) * capl - 1)."""
    r, m = tp.rank_parts()
    capl = cache["k"].shape[1]
    slot = (pos % (capl * m)).long()
    local = slot - r * capl
    mine = (local >= 0) & (local < capl)
    li = torch.where(mine, local, 0)
    bidx = torch.arange(k_new.shape[0], device=k_new.device)
    out = []
    for t, new in ((cache["k"], k_new), (cache["v"], v_new),
                   (cache["pos"], pos)):
        old = t[bidx, li]
        keep = mine.view((-1,) + (1,) * (new.dim() - 1))
        out.append(t.index_put((bidx, li), torch.where(keep, new, old)))
    return out


def _seq_softmax_pv(s, v_cache, dtype):
    """softmax(s) @ v over the slots of every model index: each rank's
    scores ``s`` [B, Hkv, G, capl] and slots; the max, the sum and the
    weighted partials all-reduced over model."""
    g = current_model()
    mx = g.max_(s.amax(dim=-1, keepdim=True).contiguous())
    p = torch.exp(s - mx)
    den = g.sum_(p.sum(dim=-1).contiguous())
    acc = g.sum_(torch.einsum("bhgk,bkhd->bhgd", _f32(p.to(v_cache.dtype)),
                              _f32(v_cache)).contiguous())
    return (acc / den[..., None]).to(dtype)


# ---------------------------------------------------------------------------
# MLA (prefill decompressed; decode absorbed over the compressed cache)
# ---------------------------------------------------------------------------
def _mla_local(cfg, params):
    """The query heads this rank runs, H / m, where the model axis cuts
    MLA's heads evenly (``wq``, ``w_uk``, ``w_uv`` and ``wo``); None:
    every head."""
    if any(tp.cut(params[n]) is None for n in ("wq", "w_uk", "w_uv", "wo")):
        return None
    _, m = tp.rank_parts()
    return None if cfg.n_heads % m else cfg.n_heads // m


def mla_apply(cfg, params, x, positions):
    B, S, _ = x.shape
    H = cfg.n_heads
    nope, rope_d, hv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    H_l = _mla_local(cfg, params)
    if H_l is None:
        q = _proj(x, params["wq"]).reshape(B, S, H, nope + rope_d)
    else:
        q = dot(tp.copy(x), params["wq"]).reshape(B, S, H_l, nope + rope_d)
    Hh = q.shape[2]
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    ckv = rmsnorm(params["kv_norm"], _proj(x, params["w_dkv"]),
                  cfg.norm_eps)
    k_rope = apply_rope(dot(x, params["w_kr"])[..., None, :], positions,
                        cfg.rope_theta)                       # [B,S,1,rope]
    # the sequence cut: the latent and the rope key from position 0 on
    ckv, k_rope = fsdp.seq_prefix(ckv), fsdp.seq_prefix(k_rope)
    Skv = ckv.shape[1]
    if H_l is None:
        k_nope = _proj(ckv, params["w_uk"]).reshape(B, Skv, H, nope)
        v = _proj(ckv, params["w_uv"]).reshape(B, Skv, H, hv)
    else:
        ckv, k_rope = tp.copy(ckv), tp.copy(k_rope)
        k_nope = dot(ckv, params["w_uk"]).reshape(B, Skv, H_l, nope)
        v = dot(ckv, params["w_uv"]).reshape(B, Skv, H_l, hv)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    kf = torch.cat([k_nope, k_rope.expand(B, Skv, Hh, rope_d)], dim=-1)
    o = _attend(cfg, qf, kf, v)
    return tp.row(o.reshape(B, S, Hh * hv), params["wo"], H_l is not None)


def mla_cache_init(cfg, batch: int, seq_len: int, device) -> dict:
    dt = cfg.param_dtype
    return {
        "ckv": torch.zeros((batch, seq_len, cfg.kv_lora_rank), dtype=dt,
                           device=device),
        "k_rope": torch.zeros((batch, seq_len, cfg.qk_rope_dim), dtype=dt,
                              device=device),
        "pos": torch.full((batch, seq_len), -1, dtype=torch.int32,
                          device=device),
    }


def mla_decode(cfg, params, x, pos, cache):
    """Absorbed-matrix decode over the compressed cache.  x: [B, 1, D];
    pos: [B].  The token's latent and rope key go to slot pos % cap of
    each row (one target a row); the products JAX takes with
    ``preferred_element_type=F32`` are float32 matmuls of float32 copies,
    each cast to x's dtype where JAX casts.  Over the model axis a rank
    absorbs and attends with its own heads (``_mla_local``), or with
    every head, the cut weights gathered whole."""
    B = x.shape[0]
    r, nope, rope_d, hv = (cfg.kv_lora_rank, cfg.qk_nope_dim,
                           cfg.qk_rope_dim, cfg.v_head_dim)
    H_l = _mla_local(cfg, params)
    if H_l is None:
        params = {n: tp.whole(w) if torch.is_tensor(w) else w
                  for n, w in params.items()}
    H = cfg.n_heads if H_l is None else H_l
    q = dot(x, params["wq"]).reshape(B, H, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    ckv_t = rmsnorm(params["kv_norm"], _proj(x, params["w_dkv"])[:, 0],
                    cfg.norm_eps)
    k_rope_t = apply_rope(dot(x, params["w_kr"])[:, :, None, :],
                          pos[:, None], cfg.rope_theta)[:, 0, 0]
    cap = cache["ckv"].shape[1]
    pos = pos.to(torch.int32)
    slot = (pos % cap).long()
    bidx = torch.arange(B, device=x.device)
    ckv_c = cache["ckv"].index_put((bidx, slot), ckv_t)
    kr_c = cache["k_rope"].index_put((bidx, slot), k_rope_t)
    pos_buf = cache["pos"].index_put((bidx, slot), pos)
    # absorb W_uk into q: q_abs[b,h,r] = q_nope[b,h,n] . W_uk[r, h, n]
    w_uk = params["w_uk"].reshape(r, H, nope)
    q_abs = torch.einsum("bhn,rhn->bhr", _f32(q_nope),
                         _f32(w_uk)).to(x.dtype)
    scale = (nope + rope_d) ** -0.5
    s = (torch.einsum("bhr,bsr->bhs", _f32(q_abs), _f32(ckv_c))
         + torch.einsum("bhd,bsd->bhs", _f32(q_rope), _f32(kr_c))) * scale
    valid = (pos_buf >= 0) & (pos_buf <= pos[:, None])
    s = torch.where(valid[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhs,bsr->bhr", _f32(p.to(x.dtype)),
                       _f32(ckv_c)).to(x.dtype)
    w_uv = params["w_uv"].reshape(r, H, hv)
    o = torch.einsum("bhr,rhv->bhv", _f32(ctx), _f32(w_uv)).to(x.dtype)
    out = tp.row(o.reshape(B, 1, H * hv), params["wo"], H_l is not None)
    return out, {"ckv": ckv_c, "k_rope": kr_c, "pos": pos_buf}
