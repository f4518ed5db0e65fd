"""State-space blocks, Mamba-1 and Mamba-2 (port of
``repro/models/ssm.py``).

Plain functions on tensors.  ``p`` is a block's parameters by the JAX
package's names, a dict or a ``ParameterDict``: Mamba-1's ``in_x``,
``in_z``, ``conv_w``, ``conv_b``, ``x_proj``, ``dt_proj``, ``dt_bias``,
``A_log``, ``ssm_D``, ``out_proj``; Mamba-2's ``in_z``, ``in_x``, ``in_B``,
``in_C``, ``in_dt``, the three convs' ``conv_{x,B,C}{w,b}``, ``dt_bias``,
``A_log``, ``ssm_D``, ``norm`` (the gated RMSNorm's (1 + scale) tensor,
JAX's ``{"scale"}`` leaf) and ``out_proj``.

``mamba1_apply`` has the JAX package's three scans, chosen by
``cfg.ssm_impl``:

  * ``"jnp"``: the chunked scan.  Within each chunk of ``cfg.ssm_chunk``
    steps an inclusive scan of the (a, b) pairs (log-step, where JAX uses
    ``associative_scan``), then a loop over chunks carries the state.  It
    materialises [B, S, di, N] intermediates.
  * ``"pallas"``: the fused scan, ``kernels/mamba_scan.py`` (the CUDA
    kernel for CUDA tensors, its plain version on the CPU).
  * ``"stub"``: the analysis placeholder with the kernel's I/O shapes.

``mamba2_apply`` is the SSD in matmul form, chunks of
``min(cfg.ssm_chunk, S)`` steps; it ignores ``ssm_impl``, as JAX's does.
JAX scans the chunks one by one (``_ssd_chunk``); here the chunks are a
tensor axis.  Of a chunk's terms only the state it hands on reads the
carry, ``h_out = exp(cum_T) * h_in + dh``: the intra-chunk output, ``dh``
and the decay are computed for many chunks at once, the carry runs as a
loop of two operations a chunk on [B, H, P, N], and the inter-chunk
output follows for all chunks from the stacked states that enter them.
The arithmetic per element is JAX's.  B/C group g serves heads
``g*hg .. (g+1)*hg - 1`` (JAX's ``jnp.repeat``, element by element): the
heads are viewed as [G, hg] rather than the groups repeated.  The
[n, T, T, H] float32 terms of one pass hold at most ``SSD_ELEMS``
elements.

Decode is the single-step recurrence over the carried state: (conv, ssm)
for Mamba-1, (conv_x, conv_B, conv_C, ssm) for Mamba-2.

Over the model axis (``sharding/tp.py``) the channels are cut: Mamba-1's
``in_x``, ``in_z``, the conv, ``dt_proj``, ``dt_bias``, ``A_log`` and
``ssm_D`` hold the rank's channels, and ``x_proj`` and ``out_proj`` are
row-cut (``dbc`` all-reduced before its split into dt, B and C; the
output all-reduced).  Mamba-2's ``in_x``, ``in_z`` and the x conv hold
the rank's heads' channels; ``in_B``, ``in_C`` and their convs are cut on
G * N, and B and C are gathered whole and the rank takes the groups its
heads read (tiny zamba2 at 4 ranks holds half a group); ``in_dt``, the
2-D ``dt_bias``, ``A_log`` and the gated norm's scale are whole, of which
a rank takes its heads (channels), while the 1-D ``dt_bias`` and
``ssm_D`` are cut; the gated RMSNorm's sum of squares is all-reduced.
Where the model axis cuts d_inner but not Mamba-2's heads, the cut
weights are gathered whole and the block runs every head.  A decode
cache holds the rank's channels (``cache_parts``).

Under the sequence cut over data (``sharding/context.current_seq``, a
global batch of 1) a rank holds a block of the sequence: the causal
convs take the k - 1 positions before it from the rank before
(``fsdp.halo``), and each scan runs its block from a zero state, then
again from the state the lower ranks hand on (``fsdp.carry_in`` of each
rank's total decay and end state).  The chunk is JAX's, of the global
length, where it divides the rank's block, else the largest length that
divides both: every chunk length gives the same function.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.models.layers import normal, rmsnorm, rmsnorm_init
from repro_torch.sharding import fsdp, tp
from repro_torch.sharding.context import current_seq

F32 = torch.float32
KERNEL_BLOCK = 128     # the Pallas kernel's default d_block and seq_chunk
SSD_ELEMS = 1 << 28    # float32 [n, T, T, H] elements of one SSD pass (1 GiB)


def _causal_conv(x, w, b):
    """Depthwise causal conv.  x: [B,S,C]; w: [k,C]; b: [C].  Under the
    sequence cut the k - 1 positions before the rank's block come from
    the rank before it (``fsdp.halo``)."""
    k = w.shape[0]
    B, S, C = x.shape
    left = fsdp.halo(x, k - 1)
    if left is None:
        left = x.new_zeros((B, k - 1, C))
    x = torch.cat([left, x], dim=1)
    out = torch.zeros((B, S, C), dtype=F32, device=x.device)
    for j in range(k):
        out += x[:, j:j + S].float() * w[j].float()
    return (out + b.float()).to(x.dtype)


def _block_carry(decay, end, first):
    """The state entering this rank's block of the sequence: ``first``
    (a zero state) with no sequence cut; else the block's end state from
    ``first`` (``end(c, h)``: the state after chunk c from h) and its
    total decay (the product of ``decay[:, c]``, each chunk's), combined
    with the lower ranks' (``fsdp.carry_in``)."""
    if current_seq() is None:
        return first
    e, a = first, None
    for c in range(decay.shape[1]):
        e = end(c, e)
        a = decay[:, c] if a is None else a * decay[:, c]
    return fsdp.carry_in(a, e)


def _conv_step(conv_state, x_t, w, b):
    """One decode step of the causal conv.  conv_state: [B,k-1,C] (last k-1
    inputs); x_t: [B,C].  Returns (y_t, new_state)."""
    window = torch.cat([conv_state, x_t[:, None]], dim=1)        # [B,k,C]
    y = torch.einsum("bkc,kc->bc", window.float(), w.float()) + b.float()
    return y.to(x_t.dtype), window[:, 1:]


# ===========================================================================
# Mamba-1
# ===========================================================================
def mamba1_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    dt_rank = max(1, cfg.d_model // 16)
    return d_inner, dt_rank


def mamba1_init(cfg, generator, device) -> dict:
    dt = cfg.param_dtype
    D, N, k = cfg.d_model, cfg.ssm_state, cfg.ssm_conv
    di, R = mamba1_dims(cfg)
    s = D ** -0.5
    a = torch.arange(1, N + 1, dtype=F32, device=device)[None, :].repeat(
        di, 1)
    return {
        "in_x": normal((D, di), s, dt, generator, device),
        "in_z": normal((D, di), s, dt, generator, device),
        "conv_w": normal((k, di), 0.2, dt, generator, device),
        "conv_b": torch.zeros((di,), dtype=dt, device=device),
        "x_proj": normal((di, R + 2 * N), di ** -0.5, dt, generator, device),
        "dt_proj": normal((R, di), R ** -0.5, dt, generator, device),
        "dt_bias": torch.full((di,), -4.6, dtype=F32, device=device),
        "A_log": torch.log(a),                       # [di, N] fp32
        "ssm_D": torch.ones((di,), dtype=F32, device=device),
        "out_proj": normal((di, D), di ** -0.5, dt, generator, device),
    }


def _scan_chunks(a, b):
    """Inclusive scan along axis 2 of [B, nchunk, T, di, N] pairs under
    (a_l, b_l) . (a_r, b_r) = (a_l a_r, a_r b_l + b_r): log2(T) steps."""
    a_cum, b_scan = a, b
    T = a.shape[2]
    off = 1
    while off < T:
        # new tensors a step: the products' backward reads the old ones
        ar, br = a_cum[:, :, off:], b_scan[:, :, off:]
        new_b = ar * b_scan[:, :, :-off] + br
        new_a = ar * a_cum[:, :, :-off]
        b_scan = torch.cat([b_scan[:, :, :off], new_b], dim=2)
        a_cum = torch.cat([a_cum[:, :, :off], new_a], dim=2)
        off *= 2
    return a_cum, b_scan


def _check_shapes(cfg, S, di):
    """The JAX function's shape rules: the Pallas kernel asserts
    S % min(128, S) == 0 and di % min(128, di) == 0; the chunked scan
    reshapes S into chunks of min(ssm_chunk, S)."""
    if cfg.ssm_impl == "pallas":
        if S % min(KERNEL_BLOCK, S) or di % min(KERNEL_BLOCK, di):
            raise ValueError(
                f"mamba1_apply(ssm_impl='pallas'): S={S} and d_inner={di} "
                f"must be multiples of {KERNEL_BLOCK} (or at most it), as "
                f"the JAX kernel asserts")
    elif cfg.ssm_impl == "jnp":
        T = min(cfg.ssm_chunk, S)
        if S % T:
            raise ValueError(
                f"mamba1_apply(ssm_impl='jnp'): S={S} is not a multiple of "
                f"the scan chunk {T}")
    elif cfg.ssm_impl != "stub":
        raise ValueError(f"unknown ssm_impl {cfg.ssm_impl!r}")


def _mamba1_local(p):
    """Mamba-1's weights for this rank's channels: the per-channel ones
    the rules leave whole split to its slice."""
    out = dict(p.items())
    for n, d in (("conv_w", 1), ("conv_b", 0), ("dt_proj", 1),
                 ("dt_bias", 0), ("A_log", 0), ("ssm_D", 0)):
        out[n] = tp.local(p[n], d)
    return out


def _finish(p, y, x, z, u):
    y = y + p["ssm_D"] * x.float()
    y = y * F.silu(z.float())
    out = y.to(u.dtype) @ p["out_proj"]
    return out if tp.cut(p["out_proj"]) is None else tp.reduce(out)


def mamba1_apply(cfg, p, u):
    """u: [B,S,D] -> [B,S,D] (full-sequence / prefill path).  Under the
    sequence cut (``ssm_impl="jnp"``) each rank scans its block from a
    zero state, and the state entering it comes from the lower ranks'
    (total decay, end state) pairs."""
    B, S, D = u.shape
    N = cfg.ssm_state
    di, R = mamba1_dims(cfg)
    g = current_seq()
    S_all = S if g is None else S * g.world
    _check_shapes(cfg, S_all, di)
    cut = tp.cut(p["in_x"]) is not None
    if cut:
        u = tp.copy(u)
        di = p["in_x"].shape[1]
        p = _mamba1_local(p)
    x = u @ p["in_x"]
    z = u @ p["in_z"]
    x = _causal_conv(x, p["conv_w"], p["conv_b"])
    x = F.silu(x.float()).to(x.dtype)
    dbc = x @ p["x_proj"]
    if cut:
        dbc = tp.copy(tp.reduce(dbc))
    dt_in, B_ssm, C_ssm = torch.split(dbc, [R, N, N], dim=-1)
    dt = F.softplus((dt_in @ p["dt_proj"]).float() + p["dt_bias"])  # [B,S,di]
    A = -torch.exp(p["A_log"])                                        # [di,N]
    if cfg.ssm_impl == "pallas":
        # the fused scan: device memory holds only its I/O (x, dt, B, C, y)
        y = mamba_scan(x, dt, B_ssm.contiguous(), C_ssm.contiguous(), A)
        return _finish(p, y.float(), x, z, u)
    if cfg.ssm_impl == "stub":
        y = (x.float() * (1.0 + dt) + B_ssm.sum(-1, keepdim=True)
             + C_ssm.sum(-1, keepdim=True))
        return _finish(p, y, x, z, u)
    T = fsdp.local_chunk(cfg.ssm_chunk, S_all, S)
    nchunk = S // T
    a = torch.exp(dt[..., None] * A)                                  # [B,S,di,N]
    b = (dt * x.float())[..., None] * B_ssm.float()[:, :, None, :]
    sd = getattr(torch, cfg.ssm_scan_dtype)
    a_cum, b_scan = _scan_chunks(a.to(sd).reshape(B, nchunk, T, di, N),
                                 b.to(sd).reshape(B, nchunk, T, di, N))
    del a, b
    C_c = C_ssm.to(sd).reshape(B, nchunk, T, N)
    h = _block_carry(
        a_cum[:, :, -1].float(),
        lambda c, e: (a_cum[:, c, -1] * e.to(sd) + b_scan[:, c, -1]).float(),
        torch.zeros((B, di, N), dtype=F32, device=u.device))
    h_in = []
    for c in range(nchunk):
        h_in.append(h)
        h = (a_cum[:, c, -1] * h.to(sd) + b_scan[:, c, -1]).float()
    hs = a_cum * torch.stack(h_in, 1)[:, :, None].to(sd) + b_scan
    y = torch.einsum("bctdn,bctn->bctd", hs.float(), C_c.float())
    return _finish(p, y.reshape(B, S, di), x, z, u)


def mamba1_cache_init(cfg, batch: int, device, parts: int = 1) -> dict:
    """The decode cache; of d_inner / ``parts`` channels
    (``cache_parts``)."""
    di = mamba1_dims(cfg)[0] // parts
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di),
                            dtype=cfg.param_dtype, device=device),
        "ssm": torch.zeros((batch, di, cfg.ssm_state), dtype=F32,
                           device=device),
    }


def mamba1_decode(cfg, p, u, cache):
    """u: [B,1,D] -> ([B,1,D], new cache)."""
    N = cfg.ssm_state
    di, R = mamba1_dims(cfg)
    x = u[:, 0] @ p["in_x"]
    z = u[:, 0] @ p["in_z"]
    if tp.cut(p["in_x"]) is not None:
        p = _mamba1_local(p)
    x, conv_state = _conv_step(cache["conv"], x, p["conv_w"], p["conv_b"])
    x = F.silu(x.float()).to(x.dtype)
    dbc = x @ p["x_proj"]
    if tp.cut(p["x_proj"]) is not None:
        dbc = tp.reduce(dbc)
    dt_in, B_ssm, C_ssm = torch.split(dbc, [R, N, N], dim=-1)
    dt = F.softplus((dt_in @ p["dt_proj"]).float() + p["dt_bias"])  # [B,di]
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt[..., None] * A)                                  # [B,di,N]
    b = (dt * x.float())[..., None] * B_ssm.float()[:, None, :]
    h = a * cache["ssm"] + b
    y = torch.einsum("bdn,bn->bd", h, C_ssm.float())
    out = _finish(p, y, x, z, u)
    return out[:, None], {"conv": conv_state, "ssm": h}


# ===========================================================================
# Mamba-2 (SSD)
# ===========================================================================
def mamba2_dims(cfg):
    di = cfg.ssm_expand * cfg.d_model
    H = di // cfg.ssm_head_dim
    G, N = cfg.ssm_groups, cfg.ssm_state
    return di, H, G, N


def mamba2_init(cfg, generator, device) -> dict:
    dt = cfg.param_dtype
    D, k = cfg.d_model, cfg.ssm_conv
    di, H, G, N = mamba2_dims(cfg)
    s = D ** -0.5

    def zeros(n):
        return torch.zeros((n,), dtype=dt, device=device)

    return {
        "in_z": normal((D, di), s, dt, generator, device),
        "in_x": normal((D, di), s, dt, generator, device),
        "in_B": normal((D, G * N), s, dt, generator, device),
        "in_C": normal((D, G * N), s, dt, generator, device),
        "in_dt": normal((D, H), s, dt, generator, device),
        "conv_xw": normal((k, di), 0.2, dt, generator, device),
        "conv_xb": zeros(di),
        "conv_Bw": normal((k, G * N), 0.2, dt, generator, device),
        "conv_Bb": zeros(G * N),
        "conv_Cw": normal((k, G * N), 0.2, dt, generator, device),
        "conv_Cb": zeros(G * N),
        "dt_bias": torch.full((H,), -4.6, dtype=F32, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=F32,
                                          device=device)),
        "ssm_D": torch.ones((H,), dtype=F32, device=device),
        "norm": rmsnorm_init(di, device),
        "out_proj": normal((di, D), di ** -0.5, dt, generator, device),
    }


def _ssd_local(x, Bm, Cm, a_log, dt):
    """The terms of n chunks that do not read the carry.  x: [B,n,T,H,P];
    Bm/Cm: [B,n,T,G,N]; a_log/dt: [B,n,T,H].  Returns (y_intra
    [B,n,T,H,P], dh [B,n,H,P,N], the decay exp(cum_T) [B,n,H], cum)."""
    Bsz, n, T, H, P = x.shape
    G, N = Bm.shape[3], Bm.shape[4]
    hg = H // G
    cum = torch.cumsum(a_log, dim=2)                         # [B,n,T,H]
    # intra-chunk: L[t,s] = exp(cum_t - cum_s), t >= s.  JAX's
    # where(tril, exp(Ldiff), 0) overflows above the diagonal where a
    # chunk's log decays sum past float32's exp range (zamba2 at full
    # width), and its gradient there is 0 * inf = NaN; the exp of the
    # masked difference gives the same values, and JAX's gradient
    # wherever JAX's is finite
    Ldiff = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # [B,n,T,S,H]
    tril = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
    L = torch.exp(torch.where(tril[:, :, None], Ldiff, -torch.inf))
    del Ldiff
    CB = torch.einsum("bctgn,bcsgn->bctsg", Cm.float(), Bm.float())
    # head h = g * hg + j takes group g's CB
    W = (CB[..., None] * L.reshape(Bsz, n, T, T, G, hg)).reshape(
        Bsz, n, T, T, H)
    del L, CB
    xdt = x.float() * dt[..., None]                          # [B,n,T,H,P]
    y_intra = torch.einsum("bctsh,bcshp->bcthp", W, xdt)
    del W
    # state update: sum_s exp(cum_T - cum_s) dt_s x_s B_s
    w_end = torch.exp(cum[:, :, -1:, :] - cum)               # [B,n,T,H]
    dh = torch.einsum("bctgjp,bctgn->bcgjpn",
                      (xdt * w_end[..., None]).reshape(Bsz, n, T, G, hg, P),
                      Bm.float()).reshape(Bsz, n, H, P, N)
    return y_intra, dh, torch.exp(cum[:, :, -1]), cum


def _ssd_inter(Cm, h_in, cum):
    """y_inter[t] = exp(cum_t) * C_t . h_in for n chunks.  Cm: [B,n,T,G,N];
    h_in: [B,n,H,P,N], the state entering each chunk."""
    Bsz, n, T, G, N = Cm.shape
    H, P = h_in.shape[2], h_in.shape[3]
    y = torch.einsum("bctgn,bcgjpn->bctgjp", Cm.float(),
                     h_in.reshape(Bsz, n, G, H // G, P, N))
    return y.reshape(Bsz, n, T, H, P) * torch.exp(cum)[..., None]


def _ssd_chunk(h_in, x, Bm, Cm, a_log, dt):
    """One SSD chunk in matmul form (JAX's ``_ssd_chunk``).
    h_in: [B,H,P,N]; x: [B,T,H,P]; Bm/Cm: [B,T,G,N]; a_log: [B,T,H] (log
    decay); dt: [B,T,H].  Returns (y [B,T,H,P], h_out)."""
    y_intra, dh, decay, cum = _ssd_local(x[:, None], Bm[:, None],
                                         Cm[:, None], a_log[:, None],
                                         dt[:, None])
    y = y_intra + _ssd_inter(Cm[:, None], h_in[:, None], cum)
    h_out = decay[:, 0, :, None, None] * h_in + dh[:, 0]
    return y[:, 0], h_out


def _mamba2_local(cfg, p):
    """(this rank's first head, its head count) where the model axis cuts
    Mamba-2's heads evenly; None where nothing is cut."""
    if tp.cut(p["in_x"]) is None:
        return None
    r, m = tp.rank_parts()
    _, H, _, _ = mamba2_dims(cfg)
    if H % m:
        return None
    return r * (H // m), H // m


def _mamba2_channels(p):
    """Mamba-2's per-channel and per-head weights for this rank's heads:
    those the rules leave whole split to its slice."""
    out = dict(p.items())
    for n, d in (("conv_xw", 1), ("conv_xb", 0), ("dt_bias", 0),
                 ("A_log", 0), ("ssm_D", 0), ("norm", 0)):
        out[n] = tp.local(p[n], d)
    return out


def _mamba2_whole(p):
    """The block's weights with every cut one gathered whole."""
    return {k: tp.whole(v) if torch.is_tensor(v) else v
            for k, v in p.items()}


def _bc_local(t, w, h0, n_h, hg, G, N):
    """B (or C), conv and silu applied, as [.., G_l, N] for this rank's
    heads: its G * N columns gathered whole, then the groups its heads
    read (``attention._kv_sel``'s rule)."""
    from repro_torch.models.attention import _kv_sel
    if tp.cut(w) is not None:
        t = tp.gather(t, -1)
    sel = _kv_sel(h0, n_h, hg)
    return tp.copy(t).view(t.shape[:-1] + (G, N))[..., sel, :]


def _gated_norm(p, y, dtype, eps, local):
    """The gated RMSNorm over d_inner; over the model axis the sum of
    squares all-reduced and the rank's channels of the scale taken."""
    if not local:
        return rmsnorm(p["norm"], y.to(dtype), eps)
    di = y.shape[-1] * tp.rank_parts()[1]
    xf = y.to(dtype).float()
    ss = tp.copy(tp.reduce(torch.sum(xf * xf, dim=-1, keepdim=True)))
    out = xf * torch.rsqrt(ss / di + eps) * (1.0 + p["norm"])
    return out.to(dtype)


def mamba2_apply(cfg, p, u):
    """u: [B,S,D] -> [B,S,D] (full-sequence / prefill path).  Under the
    sequence cut each rank runs its block's chunks (JAX's chunk where it
    divides the block), the carry entering its first chunk from the
    lower ranks'."""
    B, S, D = u.shape
    di, H, G, N = mamba2_dims(cfg)
    P = cfg.ssm_head_dim
    g = current_seq()
    S_all = S if g is None else S * g.world
    T = min(cfg.ssm_chunk, S_all)
    if S_all % T:
        raise ValueError(f"mamba2_apply: S={S_all} is not a multiple of the "
                         f"SSD chunk {T} (the JAX package's reshape fails "
                         f"too)")
    T = fsdp.local_chunk(cfg.ssm_chunk, S_all, S)
    nchunk = S // T
    local = _mamba2_local(cfg, p)
    if local is None and tp.cut(p["in_x"]) is not None:
        p = _mamba2_whole(p)
    elif local is not None:
        p = _mamba2_channels(p)
    uc = u if local is None else tp.copy(u)
    z = uc @ p["in_z"]
    x = uc @ p["in_x"]
    Bm = uc @ p["in_B"]
    Cm = uc @ p["in_C"]
    dt_in = u @ p["in_dt"]
    x = _causal_conv(x, p["conv_xw"], p["conv_xb"])
    Bm = _causal_conv(Bm, p["conv_Bw"], p["conv_Bb"])
    Cm = _causal_conv(Cm, p["conv_Cw"], p["conv_Cb"])
    x = F.silu(x.float()).to(x.dtype)
    Bm = F.silu(Bm.float()).to(Bm.dtype)
    Cm = F.silu(Cm.float()).to(Cm.dtype)
    A_log = p["A_log"]
    if local is not None:
        h0, n_h = local
        hg = H // G
        Bm = _bc_local(Bm, p["in_B"], h0, n_h, hg, G, N)
        Cm = _bc_local(Cm, p["in_C"], h0, n_h, hg, G, N)
        H, G, di = n_h, Bm.shape[-2], n_h * P
        dt_in = tp.split(dt_in, -1)
    dt = F.softplus(dt_in.float() + p["dt_bias"])                    # [B,S,H]
    a_log = -torch.exp(A_log) * dt                                   # [B,S,H]
    xc = x.view(B, nchunk, T, H, P)
    bc = Bm.reshape(B, nchunk, T, G, N)
    cc = Cm.reshape(B, nchunk, T, G, N)
    ac = a_log.view(B, nchunk, T, H)
    dc = dt.view(B, nchunk, T, H)
    step = max(1, SSD_ELEMS // (B * T * T * H))       # chunks a pass
    y = torch.empty((B, nchunk, T, H, P), dtype=F32, device=u.device)
    dh = torch.empty((B, nchunk, H, P, N), dtype=F32, device=u.device)
    decay = torch.empty((B, nchunk, H), dtype=F32, device=u.device)
    cum = torch.empty((B, nchunk, T, H), dtype=F32, device=u.device)
    for a in range(0, nchunk, step):
        b = min(a + step, nchunk)
        y[:, a:b], dh[:, a:b], decay[:, a:b], cum[:, a:b] = _ssd_local(
            xc[:, a:b], bc[:, a:b], cc[:, a:b], ac[:, a:b], dc[:, a:b])
    # the carry: the state entering each chunk, h_out = exp(cum_T) h_in + dh
    h_in = torch.empty((B, nchunk, H, P, N), dtype=F32, device=u.device)
    h = _block_carry(
        decay[..., None, None],
        lambda c, e: decay[:, c, :, None, None] * e + dh[:, c],
        torch.zeros((B, H, P, N), dtype=F32, device=u.device))
    for c in range(nchunk):
        h_in[:, c] = h
        h = decay[:, c, :, None, None] * h + dh[:, c]
    del dh, h
    for a in range(0, nchunk, step):
        b = min(a + step, nchunk)
        y[:, a:b] = y[:, a:b] + _ssd_inter(cc[:, a:b], h_in[:, a:b],
                                           cum[:, a:b])
    del h_in
    y = y.view(B, S, H, P) + p["ssm_D"][:, None] * x.view(B, S, H, P).float()
    y = y.reshape(B, S, di) * F.silu(z.float())
    y = _gated_norm(p, y, u.dtype, cfg.norm_eps, local is not None)
    return tp.row(y, p["out_proj"], local is not None)


def mamba2_cache_init(cfg, batch: int, device, parts: int = 1) -> dict:
    """The decode cache; of the rank's channels and heads where the model
    axis cuts them (``parts``, ``cache_parts``)."""
    di, H, G, N = mamba2_dims(cfg)
    dt = cfg.param_dtype
    k1 = cfg.ssm_conv - 1
    gn = G * N // parts if (G * N) % parts == 0 else G * N
    return {
        "conv_x": torch.zeros((batch, k1, di // parts), dtype=dt,
                              device=device),
        "conv_B": torch.zeros((batch, k1, gn), dtype=dt, device=device),
        "conv_C": torch.zeros((batch, k1, gn), dtype=dt, device=device),
        "ssm": torch.zeros((batch, H // parts, cfg.ssm_head_dim, N),
                           dtype=F32, device=device),
    }


def cache_parts(cfg, m: int) -> int:
    """The model axis's cut of a Mamba block's decode cache: m where the
    rules cut its channels (and, for Mamba-2, its heads evenly), else 1
    (the cut weights then run whole)."""
    if cfg.mamba_version == 1:
        di = mamba1_dims(cfg)[0]
        return m if di % m == 0 and di >= m else 1
    di, H, _, _ = mamba2_dims(cfg)
    return m if di % m == 0 and H % m == 0 and di >= m else 1


def mamba2_decode(cfg, p, u, cache):
    """u: [B,1,D] -> ([B,1,D], new cache)."""
    B = u.shape[0]
    di, H, G, N = mamba2_dims(cfg)
    P = cfg.ssm_head_dim
    hg = H // G
    local = _mamba2_local(cfg, p)
    if local is None and tp.cut(p["in_x"]) is not None:
        p = _mamba2_whole(p)
    elif local is not None:
        p = _mamba2_channels(p)
    z = u[:, 0] @ p["in_z"]
    x = u[:, 0] @ p["in_x"]
    Bm = u[:, 0] @ p["in_B"]
    Cm = u[:, 0] @ p["in_C"]
    dt_in = u[:, 0] @ p["in_dt"]
    x, conv_x = _conv_step(cache["conv_x"], x, p["conv_xw"], p["conv_xb"])
    Bm, conv_B = _conv_step(cache["conv_B"], Bm, p["conv_Bw"], p["conv_Bb"])
    Cm, conv_C = _conv_step(cache["conv_C"], Cm, p["conv_Cw"], p["conv_Cb"])
    A_log = p["A_log"]
    Bm = F.silu(Bm.float()).to(Bm.dtype)
    Cm = F.silu(Cm.float()).to(Cm.dtype)
    if local is not None:
        h0, n_h = local
        Bm = _bc_local(Bm, p["in_B"], h0, n_h, hg, G, N)
        Cm = _bc_local(Cm, p["in_C"], h0, n_h, hg, G, N)
        H, G, di = n_h, Bm.shape[-2], n_h * P
        hg = H // G
        dt_in = tp.split(dt_in, -1)
    x = F.silu(x.float()).to(x.dtype).view(B, H, P)
    Bm = Bm.reshape(B, G, N)
    Cm = Cm.reshape(B, G, N)
    dt = F.softplus(dt_in.float() + p["dt_bias"])                    # [B,H]
    a = torch.exp(-torch.exp(A_log) * dt)                            # [B,H]
    Be = torch.repeat_interleave(Bm.float(), hg, dim=1)              # [B,H,N]
    Ce = torch.repeat_interleave(Cm.float(), hg, dim=1)
    dh = torch.einsum("bhp,bhn->bhpn", x.float() * dt[..., None], Be)
    h = a[:, :, None, None] * cache["ssm"] + dh
    y = torch.einsum("bhpn,bhn->bhp", h, Ce)
    y = y + p["ssm_D"][:, None] * x.float()
    y = y.reshape(B, di) * F.silu(z.float())
    y = _gated_norm(p, y, u.dtype, cfg.norm_eps, local is not None)
    out = tp.row(y, p["out_proj"], local is not None)
    return out[:, None], {"conv_x": conv_x, "conv_B": conv_B,
                          "conv_C": conv_C, "ssm": h}
