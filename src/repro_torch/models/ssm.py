"""State-space blocks, Mamba-1 (port of the Mamba-1 half of
``repro/models/ssm.py``; Mamba-2 is still to port, ROADMAP.md A3.2).

Plain functions on tensors.  ``p`` is a block's parameters by the JAX
package's names (``in_x``, ``in_z``, ``conv_w``, ``conv_b``, ``x_proj``,
``dt_proj``, ``dt_bias``, ``A_log``, ``ssm_D``, ``out_proj``), a dict or a
``ParameterDict``.

``mamba1_apply`` has the JAX package's three scans, chosen by
``cfg.ssm_impl``:

  * ``"jnp"``: the chunked scan.  Within each chunk of ``cfg.ssm_chunk``
    steps an inclusive scan of the (a, b) pairs (log-step, where JAX uses
    ``associative_scan``), then a loop over chunks carries the state.  It
    materialises [B, S, di, N] intermediates.
  * ``"pallas"``: the fused scan, ``kernels/mamba_scan.py`` (the CUDA
    kernel for CUDA tensors, its plain version on the CPU).
  * ``"stub"``: the analysis placeholder with the kernel's I/O shapes.

Decode is the single-step recurrence over the carried (conv, ssm) state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.models.layers import normal

F32 = torch.float32
KERNEL_BLOCK = 128     # the Pallas kernel's default d_block and seq_chunk


def _causal_conv(x, w, b):
    """Depthwise causal conv.  x: [B,S,C]; w: [k,C]; b: [C]."""
    k = w.shape[0]
    S = x.shape[1]
    out = torch.zeros(x.shape, dtype=F32, device=x.device)
    for j in range(k):
        shift = k - 1 - j
        xs = F.pad(x, (0, 0, shift, 0))[:, :S]
        out += xs.float() * w[j].float()
    return (out + b.float()).to(x.dtype)


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
    a_cum, b_scan = a.clone(), b.clone()
    T = a.shape[2]
    off = 1
    while off < T:
        ar, br = a_cum[:, :, off:], b_scan[:, :, off:]
        new_b = ar * b_scan[:, :, :-off] + br
        new_a = ar * a_cum[:, :, :-off]
        b_scan[:, :, off:] = new_b
        a_cum[:, :, off:] = new_a
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


def _finish(p, y, x, z, u):
    y = y + p["ssm_D"] * x.float()
    y = y * F.silu(z.float())
    return y.to(u.dtype) @ p["out_proj"]


def mamba1_apply(cfg, p, u):
    """u: [B,S,D] -> [B,S,D] (full-sequence / prefill path)."""
    B, S, D = u.shape
    N = cfg.ssm_state
    di, R = mamba1_dims(cfg)
    _check_shapes(cfg, S, di)
    x = u @ p["in_x"]
    z = u @ p["in_z"]
    x = _causal_conv(x, p["conv_w"], p["conv_b"])
    x = F.silu(x.float()).to(x.dtype)
    dbc = x @ p["x_proj"]
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
    T = min(cfg.ssm_chunk, S)
    nchunk = S // T
    a = torch.exp(dt[..., None] * A)                                  # [B,S,di,N]
    b = (dt * x.float())[..., None] * B_ssm.float()[:, :, None, :]
    sd = getattr(torch, cfg.ssm_scan_dtype)
    a_cum, b_scan = _scan_chunks(a.to(sd).reshape(B, nchunk, T, di, N),
                                 b.to(sd).reshape(B, nchunk, T, di, N))
    del a, b
    C_c = C_ssm.to(sd).reshape(B, nchunk, T, N)
    h = torch.zeros((B, di, N), dtype=F32, device=u.device)
    h_in = []
    for c in range(nchunk):
        h_in.append(h)
        h = (a_cum[:, c, -1] * h.to(sd) + b_scan[:, c, -1]).float()
    hs = a_cum * torch.stack(h_in, 1)[:, :, None].to(sd) + b_scan
    y = torch.einsum("bctdn,bctn->bctd", hs.float(), C_c.float())
    return _finish(p, y.reshape(B, S, di), x, z, u)


def mamba1_cache_init(cfg, batch: int, device) -> dict:
    di, _ = mamba1_dims(cfg)
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
    x, conv_state = _conv_step(cache["conv"], x, p["conv_w"], p["conv_b"])
    x = F.silu(x.float()).to(x.dtype)
    dbc = x @ p["x_proj"]
    dt_in, B_ssm, C_ssm = torch.split(dbc, [R, N, N], dim=-1)
    dt = F.softplus((dt_in @ p["dt_proj"]).float() + p["dt_bias"])  # [B,di]
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt[..., None] * A)                                  # [B,di,N]
    b = (dt * x.float())[..., None] * B_ssm.float()[:, None, :]
    h = a * cache["ssm"] + b
    y = torch.einsum("bdn,bn->bd", h, C_ssm.float())
    out = _finish(p, y, x, z, u)
    return out[:, None], {"conv": conv_state, "ssm": h}
