"""The fused Mamba-1 selective scan (port of ``repro/kernels/mamba_scan.py``
and its oracle ``repro/kernels/ref.py:ref_mamba_scan``).

    y = mamba_scan(x, dt, B_ssm, C_ssm, A)

x, dt: [B, S, di]; B_ssm, C_ssm: [B, S, N]; A: [di, N] (negative).  At
each step ``h = exp(dt * A) * h + (dt * x) * B`` and ``y = sum_n C * h``,
with the float32 state [B, di, N] carried along S; y comes back in x's
dtype.  x, B and C share one dtype, bf16, float16 or float32; dt and A
are float32.  Any B, S, di and N, as JAX's kernel takes.

``mamba_scan`` routes by device: a CUDA tensor launches the hand-written
kernel (``csrc/mamba_scan.cu``) or raises, a CPU tensor takes
``mamba_scan_plain``, the sequential loop of the reference.  There is no
fallback.  ``LAUNCHES["mamba_scan"]`` counts the kernel's launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref

F32 = torch.float32
# the kernel's dtype code of x, B, C and y
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
TILE_STATES = 64      # states a tile of the kernel holds in registers

# launches of the CUDA kernel in this process (reset by callers that count
# the launches of one run)
LAUNCHES = {"mamba_scan": 0}


# the plain version: a sequential loop over S on the [B, di, N] float32
# state, as the reference runs it
mamba_scan_plain = ref.ref_mamba_scan


def _check(name, t, dtypes, ndim):
    if not t.is_cuda:
        raise ValueError(f"mamba_scan: {name} must be a CUDA tensor, got "
                         f"{t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"mamba_scan: {name} must be one of {dtypes}, got "
                        f"{t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"mamba_scan: {name} must be {ndim}-D, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"mamba_scan: {name} must be contiguous (pass "
                         f"B and C through .contiguous() after a split)")


def mamba_scan_cuda(x, dt, B_ssm, C_ssm, A):
    """Launch ``csrc/mamba_scan.cu`` on the current stream.  Checks device,
    dtypes, shapes and contiguity and raises on anything the kernel does
    not take, or on a nonzero launch status."""
    _check("x", x, tuple(DTYPES), 3)
    _check("dt", dt, (F32,), 3)
    _check("B_ssm", B_ssm, (x.dtype,), 3)
    _check("C_ssm", C_ssm, (x.dtype,), 3)
    _check("A", A, (F32,), 2)
    Bsz, S, di = x.shape
    N = B_ssm.shape[-1]
    if (dt.shape != x.shape or B_ssm.shape != (Bsz, S, N)
            or C_ssm.shape != (Bsz, S, N) or A.shape != (di, N)):
        raise ValueError(
            f"mamba_scan: inconsistent shapes x {tuple(x.shape)}, dt "
            f"{tuple(dt.shape)}, B {tuple(B_ssm.shape)}, C "
            f"{tuple(C_ssm.shape)}, A {tuple(A.shape)}")
    devs = {t.device for t in (x, dt, B_ssm, C_ssm, A)}
    if len(devs) != 1:
        raise ValueError(f"mamba_scan: tensors on several devices {devs}")
    from repro_torch.kernels import _build

    y = torch.empty_like(x)
    # past one tile of states the tiles add y up in float32: in y itself
    # for float32, else in a scratch
    yacc = None
    if N > TILE_STATES and x.dtype != F32:
        yacc = torch.empty(x.shape, dtype=F32, device=x.device)
    with torch.cuda.device(x.device):
        st = _build.lib("mamba_scan").histore_mamba_scan(
            x.data_ptr(), dt.data_ptr(), B_ssm.data_ptr(), C_ssm.data_ptr(),
            A.data_ptr(), y.data_ptr(),
            None if yacc is None else yacc.data_ptr(), Bsz, S, di, N,
            DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if st != 0:
        raise RuntimeError(f"CUDA kernel mamba_scan failed to launch: "
                           f"cudaError {st}")
    LAUNCHES["mamba_scan"] += 1
    return y


def mamba_scan(x, dt, B_ssm, C_ssm, A):
    """y [B, S, di] in x's dtype: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if x.is_cuda:
        return mamba_scan_cuda(x, dt, B_ssm, C_ssm, A)
    return mamba_scan_plain(x, dt, B_ssm, C_ssm, A)
