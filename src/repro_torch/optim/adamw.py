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


def global_norm(tree):
    """sqrt of the float32 sum, over the leaves in tree order, of each
    leaf's float32 sum of squares."""
    parts = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(parts)))


@torch.no_grad()
def adamw_update(params, grads, state, *, lr=3e-4, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1, clip_norm=1.0):
    """One AdamW step over the tree.  Returns (params, the new state, the
    gradients' global norm before clipping); ``params`` and the state's m
    and v are the same tensors, written in place."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    one = torch.ones((), dtype=F32, device=gnorm.device)
    scale = torch.minimum(one, (one * clip_norm)
                          / torch.maximum(gnorm, one * 1e-9))
    stepf = step.to(F32)
    bc1 = 1.0 - torch.pow(one * b1, stepf)
    bc2 = 1.0 - torch.pow(one * b2, stepf)
    for p, g, m, v in zip(leaves(params), leaves(grads),
                          leaves(state["m"]), leaves(state["v"])):
        leaf_update(p, g, m, v, scale, bc1, bc2, lr=lr, b1=b1, b2=b2,
                    eps=eps, weight_decay=weight_decay)
    return params, {"m": state["m"], "v": state["v"], "step": step}, gnorm


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
