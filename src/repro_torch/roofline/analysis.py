"""Roofline terms on one NVIDIA H100 (port of ``repro/roofline/analysis.py``).

Hardware model: H100 SXM, NVIDIA's data sheet (dense rates, no sparsity,
at the full 700 W power limit): 989.4 TFLOP/s bf16, 3.35 TB/s HBM3, 80 GB
of HBM, NVLink 4 at 900 GB/s a GPU, 450 GB/s in each direction.

A term is work over the card's peak rate: FLOPs over ``peak_flops``,
bytes over ``hbm_bw`` and collective bytes over ``link_bw``.  On one card
the collective term is 0: nothing leaves the card.  The JAX package sums
collective bytes from XLA's partitioned HLO text
(``collective_bytes_from_hlo``); PyTorch emits no HLO, so the port has
no counterpart, and collective bytes come with multi-GPU NCCL.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.pytree import leaves_with_path

ROUTED = ("e_wi", "e_wg", "e_wo")


@dataclass(frozen=True)
class HWSpec:
    peak_flops: float = 989.4e12    # dense bf16 FLOP/s
    hbm_bw: float = 3.35e12         # HBM3 bytes/s
    link_bw: float = 450e9          # NVLink 4 bytes/s, one direction
    hbm_bytes: float = 80e9         # HBM capacity


HW = HWSpec()


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   coll_bytes_per_dev: float, hw: HWSpec = HW) -> dict:
    t_c = flops_per_dev / hw.peak_flops
    t_m = bytes_per_dev / hw.hbm_bw
    t_n = coll_bytes_per_dev / hw.link_bw
    terms = {"compute_s": t_c, "memory_s": t_m, "collective_s": t_n}
    dom = max(terms, key=terms.get)
    bound = max(t_c, t_m, t_n)
    terms["dominant"] = dom
    terms["roofline_fraction_compute"] = t_c / bound if bound else 0.0
    return terms


def model_flops(cfg, n_params: int, n_active: int, shape) -> float:
    """Analytic MODEL_FLOPS: 6·N·D for train, 2·N·tokens for inference."""
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def active_params(cfg, tree) -> tuple[int, int]:
    """(total, active) parameter counts of a parameter tree in the JAX
    package's layout (``convert.param_tree``, a stack as a list of its
    layers' tensors, or ``convert.stack_like`` of it); active discounts
    routed experts to their top-k/E share."""
    total = 0
    routed = 0
    for path, leaf in leaves_with_path(tree):
        total += leaf.numel()
        if any(n in ROUTED for n in path):
            routed += leaf.numel()
    active = total - routed
    if cfg.n_experts:
        active += routed * cfg.top_k / cfg.n_experts
    return total, int(active)
