"""DEPRECATED module home: import through repro_torch.kernels.ops instead.

The public surface is the routed dispatch API
(repro_torch.kernels.ops.sort) plus the legacy wrapper
repro_torch.kernels.ops.sort_pairs; the kernel's CUDA wrapper is
re-exported here.
"""
import warnings

from repro_torch.kernels.ops import bitonic_sort_cuda  # noqa: F401

warnings.warn(
    "repro_torch.kernels.bitonic_sort is deprecated: use "
    "repro_torch.kernels.ops (sort(cfg, ...) dispatch, or the sort_pairs "
    "wrapper)", DeprecationWarning, stacklevel=2)
