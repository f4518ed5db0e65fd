"""DEPRECATED module home: import through repro_torch.kernels.ops instead.

The public surface is the routed dispatch API
(repro_torch.kernels.ops.search / range_query) plus the legacy wrapper
repro_torch.kernels.ops.sorted_search; the kernel's CUDA wrapper is
re-exported here.
"""
import warnings

from repro_torch.kernels.ops import legacy_sorted_search_cuda  # noqa: F401

warnings.warn(
    "repro_torch.kernels.sorted_search is deprecated: use "
    "repro_torch.kernels.ops (search(cfg, ...) dispatch, or the "
    "sorted_search wrapper)", DeprecationWarning, stacklevel=2)
