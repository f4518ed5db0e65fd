"""DEPRECATED module home: import through repro_torch.kernels.ops instead.

The public surface is the routed dispatch API
(repro_torch.kernels.ops.probe) plus the legacy wrapper
repro_torch.kernels.ops.hash_probe; the kernel's CUDA wrapper is
re-exported here.
"""
import warnings

from repro_torch.kernels.ops import legacy_hash_probe_cuda  # noqa: F401

warnings.warn(
    "repro_torch.kernels.hash_probe is deprecated: use "
    "repro_torch.kernels.ops (probe(cfg, ...) dispatch, or the hash_probe "
    "wrapper)", DeprecationWarning, stacklevel=2)
