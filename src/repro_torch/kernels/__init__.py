"""Hand-written CUDA kernels: those of the index hot path behind their
dispatch surface (``ops``), and the Mamba-1 selective scan of the model
path (``mamba_scan``).  Importing this package builds nothing: the
kernels are compiled with nvcc at their first launch (``_build``).

Public surface, as in ``repro.kernels``: the cfg-routed dispatch API of
``ops`` (re-exported below), which routes by the tensors' device.  The
old per-kernel module homes (``kernels.hash_probe`` / ``sorted_search``
/ ``bitonic_sort``) are deprecated shims over the legacy wrappers.
"""
from repro_torch.kernels import ops  # noqa: F401
from repro_torch.kernels.ops import (active_path, backup_probe,  # noqa: F401
                                     group_probe, group_probe_stacked,
                                     kernels_enabled, merge, probe,
                                     range_query, range_query_stacked,
                                     search, sort)
