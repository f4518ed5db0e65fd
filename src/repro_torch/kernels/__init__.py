"""Hand-written CUDA kernels: those of the index hot path behind their
dispatch surface (``ops``), and the Mamba-1 selective scan of the model
path (``mamba_scan``).  Importing this package builds nothing: the
kernels are compiled with nvcc at their first launch (``_build``)."""
