"""Hand-written CUDA kernels of the index hot path and their dispatch
surface (``ops``).  Importing this package builds nothing: the kernels
are compiled with nvcc at their first launch (``_build``)."""
