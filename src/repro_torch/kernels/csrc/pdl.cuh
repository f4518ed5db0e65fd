// Programmatic dependent launch (Hopper) for chains of kernels on one
// stream, shared by merge_sort.cuh and merge.cu.
//
// A kernel launched with launch() may be scheduled while the kernel before
// it on the stream is still running, once every block of that kernel has
// called pdl_trigger(); pdl_wait() then holds it until that kernel has
// finished and its writes are visible.  So a chain of short dependent
// kernels does not pay a full drain and launch at every boundary.  Every
// kernel launched this way calls pdl_wait() before it reads what an
// earlier kernel wrote; a kernel with no dependent launch before it
// passes pdl_wait() at once.
#pragma once

#include <cuda_runtime.h>

namespace histore {

__device__ __forceinline__ void pdl_trigger() {
#if defined(__CUDA_ARCH__)
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
#endif
}

__device__ __forceinline__ void pdl_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("griddepcontrol.wait;" ::: "memory");
#endif
}

// kernel<<<grid, block, 0, st>>>(args...) with programmatic stream
// serialization allowed
template <class... P, class... A>
cudaError_t launch(void (*kernel)(P...), unsigned grid, unsigned block,
                   cudaStream_t st, A... args) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, P(args)...);
}

}  // namespace histore
