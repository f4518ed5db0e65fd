// Directory descent over the sorted index, for sm_90a.
//
// Replaces: src/repro/kernels/_fused.py:246 sorted_search_block_kernel
// (body _descent, :83).  Bit-exact with repro_torch.core.sorted_index.search
// and with the JAX kernel's lower bound.
//
// For each query q it descends the implicit fanout-ary directory (the
// shared histore::descent of descent.cuh) and outputs addr (or -1), found,
// n_accesses = levels, pos, and the lower bound pos + (keys[pos] < q).
//
// For q = key_inf every node counts as <= q, so pos runs past the end
// (to fanout^levels - 1); the final read clamps it to cap - 1 as the JAX
// gather does, while pos and the lower bound keep the unclamped value.
//
// Bound: latency.  At Q = 1 (the SCAN lower bound) it is `levels`
// dependent rounds of one node read each (4 at cap = 2^24); the bytes are
// a few KB.  Design: one warp per query (descent.cuh's
// histore::search_kernel, which legacy_sorted_search.cu launches too);
// only level 0 reads consecutive keys, at level l > 0 the lanes read keys
// fanout^l apart, one 32 B sector each.
#include <cuda_runtime.h>
#include <stdint.h>

#include "descent.cuh"

extern "C" int histore_sorted_search(const void* queries, const void* keys,
                                     const void* addrs, void* out_addr,
                                     void* out_found, void* out_acc,
                                     void* out_pos, void* out_lb,
                                     long long Q, long long cap, int fanout,
                                     int levels, void* stream) {
  return histore::launch_search(queries, keys, addrs, out_addr, out_found,
                                out_acc, out_pos, out_lb, Q, cap, fanout,
                                levels, stream);
}
