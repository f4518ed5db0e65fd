// The legacy per-level directory descent over the sorted index, for
// sm_90a.
//
// Replaces: src/repro/kernels/_sorted_search.py:82 sorted_search_kernel
// (body _kernel :34).  Bit-exact with repro_torch.kernels.ops.
// legacy_sorted_search_plain (ref_sorted_search).
//
// At each of the `levels` levels it reads the fanout keys
// keys[min(pos + i * stride, cap - 1)], i < fanout, reads those at
// pos + i * stride >= cap as key_inf, counts those <= q and moves pos by
// max(cnt - 1, 0) * stride; then it reads the key and addr at pos,
// clamped to cap - 1 as JAX's read is, and returns addr (or -1), found
// and n_accesses = levels.  That is the descent and the first three
// outputs of sorted_search.cu, so this entry point launches the same
// kernels (descent.cuh's launch_search) without the pos and lower bound
// outputs.
//
// Bound: at Q = 16384 the distinct 32 B sectors the queries read (the
// top levels' nodes are shared), beside the latency of the dependent
// reads.  Design: descent.cuh's lane form (the top grid staged in shared
// memory once a block, 8 lanes a query, a node of levels >= 1 in two
// rounds of 16 and 8 scattered keys, level 0's node in 16 B loads): 41
// sectors a query at cap 2^24 where a warp a level read about 268; the
// block form at Q <= 256.
#include <cuda_runtime.h>
#include <stdint.h>

#include "descent.cuh"

extern "C" int histore_legacy_sorted_search(const void* queries,
                                            const void* keys,
                                            const void* addrs,
                                            void* out_addr, void* out_found,
                                            void* out_acc, long long Q,
                                            long long cap, int fanout,
                                            int levels, void* stream) {
  return histore::launch_search(queries, keys, addrs, out_addr, out_found,
                                out_acc, nullptr, nullptr, Q, cap, fanout,
                                levels, stream);
}
