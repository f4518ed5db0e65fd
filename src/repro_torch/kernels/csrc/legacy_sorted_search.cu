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
// kernel (descent.cuh's histore::search_kernel) without the pos and lower
// bound outputs.
//
// Bound: latency, `levels` + 1 dependent reads: the queries share the top
// levels' nodes, so the distinct sectors they read are few.
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
