// The hash-bucket chain walk, shared by hash_probe.cu and group_probe.cu
// (mirror of _hash_probe, src/repro/kernels/_fused.py:68, and of
// repro_torch.core.hash_index.probe_rows).
//
// For one query (bucket b, signature s, fingerprint f) a warp walks the
// [cs] chain row of bucket b: the 32 lanes cover 32 chain slots a pass
// (one pass at cs = 32), so each row is one coalesced 128 B read per
// array, and __ballot_sync + __ffs give the first slot whose sig and fp
// both match.  A hit costs off / S + 1 sub-bucket reads, a miss
// ceil(max(fill[b], 1) / S).  Every lane of the warp must call it; all
// get the same result.
#pragma once

#include <stdint.h>

#include "descent.cuh"

namespace histore {

__device__ __forceinline__ Probe hash_walk(const int32_t* __restrict__ sig,
                                           const int32_t* __restrict__ fp,
                                           const int32_t* __restrict__ addr,
                                           const int32_t* __restrict__ fill,
                                           int64_t b, int32_t s, int32_t f,
                                           int cs, int S, int lane) {
  const int32_t* srow = sig + b * cs;
  const int32_t* frow = fp + b * cs;
  int off = -1;
  for (int base = 0; base < cs; base += 32) {
    const int slot = base + lane;
    bool m = false;
    if (slot < cs) m = (srow[slot] == s) && (frow[slot] == f);
    const unsigned hit = __ballot_sync(0xffffffffu, m);
    if (hit) {
      off = base + __ffs(hit) - 1;
      break;
    }
  }
  if (off >= 0) return Probe{addr[b * cs + off], 1, off / S + 1};
  const int occ = max(fill[b], 1);
  return Probe{-1, 0, (occ + S - 1) / S};
}

}  // namespace histore
