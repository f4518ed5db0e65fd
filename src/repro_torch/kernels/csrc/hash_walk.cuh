// The hash-bucket chain walk, shared by hash_probe.cu and group_probe.cu
// (mirror of _hash_probe, src/repro/kernels/_fused.py:68, and of
// repro_torch.core.hash_index.probe_rows).
//
// For one query (bucket b, signature s, fingerprint f) a group of W lanes
// walks the [cs] chain row of bucket b, V = 32 / W consecutive slots a
// lane (16 B loads of sig and of fp), so a pass covers 32 slots (a 128 B
// row at cs = 32) and a warp serves 32 / W queries.  The fill word is read
// beside the rows.  __ballot_sync over the group and __ffs give the first
// slot whose sig and fp both match.  A hit costs off / S + 1 sub-bucket
// reads, a miss ceil(max(fill[b], 1) / S).  Every lane of the group must
// call it; all get the same result.  W is each kernel's own constant,
// chosen on the card on the traffic its path runs (PERF.md §6):
// hash_probe.cu 4, group_probe.cu 2.  legacy_hash_probe.cu walks its rows
// with load_slots too, under its own miss rule.
#pragma once

#include <stdint.h>

#include "descent.cuh"

namespace histore {

// slots [first, first + V) of a chain row, 0 past cs; `vec`: the row is
// 16-byte aligned and cs % 4 == 0, so the loads are 16 B vector loads
template <int V>
__device__ __forceinline__ void load_slots(const int32_t* __restrict__ row,
                                           int first, int cs, bool vec,
                                           int32_t (&v)[V]) {
  static_assert(V % 4 == 0, "whole 16 B loads");
  if (vec && first + V <= cs) {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const int4 x = reinterpret_cast<const int4*>(row + first)[i];
      v[4 * i] = x.x;
      v[4 * i + 1] = x.y;
      v[4 * i + 2] = x.z;
      v[4 * i + 3] = x.w;
    }
    return;
  }
#pragma unroll
  for (int t = 0; t < V; ++t) v[t] = first + t < cs ? row[first + t] : 0;
}

template <int W>
__device__ __forceinline__ Probe hash_walk(const int32_t* __restrict__ sig,
                                           const int32_t* __restrict__ fp,
                                           const int32_t* __restrict__ addr,
                                           const int32_t* __restrict__ fill,
                                           int64_t b, int32_t s, int32_t f,
                                           int cs, int S, bool vec) {
  constexpr int V = 32 / W;
  const int wl = threadIdx.x & 31;
  const int lead = wl & ~(W - 1);
  const unsigned mask = group_mask<W>();
  const int64_t row = b * cs;
  const int32_t fill_b = fill[b];
  int off = -1;
  for (int base = 0; base < cs; base += 32) {
    const int first = base + (wl - lead) * V;
    int32_t sv[V], fv[V];
    load_slots<V>(sig + row, first, cs, vec, sv);
    load_slots<V>(fp + row, first, cs, vec, fv);
    int t_hit = -1;
#pragma unroll
    for (int t = V - 1; t >= 0; --t)
      if (first + t < cs && sv[t] == s && fv[t] == f) t_hit = t;
    const unsigned hit = __ballot_sync(mask, t_hit >= 0) & mask;
    if (hit) {
      const int src = __ffs(hit) - 1;
      off = base + (src - lead) * V + __shfl_sync(mask, t_hit, src);
      break;
    }
  }
  if (off >= 0) return Probe{addr[row + off], 1, off / S + 1};
  return Probe{-1, 0, (max(fill_b, 1) + S - 1) / S};
}

}  // namespace histore
