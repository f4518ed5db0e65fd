// The directory descent over the sorted index, shared by sorted_search.cu,
// backup_probe.cu and group_probe.cu (mirror of _descent,
// src/repro/kernels/_fused.py:83), and the probe result the hash walk and
// the backup finish return.
//
// Over ascending, INF-padded int32 keys, it descends the implicit
// fanout-ary directory: at level l (stride fanout^l) the warp reads the
// node keys[pos + j * stride], j < fanout (INF past the end), counts those
// <= q, and moves pos by max(cnt - 1, 0) * stride.  One warp per query:
// each lane reads fanout / 32 node keys (j = lane + 32 t) and
// __ballot_sync + __popc count the keys <= q, so a level costs one round of
// loads and no barrier.  Every lane of the warp must call it; all get the
// same pos, which runs past the end (to fanout^levels - 1) for q = KEY_INF.
#pragma once

#include <stdint.h>

namespace histore {

constexpr int32_t KEY_INF = 0x7fffffff;

// one query's answer: value address (-1 on a miss), found, n_accesses
struct Probe {
  int32_t addr;
  int32_t found;
  int32_t acc;
};

__device__ __forceinline__ int64_t descent(const int32_t* __restrict__ keys,
                                           int32_t q, int64_t cap,
                                           int fanout, int levels,
                                           int lane) {
  int64_t stride = 1;
  for (int l = 1; l < levels; ++l) stride *= fanout;
  int64_t pos = 0;
  for (int l = levels - 1; l >= 0; --l) {
    int cnt = 0;
    for (int base = 0; base < fanout; base += 32) {
      const int j = base + lane;
      bool le = false;
      if (j < fanout) {
        const int64_t gi = pos + int64_t(j) * stride;
        const int32_t node = gi < cap ? keys[gi] : KEY_INF;
        le = node <= q;
      }
      cnt += __popc(__ballot_sync(0xffffffffu, le));
    }
    pos += int64_t(max(cnt - 1, 0)) * stride;
    stride /= fanout;
  }
  return pos;
}

}  // namespace histore
