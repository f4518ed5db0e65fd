// The directory descent over the sorted index, shared by sorted_search.cu,
// legacy_sorted_search.cu, backup_probe.cu and group_probe.cu (mirror of
// _descent, src/repro/kernels/_fused.py:83), the search kernel and launch
// the two searches share, and the probe result the hash walk and the
// backup finish return.
//
// Over ascending, INF-padded int32 keys, it descends the implicit
// fanout-ary directory: at level l (stride fanout^l) the warp reads the
// node keys[pos + j * stride], j < fanout (INF past the end), counts those
// <= q, and moves pos by max(cnt - 1, 0) * stride.  One warp per query:
// each lane reads fanout / 32 node keys (j = lane + 32 t) and
// __ballot_sync + __popc count the keys <= q, so a level costs one round of
// loads and no barrier.  Every lane of the warp must call it; all get the
// same pos, which runs past the end (to fanout^levels - 1) for q = KEY_INF.
//
// descent_lanes<W> is the same descent on a group of W < 32 lanes (the
// group probe's finish serves 32 / W queries a warp): each lane issues its
// fanout / W node loads before it compares any, and one __reduce_add_sync
// over the group counts them.
#pragma once

#include <cuda_runtime.h>
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

// the lanes of this thread's group of W within its warp (1-D blocks)
template <int W>
__device__ __forceinline__ unsigned group_mask() {
  static_assert(W >= 1 && W < 32 && (W & (W - 1)) == 0, "W divides 32");
  return ((1u << W) - 1u) << ((threadIdx.x & 31) & ~(W - 1));
}

template <int W>
__device__ __forceinline__ int64_t descent_lanes(
    const int32_t* __restrict__ keys, int32_t q, int64_t cap, int fanout,
    int levels, int lane) {
  const unsigned mask = group_mask<W>();
  int64_t stride = 1;
  for (int l = 1; l < levels; ++l) stride *= fanout;
  int64_t pos = 0;
  for (int l = levels - 1; l >= 0; --l) {
    int le = 0;
#pragma unroll 4
    for (int j = lane; j < fanout; j += W) {
      const int64_t gi = pos + int64_t(j) * stride;
      le += (gi < cap ? keys[gi] : KEY_INF) <= q ? 1 : 0;
    }
    const int cnt = int(__reduce_add_sync(mask, unsigned(le)));
    pos += int64_t(max(cnt - 1, 0)) * stride;
    stride /= fanout;
  }
  return pos;
}

// One warp per query: the descent, then the key and addr at pos, clamped
// to cap - 1 as the JAX gather is (q = key_inf runs pos past the end).
// Writes addr (or -1), found and n_accesses = levels; where out_pos is not
// null also the unclamped pos and the lower bound pos + (keys[pos] < q).
__global__ void search_kernel(const int32_t* __restrict__ queries,
                              const int32_t* __restrict__ keys,
                              const int32_t* __restrict__ addrs,
                              int32_t* __restrict__ out_addr,
                              int32_t* __restrict__ out_found,
                              int32_t* __restrict__ out_acc,
                              int32_t* __restrict__ out_pos,
                              int32_t* __restrict__ out_lb, int64_t Q,
                              int64_t cap, int fanout, int levels) {
  const int lane = threadIdx.x & 31;
  const int64_t qi =
      (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (qi >= Q) return;  // warp-uniform
  const int32_t q = queries[qi];
  const int64_t pos = descent(keys, q, cap, fanout, levels, lane);
  if (lane == 0) {
    const int64_t at = pos < cap ? pos : cap - 1;
    const int32_t k = keys[at];
    const bool found = k == q;
    out_addr[qi] = found ? addrs[at] : -1;
    out_found[qi] = found ? 1 : 0;
    out_acc[qi] = levels;
    if (out_pos != nullptr) {
      out_pos[qi] = (int32_t)pos;
      out_lb[qi] = (int32_t)(pos + (k < q ? 1 : 0));
    }
  }
}

// launches search_kernel, 8 queries a block; returns the launch status
inline int launch_search(const void* queries, const void* keys,
                         const void* addrs, void* out_addr, void* out_found,
                         void* out_acc, void* out_pos, void* out_lb,
                         long long Q, long long cap, int fanout, int levels,
                         void* stream) {
  if (cap < 1 || fanout < 1) return (int)cudaErrorInvalidValue;
  if (Q > 0) {
    const int threads = Q >= 8 ? 256 : 32;
    const long long blocks = (Q * 32 + threads - 1) / threads;
    search_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)queries, (const int32_t*)keys,
        (const int32_t*)addrs, (int32_t*)out_addr, (int32_t*)out_found,
        (int32_t*)out_acc, (int32_t*)out_pos, (int32_t*)out_lb, (int64_t)Q,
        (int64_t)cap, fanout, levels);
  }
  return (int)cudaGetLastError();
}

}  // namespace histore
