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
// a few KB.  Design: one warp per query (descent.cuh); only level 0 reads
// consecutive keys, at level l > 0 the lanes read keys fanout^l apart, one
// 32 B sector each.
#include <cuda_runtime.h>
#include <stdint.h>

#include "descent.cuh"

namespace {

__global__ void sorted_search_kernel(const int32_t* __restrict__ queries,
                                     const int32_t* __restrict__ keys,
                                     const int32_t* __restrict__ addrs,
                                     int32_t* __restrict__ out_addr,
                                     int32_t* __restrict__ out_found,
                                     int32_t* __restrict__ out_acc,
                                     int32_t* __restrict__ out_pos,
                                     int32_t* __restrict__ out_lb,
                                     int64_t Q, int64_t cap, int fanout,
                                     int levels) {
  const int lane = threadIdx.x & 31;
  const int64_t qi =
      (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (qi >= Q) return;  // warp-uniform
  const int32_t q = queries[qi];
  const int64_t pos = histore::descent(keys, q, cap, fanout, levels, lane);
  if (lane == 0) {
    const int64_t at = pos < cap ? pos : cap - 1;
    const int32_t k = keys[at];
    const bool found = k == q;
    out_addr[qi] = found ? addrs[at] : -1;
    out_found[qi] = found ? 1 : 0;
    out_acc[qi] = levels;
    out_pos[qi] = (int32_t)pos;
    out_lb[qi] = (int32_t)(pos + (k < q ? 1 : 0));
  }
}

}  // namespace

extern "C" int histore_sorted_search(const void* queries, const void* keys,
                                     const void* addrs, void* out_addr,
                                     void* out_found, void* out_acc,
                                     void* out_pos, void* out_lb,
                                     long long Q, long long cap, int fanout,
                                     int levels, void* stream) {
  if (Q > 0) {
    const int threads = Q >= 8 ? 256 : 32;  // 8 queries per block
    const long long blocks = (Q * 32 + threads - 1) / threads;
    sorted_search_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
        (const int32_t*)queries, (const int32_t*)keys,
        (const int32_t*)addrs, (int32_t*)out_addr, (int32_t*)out_found,
        (int32_t*)out_acc, (int32_t*)out_pos, (int32_t*)out_lb, (int64_t)Q,
        (int64_t)cap, fanout, levels);
  }
  return (int)cudaGetLastError();
}
