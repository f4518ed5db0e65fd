// Directory descent over the sorted index, for sm_90a.
//
// Replaces: src/repro/kernels/_fused.py:246 sorted_search_block_kernel
// (body _descent, :83).  Bit-exact with repro_torch.core.sorted_index.search
// and with the JAX kernel's lower bound.
//
// For each query q it descends the implicit fanout-ary directory over the
// ascending, INF-padded keys: at level l (stride fanout^l) it reads the
// node keys[pos + j * stride], j < fanout (INF past the end), counts those
// <= q, and moves pos by max(cnt - 1, 0) * stride.  Outputs: addr (or -1),
// found, n_accesses = levels, pos, and the lower bound pos + (keys[pos] < q).
//
// For q = key_inf every node counts as <= q, so pos runs past the end
// (to fanout^levels - 1); the final read clamps it to cap - 1 as the JAX
// gather does, while pos and the lower bound keep the unclamped value.
//
// Bound: latency.  At Q = 1 (the SCAN lower bound) it is `levels`
// dependent rounds of one node read each (4 at cap = 2^24); the bytes are
// a few KB.  Design: one warp per query; at each level each lane reads
// fanout / 32 node keys (j = lane + 32 t).  Only level 0 reads
// consecutive keys; at level l > 0 the lanes read keys fanout^l apart,
// one 32 B sector each.  __ballot_sync + __popc count the keys <= q with
// no shared memory and no block barrier, so a level costs one round of
// loads.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t KEY_INF = 0x7fffffff;

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
