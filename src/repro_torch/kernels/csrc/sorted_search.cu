// The sorted-index search and the SCAN's range, for sm_90a.
//
// Replaces: src/repro/kernels/_fused.py:246 sorted_search_block_kernel
// (body _descent, :83), and the SCAN route of src/repro/kernels/ops.py's
// range_query (that kernel's lower bound, then six.range_from_start).
// Bit-exact with repro_torch.core.sorted_index.search, with the JAX
// kernel's lower bound, and with sorted_index.range_query.
//
// Each entry point has an int64 twin (histore_sorted_search_i64,
// histore_range_query_i64): the same templates (descent.cuh) on int64
// queries, keys, lo, hi and output keys; addrs and counts stay int32.
//
// histore_sorted_search: for each query q, addr (or -1), found,
// n_accesses = levels, the descent's pos and the lower bound
// pos + (keys[min(pos, cap - 1)] < q).  For q = key_inf every node counts,
// so pos runs past the end (to fanout^levels - 1); the key read clamps it
// to cap - 1 as the JAX gather does, while pos and the lower bound keep
// the unclamped value.
//
// histore_range_query: the SCANs of G groups x R replicas in one launch
// (ops.range_query: G = R = 1; ops.range_query_stacked: the distributed
// store's [R, G] sorted leaves read in place by strides), each the lower
// bound of lo read from device memory and the take of `limit` entries,
// masked where past cap, above hi or key_inf, with their count.
//
// Bound: latency.  At Q = 1 (a SCAN) the bytes are a few KB; what costs
// is the chain of dependent reads.  The SCAN needs 3 at cap 2^24 (lo with
// the top two levels' 1024 keys, level 1, level 0 with the take's
// entries); the parent read lo on the host's side, then levels + 2 = 6
// rounds in the search kernel, then the take's gathers in 8 more
// launches; int64 keys need the same 3 rounds.  At Q = 16384 the bound is
// the distinct sectors the queries read (about 10.7 MB at int32 keys and
// 18.2 MB at int64 on the main path's replica, PERF.md §6 row 2), and the
// design is what cuts the scattered reads per query.  At int64 a 16 B
// load holds 2 keys, not 4, so level 0's node of 128 keys is 32 sectors,
// not 16; a node of a level above still costs its 16 + 8 scattered keys,
// a sector each; the block form's shared window holds 8 B keys (24 KB,
// not 16).
// Design: descent.cuh's block form (one block a query) at Q <= 256 and for
// the range; its lane form (8 lanes a query, the top grid staged in
// shared memory, nodes of levels >= 1 searched as every 8th key then 8)
// above.
#include <cuda_runtime.h>
#include <stdint.h>

#include "descent.cuh"

namespace {

template <class K>
int range_query(const void* keys, const void* addrs, long long ks_r,
                long long ks_g, long long as_r, long long as_g,
                const void* lo, long long lo_s, const void* hi,
                long long hi_s, void* out_k, void* out_a, void* out_n,
                long long G, int R, long long cap, int fanout, int levels,
                long long limit, void* stream) {
  const histore::RangeArgs<K> p{
      (const K*)keys, (const int32_t*)addrs, ks_r, ks_g, as_r, as_g,
      (const K*)lo, (const K*)hi, lo_s, hi_s, (K*)out_k, (int32_t*)out_a,
      (int32_t*)out_n, G, limit, R};
  return histore::launch_range(p, cap, fanout, levels, stream);
}

}  // namespace

// queries, keys: [Q] and [cap] int32; addrs: [cap] int32; out_*: [Q]
// int32
extern "C" int histore_sorted_search(const void* queries, const void* keys,
                                     const void* addrs, void* out_addr,
                                     void* out_found, void* out_acc,
                                     void* out_pos, void* out_lb,
                                     long long Q, long long cap, int fanout,
                                     int levels, void* stream) {
  return histore::launch_search<int32_t>(
      queries, keys, addrs, out_addr, out_found, out_acc, out_pos, out_lb,
      Q, cap, fanout, levels, stream);
}

// the same for int64 queries and keys
extern "C" int histore_sorted_search_i64(const void* queries,
                                         const void* keys, const void* addrs,
                                         void* out_addr, void* out_found,
                                         void* out_acc, void* out_pos,
                                         void* out_lb, long long Q,
                                         long long cap, int fanout,
                                         int levels, void* stream) {
  return histore::launch_search<int64_t>(
      queries, keys, addrs, out_addr, out_found, out_acc, out_pos, out_lb,
      Q, cap, fanout, levels, stream);
}

// keys / addrs: the replica of group g, replica r at element offset
// r * ks_r + g * ks_g (as_r, as_g); lo / hi: group g's at g * lo_s
// (hi_s); out_k: keys [G, R, limit]; out_a: addrs [G, R, limit] int32;
// out_n: counts [G, R] int32.  Keys, lo, hi and out_k int32.
extern "C" int histore_range_query(const void* keys, const void* addrs,
                                   long long ks_r, long long ks_g,
                                   long long as_r, long long as_g,
                                   const void* lo, long long lo_s,
                                   const void* hi, long long hi_s,
                                   void* out_k, void* out_a, void* out_n,
                                   long long G, int R, long long cap,
                                   int fanout, int levels, long long limit,
                                   void* stream) {
  return range_query<int32_t>(keys, addrs, ks_r, ks_g, as_r, as_g, lo, lo_s,
                              hi, hi_s, out_k, out_a, out_n, G, R, cap,
                              fanout, levels, limit, stream);
}

// the same with int64 keys, lo, hi and out_k
extern "C" int histore_range_query_i64(const void* keys, const void* addrs,
                                       long long ks_r, long long ks_g,
                                       long long as_r, long long as_g,
                                       const void* lo, long long lo_s,
                                       const void* hi, long long hi_s,
                                       void* out_k, void* out_a, void* out_n,
                                       long long G, int R, long long cap,
                                       int fanout, int levels,
                                       long long limit, void* stream) {
  return range_query<int64_t>(keys, addrs, ks_r, ks_g, as_r, as_g, lo, lo_s,
                              hi, hi_s, out_k, out_a, out_n, G, R, cap,
                              fanout, levels, limit, stream);
}
