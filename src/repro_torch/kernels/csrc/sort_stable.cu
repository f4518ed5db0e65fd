// Rowwise stable (key, payload) sort, for sm_90a.
//
// Replaces: src/repro/kernels/_fused.py:442 sort_pairs_stable_kernel
// (body _sort_stable_body, :431, over _bitonic_multi :157).  Bit-exact with
// repro_torch.kernels.ops.sort_stable_plain (torch.sort(stable=True) and a
// gather): a stable sort's order is (key, column index), a total order,
// so every correct stable sort gives the Pallas network's bits.
//
// Bound: bytes, 16 B an entry (key and payload read once, both written
// once); the O(T log T) compares of a merge sort are far below it.
//
// Design: merge_sort.cuh's stable merge sort.  One block a 2048-entry
// tile sorts it in registers and shared memory (8 entries a thread, then
// 8 rounds of pairwise merges in which each thread finds its 8 outputs by
// a bisection and merges them serially); then log2(T / 2048) merge passes
// cut every pair of runs of every row into 2048-entry output slices with
// merge-path partitions (merge_path.cuh), one block a slice.  The passes
// are chained with programmatic dependent launch (pdl.cuh).  Why: JAX's
// bitonic network, which this kernel ran before, does O(T log^2 T)
// compare-exchanges with a barrier after each of its 105 steps at T =
// 16384, needs the column packed beside the key to be stable and the
// payload gathered after, and ran a whole row in one block (1 SM of 132
// at [1, 16384]).  A merge sort is stable by construction (keys and
// payloads move together, ties keep their input order), does O(1) work
// an entry a round, spreads every pass over R * T / 2048 blocks whatever
// R is, and takes any T without padding to a power of two.  A stable LSD
// radix sort would also do; a merge sort was taken because its passes
// share the merge-path partition with the async-apply merge (merge.cu),
// which sorts its batch with it.  It moves 16 B an entry a launch, 16 (1 +
// log2(T / 2048)) B an entry in all; the passes over rows of up to about
// 2^21 entries in all stay in the 50 MB L2.
#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_sort.cuh"

namespace histore {

// the sort's loader: entry i of row r of keys / vals [R, T]
struct RowLoad {
  const int32_t* keys;
  const int32_t* vals;
  long long T;
  __device__ __forceinline__ void operator()(long long r, long long i,
                                             int32_t& k, int32_t& v) const {
    k = keys[r * T + i];
    v = vals[r * T + i];
  }
};

}  // namespace histore

// bytes of scratch histore_sort_stable needs for [R, T]
extern "C" long long histore_sort_stable_scratch_bytes(long long R,
                                                       long long T) {
  return T > histore::MS_TILE ? R * T * 8 : 0;
}

// keys, vals, out_keys, out_vals: [R, T] int32; scratch: the bytes
// histore_sort_stable_scratch_bytes(R, T) asks for.
extern "C" int histore_sort_stable(const void* keys, const void* vals,
                                   void* out_keys, void* out_vals,
                                   void* scratch, long long R, long long T,
                                   void* stream) {
  if (R < 0 || T < 0) return (int)cudaErrorInvalidValue;
  if (R == 0 || T == 0) return (int)cudaGetLastError();
  int32_t* sk = (int32_t*)scratch;
  const histore::RowLoad load{(const int32_t*)keys, (const int32_t*)vals,
                              T};
  return (int)histore::stable_sort_rows(
      load, R, T, (int32_t*)out_keys, (int32_t*)out_vals, sk,
      sk == nullptr ? nullptr : sk + R * T, (cudaStream_t)stream);
}
