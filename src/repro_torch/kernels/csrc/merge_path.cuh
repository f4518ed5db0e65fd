// Merge-path partitions and stable rank merges of int32 keys, shared by
// merge_sort.cuh (the rowwise stable sort) and merge.cu (the async apply).
//
// Every merge here is STABLE with the left run A first: A[x] precedes
// B[y] iff A[x] <= B[y].  So an element of A lands at x + #(B < A[x]) and
// an element of B at y + #(A <= B[y]) of the merged run.
//
//  * warp_merge_path: how many of the first d merged elements come from A,
//    for two sorted runs in device memory.  One warp runs a 32-ary
//    search: each round every lane tests one of 32 evenly spaced
//    candidates, so a range of n candidates takes ceil(log32 n) rounds of
//    dependent reads (5 at n = 2^24, 3 at 2^15) where a binary search
//    takes log2 n.
//  * ranks: a thread's ranks of N keys in one sorted shared-memory run.
//  * merge_n: a thread's N consecutive outputs of a stable merge of two
//    runs in shared memory, by a bisection and a serial merge.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace histore {

// rank[k] = #(a[0, n) < key[k]), or #(a[0, n) <= key[k]) with LEQ, for a
// thread's N keys at once: branch-free bisections in lockstep, so the N
// reads of a step are in flight together.
template <int N, bool LEQ>
__device__ __forceinline__ void ranks(const int32_t* a, int n,
                                      const int32_t* key, int* rank) {
#pragma unroll
  for (int k = 0; k < N; ++k) rank[k] = 0;
  if (n <= 0) return;
  for (; n > 1; n -= n >> 1) {
    const int h = n >> 1;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int32_t v = a[rank[k] + h];
      rank[k] += (LEQ ? v <= key[k] : v < key[k]) ? h : 0;
    }
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int32_t v = a[rank[k]];
    rank[k] += LEQ ? v <= key[k] : v < key[k];
  }
}

// Shared-memory index with one word of padding every 32: a thread that
// stores N consecutive entries then hits distinct banks.
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// The N entries from position d on of the stable merge of sorted runs
// A = [a0, a0 + na) and B = [b0, b0 + nb) of the shared arrays k / v
// (padded indices), A first on equal keys: a bisection for the split,
// then N steps of a serial merge.  Past the end of the merge the outputs
// are unspecified.
template <int N>
__device__ __forceinline__ void merge_n(const int32_t* k, const int32_t* v,
                                        int a0, int na, int b0, int nb,
                                        int d, int32_t* ok, int32_t* ov) {
  int lo = d > nb ? d - nb : 0, hi = d < na ? d : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (k[pad(a0 + mid)] <= k[pad(b0 + d - 1 - mid)]) lo = mid + 1;
    else hi = mid;
  }
  int i = lo, j = d - lo;
  int32_t x = i < na ? k[pad(a0 + i)] : 0;
  int32_t y = j < nb ? k[pad(b0 + j)] : 0;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const bool take_a = j >= nb || (i < na && x <= y);
    ok[n] = take_a ? x : y;
    if (take_a) {
      ov[n] = i < na ? v[pad(a0 + i)] : 0;
      ++i;
      x = i < na ? k[pad(a0 + i)] : 0;
    } else {
      ov[n] = v[pad(b0 + j)];
      ++j;
      y = j < nb ? k[pad(b0 + j)] : 0;
    }
  }
}

// The merge-path split of diagonal d (0 <= d <= a + b) of the stable
// merge of sorted runs A[0, a) and B[0, b): the number i of A's elements
// among the first d merged ones (then d - i of B's).  i is the least
// candidate in [max(0, d - b), min(d, a)] with A[i] > B[d - 1 - i]; the
// test is true below i and false from i on.  Every lane of the warp
// calls it and gets the same i.
__device__ __forceinline__ long long warp_merge_path(const int32_t* A,
                                                     long long a,
                                                     const int32_t* B,
                                                     long long b,
                                                     long long d) {
  const int lane = threadIdx.x & 31;
  long long lo = d > b ? d - b : 0;
  long long hi = d < a ? d : a;
  while (hi > lo) {
    // lane l tests candidate lo + (l + 1) step - 1; candidates past hi
    // count as false, so the lanes that test true are a prefix
    const long long step = (hi - lo + 31) >> 5;
    const long long q = lo + (lane + 1) * step - 1;
    const bool before = q < hi && A[q] <= B[d - 1 - q];
    const int c = __popc(__ballot_sync(0xffffffffu, before));
    const long long last_true = lo + c * step - 1;  // candidate of lane c-1
    const long long first_false = last_true + step;  // candidate of lane c
    if (first_false < hi) hi = first_false;
    lo = last_true + 1;
  }
  return lo;
}

}  // namespace histore
