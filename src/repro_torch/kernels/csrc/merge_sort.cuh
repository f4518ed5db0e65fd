// Rowwise stable sort of (int32 key, int32 payload) pairs, shared by
// sort_stable.cu and merge.cu (the apply batch's sort by key, arrival).
//
// A merge sort, stable by construction: keys and payloads move together
// and ties keep their input order, so no (key, index) packing and no
// payload gather are needed.
//  1. tile_sort_kernel: one block per tile of MS_TILE = 2048 entries of a
//     row (rows are cut into tiles; a row's last tile may be short).  Each
//     thread sorts its 8 entries in registers by odd-even transposition
//     (swaps on a strict >, so stable), then 8 rounds in shared memory
//     merge runs of 8, 16, ... 1024 pairwise: each thread finds where its
//     8 outputs start with a bisection and merges them serially
//     (merge_path.cuh's merge_n), O(1) work an entry a round.  A short
//     tile is padded with key INT32_MAX after its entries; stability keeps
//     the padding after a real INT32_MAX, and it is never stored.
//  2. merge_pass_kernel, once per doubling of the run length W = 2048,
//     4096, ... < T: every pair of runs of every row at once is cut into
//     MS_TILE-entry slices of the output, one block a slice.  A block
//     finds its slice's two ends with warp_merge_path (one warp each),
//     loads the two pieces into shared memory, merges them as in 1, and
//     stores the slice.  Runs at a ragged row end are
//     short; a run with no partner is copied.
// The two buffers alternate so that the last launch writes the output,
// and the launches are chained with programmatic dependent launch
// (pdl.cuh).  Every launch has R * ceil(T / 2048) blocks, so the card
// fills even at R = 1 from T = 2^18 (at T = 65536: 32 blocks and 5
// passes over 512 KB that stay in the 50 MB L2).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_path.cuh"
#include "pdl.cuh"

namespace histore {

constexpr int MS_THREADS = 256;
constexpr int MS_ITEMS = 8;
constexpr int MS_TILE = MS_THREADS * MS_ITEMS;
constexpr int32_t MS_PAD = 0x7fffffff;

template <class Load>
__global__ void __launch_bounds__(MS_THREADS)
    tile_sort_kernel(Load load, int32_t* __restrict__ ok,
                     int32_t* __restrict__ ov, long long T,
                     long long tiles_per_row) {
  __shared__ int32_t sk[MS_TILE + MS_TILE / 32];
  __shared__ int32_t sv[MS_TILE + MS_TILE / 32];
  const int tid = threadIdx.x;
  pdl_trigger();
  pdl_wait();
  const long long r = blockIdx.x / tiles_per_row;
  const long long base = (blockIdx.x % tiles_per_row) * MS_TILE;
  const int n = T - base < MS_TILE ? int(T - base) : MS_TILE;
  // every load first (coalesced), then the stores to shared memory
  int32_t key[MS_ITEMS], val[MS_ITEMS];
#pragma unroll
  for (int k = 0; k < MS_ITEMS; ++k) {
    const int x = k * MS_THREADS + tid;
    load(r, base + (x < n ? x : n - 1), key[k], val[k]);
  }
#pragma unroll
  for (int k = 0; k < MS_ITEMS; ++k) {
    const int x = k * MS_THREADS + tid;
    sk[pad(x)] = x < n ? key[k] : MS_PAD;
    sv[pad(x)] = val[k];
  }
  __syncthreads();
  // this thread's run: entries tid MS_ITEMS ... + MS_ITEMS - 1
  const int d = tid * MS_ITEMS;
#pragma unroll
  for (int k = 0; k < MS_ITEMS; ++k) {
    key[k] = sk[pad(d + k)];
    val[k] = sv[pad(d + k)];
  }
#pragma unroll
  for (int p = 0; p < MS_ITEMS; ++p) {
#pragma unroll
    for (int k = p & 1; k + 1 < MS_ITEMS; k += 2) {
      if (key[k] > key[k + 1]) {
        const int32_t tk = key[k], tv = val[k];
        key[k] = key[k + 1];
        val[k] = val[k + 1];
        key[k + 1] = tk;
        val[k + 1] = tv;
      }
    }
  }
  // runs of 8, 16, ... merged pairwise; a thread makes its 8 outputs
  for (int run = MS_ITEMS; run < MS_TILE; run <<= 1) {
    __syncthreads();
#pragma unroll
    for (int k = 0; k < MS_ITEMS; ++k) {
      sk[pad(d + k)] = key[k];
      sv[pad(d + k)] = val[k];
    }
    __syncthreads();
    const int start = d & ~(2 * run - 1);
    merge_n<MS_ITEMS>(sk, sv, start, run, start + run, run, d - start, key,
                      val);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < MS_ITEMS; ++k) {
    sk[pad(d + k)] = key[k];
    sv[pad(d + k)] = val[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < MS_ITEMS; ++k) {
    const int x = k * MS_THREADS + tid;
    key[k] = sk[pad(x)];
    val[k] = sv[pad(x)];
  }
#pragma unroll
  for (int k = 0; k < MS_ITEMS; ++k) {
    const int x = k * MS_THREADS + tid;
    if (x < n) {
      ok[r * T + base + x] = key[k];
      ov[r * T + base + x] = val[k];
    }
  }
}

// one merge pass: runs of W (a multiple of MS_TILE) of ik / iv [R, T]
// merged pairwise into ok / ov
__global__ void __launch_bounds__(MS_THREADS)
    merge_pass_kernel(const int32_t* __restrict__ ik,
                      const int32_t* __restrict__ iv,
                      int32_t* __restrict__ ok, int32_t* __restrict__ ov,
                      long long T, long long W, long long tiles_per_row) {
  __shared__ int32_t sk[MS_TILE + MS_TILE / 32];
  __shared__ int32_t sv[MS_TILE + MS_TILE / 32];
  __shared__ long long split[2];
  const int tid = threadIdx.x;
  pdl_trigger();
  pdl_wait();
  const long long r = blockIdx.x / tiles_per_row;
  const long long base = (blockIdx.x % tiles_per_row) * MS_TILE;
  const int n = T - base < MS_TILE ? int(T - base) : MS_TILE;
  const long long s = base & ~(2 * W - 1);          // the pair's start
  const long long a = T - s < W ? T - s : W;
  const long long b = T - s - a < W ? T - s - a : W;
  const int32_t* A = ik + r * T + s;
  const int32_t* B = A + a;
  const long long d0 = base - s;
  if (tid < 64) {
    const long long i = warp_merge_path(A, a, B, b, d0 + (tid >> 5) * n);
    if ((tid & 31) == 0) split[tid >> 5] = i;
  }
  __syncthreads();
  const long long i0 = split[0], j0 = d0 - i0;
  const int na = int(split[1] - i0);
  const int nb = n - na;
  const int32_t* Av = iv + r * T + s;
  const int32_t* Bv = Av + a;
  // every load first (past n, A[0] again), then the stores to shared
  // memory: the slice's piece of A, then its piece of B
  int32_t key[MS_ITEMS], val[MS_ITEMS];
#pragma unroll
  for (int k = 0; k < MS_ITEMS; ++k) {
    const int x = k * MS_THREADS + tid;
    const bool in_b = x >= na && x < n;
    const long long at = x < na ? i0 + x : (in_b ? j0 + x - na : 0);
    key[k] = (in_b ? B : A)[at];
    val[k] = (in_b ? Bv : Av)[at];
  }
#pragma unroll
  for (int k = 0; k < MS_ITEMS; ++k) {
    const int x = k * MS_THREADS + tid;
    if (x < n) {
      sk[pad(x)] = key[k];
      sv[pad(x)] = val[k];
    }
  }
  __syncthreads();
  const int d = tid * MS_ITEMS;
  if (d < n) merge_n<MS_ITEMS>(sk, sv, 0, na, na, nb, d, key, val);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < MS_ITEMS; ++k) {
    sk[pad(d + k)] = key[k];
    sv[pad(d + k)] = val[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < MS_ITEMS; ++k) {
    const int x = k * MS_THREADS + tid;
    key[k] = sk[pad(x)];
    val[k] = sv[pad(x)];
  }
#pragma unroll
  for (int k = 0; k < MS_ITEMS; ++k) {
    const int x = k * MS_THREADS + tid;
    if (x < n) {
      ok[r * T + base + x] = key[k];
      ov[r * T + base + x] = val[k];
    }
  }
}

// the merge passes after the tile sort: W = MS_TILE, 2 MS_TILE, ... < T
inline int merge_passes(long long T) {
  int p = 0;
  for (long long W = MS_TILE; W < T; W <<= 1) ++p;
  return p;
}

// Sort each row of the [R, T] pairs that load(r, i, key, val) yields
// into ok / ov [R, T], on stream st.  sk / sv: [R, T] scratch, used only
// when T > MS_TILE.
template <class Load>
cudaError_t stable_sort_rows(Load load, long long R, long long T,
                             int32_t* ok, int32_t* ov, int32_t* sk,
                             int32_t* sv, cudaStream_t st) {
  if (R < 1 || T < 1) return cudaSuccess;
  const long long tiles = (T + MS_TILE - 1) / MS_TILE;
  if (R * tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned blocks = unsigned(R * tiles);
  const int passes = merge_passes(T);
  // the buffers alternate so that the last launch writes ok / ov
  int32_t* dk[2] = {ok, sk};
  int32_t* dv[2] = {ov, sv};
  int cur = passes & 1;
  cudaError_t e = launch(tile_sort_kernel<Load>, blocks, MS_THREADS, st,
                         load, dk[cur], dv[cur], T, tiles);
  for (long long W = MS_TILE; e == cudaSuccess && W < T; W <<= 1) {
    e = launch(merge_pass_kernel, blocks, MS_THREADS, st, dk[cur], dv[cur],
               dk[cur ^ 1], dv[cur ^ 1], T, W, tiles);
    cur ^= 1;
  }
  return e;
}

}  // namespace histore
