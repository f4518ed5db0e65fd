// Rowwise bitonic sort of packed 64-bit (key, payload) pairs: the network
// of bitonic_sort.cu alone (mirror of src/repro/kernels/_bitonic_sort.py:42),
// kept step for step with JAX's, because the network is not stable and
// the payloads of tied keys must land where JAX's puts them.
//
// Each element packs (key ^ 0x80000000) << 32 | payload, so unsigned order
// of the high half is the signed order of the key; the compares read the
// high half only, and ties keep whatever place the network gives them.
//
// The network over a row of T = 2^n elements is JAX's, step for step:
// stages k = 2, 4, ... T; distances j = k / 2 ... 1; the pair (i, i + j)
// with bit j of i clear swaps when ((i & k) == 0 ? lo > hi : lo < hi).
// The pairs of one step are disjoint, so any thread order inside a step
// gives the same bits, ties included.
//
// sort_rows runs it in place on a [R, T] device array:
//  * T <= SORT_CHUNK (16384 elements, 128 KB of shared memory): one block
//    a row loads it into shared memory, runs every step there, and
//    stores it back.
//  * larger T: one block per 16384-element chunk runs the stages
//    k <= 16384 in shared memory; then for each larger stage k, one
//    global pass a distance j >= 16384 (a thread a pair), and one
//    shared-memory pass per chunk for the distances below.
// Bound: bytes.  The shared-memory path reads and writes the row once;
// each larger stage adds a round trip per global distance and one for the
// chunk pass.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace histore {

constexpr int SORT_CHUNK = 16384;
constexpr int SORT_THREADS = 1024;
constexpr int STEP_THREADS = 256;

typedef unsigned long long u64;

__device__ __forceinline__ u64 pack_pair(int32_t key, uint32_t payload) {
  return (u64(uint32_t(key) ^ 0x80000000u) << 32) | payload;
}

__device__ __forceinline__ int32_t pair_key(u64 v) {
  return int32_t(uint32_t(v >> 32) ^ 0x80000000u);
}

__device__ __forceinline__ bool after(u64 a, u64 b) {
  return (a >> 32) > (b >> 32);
}

// the steps j = j0 ... 1 of stage k on the shared tile s[0, n) whose
// first element is element `base` of its row
__device__ void tile_steps(u64* s, int n, long long base, long long k,
                           int j0) {
  for (int j = j0; j > 0; j >>= 1) {
    for (int p = threadIdx.x; p < n / 2; p += blockDim.x) {
      const int lo = (p / j) * 2 * j + (p % j);
      const int hi = lo + j;
      const bool up = ((base + lo) & k) == 0;
      const u64 a = s[lo], b = s[hi];
      if (up ? after(a, b) : after(b, a)) {
        s[lo] = b;
        s[hi] = a;
      }
    }
    __syncthreads();
  }
}

// one block per C-element chunk of a row: every stage k <= C (kmerge ==
// 0), or the distances below C of stage kmerge
__global__ void chunk_kernel(u64* __restrict__ d, long long T, int C,
                             long long kmerge) {
  extern __shared__ u64 s[];
  const long long per_row = T / C;
  const long long r = blockIdx.x / per_row, c = blockIdx.x % per_row;
  u64* g = d + r * T + c * C;
  const long long base = c * C;
  for (int i = threadIdx.x; i < C; i += blockDim.x) s[i] = g[i];
  __syncthreads();
  if (kmerge == 0) {
    for (long long k = 2; k <= C; k <<= 1)
      tile_steps(s, C, base, k, int(k / 2));
  } else {
    tile_steps(s, C, base, kmerge, C / 2);
  }
  for (int i = threadIdx.x; i < C; i += blockDim.x) g[i] = s[i];
}

// one step (stage k, distance j) over every row, a thread a pair
__global__ void global_step(u64* __restrict__ d, long long R, long long T,
                            long long k, long long j) {
  const long long half = T / 2, pairs = R * half;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < pairs; t += (long long)gridDim.x * blockDim.x) {
    const long long r = t / half, p = t % half;
    const long long lo = (p / j) * 2 * j + (p % j), hi = lo + j;
    const bool up = (lo & k) == 0;
    u64* row = d + r * T;
    const u64 a = row[lo], b = row[hi];
    if (up ? after(a, b) : after(b, a)) {
      row[lo] = b;
      row[hi] = a;
    }
  }
}

// sort each row of d [R, T] in place (T a power of two) on stream st
inline cudaError_t sort_rows(u64* d, long long R, long long T,
                             cudaStream_t st) {
  if (R < 1 || T < 2) return cudaSuccess;
  const int C = T < SORT_CHUNK ? int(T) : SORT_CHUNK;
  const long long blocks = R * (T / C);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int threads = C / 2 < 32 ? 32
                      : (C / 2 > SORT_THREADS ? SORT_THREADS : C / 2);
  const size_t smem = size_t(C) * sizeof(u64);
  cudaError_t e = cudaFuncSetAttribute(
      chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (e != cudaSuccess) return e;
  chunk_kernel<<<unsigned(blocks), threads, smem, st>>>(d, T, C, 0);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const long long pairs = R * (T / 2);
  long long gblocks = (pairs + STEP_THREADS - 1) / STEP_THREADS;
  if (gblocks > 65536) gblocks = 65536;
  for (long long k = 2LL * C; k <= T; k <<= 1) {
    for (long long j = k / 2; j >= C; j >>= 1) {
      global_step<<<unsigned(gblocks), STEP_THREADS, 0, st>>>(d, R, T,
                                                                     k, j);
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
    }
    chunk_kernel<<<unsigned(blocks), threads, smem, st>>>(d, T, C, k);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace histore
