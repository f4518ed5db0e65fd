// Rowwise bitonic sort of (int32 key, int32 payload) pairs: the network of
// bitonic_sort.cu (mirror of src/repro/kernels/_bitonic_sort.py:42), kept
// compare-exchange for compare-exchange with JAX's, because the network
// is not stable and the payloads of tied keys must land where JAX's puts
// them.
//
// The network over a row of T = 2^n elements: stages k = 2, 4, ... T;
// distances j = k / 2 ... 1; the pair (i, i + j) with bit j of i clear
// swaps when ((i & k) == 0 ? key_lo > key_hi : key_lo < key_hi).  The
// pairs of one step are disjoint, and a run of steps over a set of
// elements closed under their distances touches nothing else, so any
// schedule that applies each element's compare-exchanges in step order
// gives the same bits, ties included.  Only the schedule differs from
// JAX's:
//  * a block holds a chunk of BS_CHUNK = 2048 elements, 8 a thread in
//    registers: distances 1, 2, 4 within a thread's 8 consecutive
//    elements (layout A), 8 ... 128 between lanes by __shfl_xor_sync,
//    256, 512, 1024 in registers after a transpose through shared memory
//    to layout B (a thread's 8 elements 256 apart) and back;
//  * bs_local_kernel: every stage k <= min(T, 2048) of each chunk, read
//    from the input and written to the output (a chunk holds 2048 / T
//    rows when T < 2048; rows past R are masked), so a row of 16384 runs
//    on 8 SMs, not one;
//  * for each stage k > 2048: bs_global_kernel passes over the
//    distances k / 2 ... 2048, up to BS_GBITS of them a pass, each thread
//    holding the 2^m elements of a closed sub-network (stride the pass's
//    smallest distance) in registers; then bs_chunk_kernel runs the
//    distances 1024 ... 1 in each chunk as above;
//  * keys and payloads stay two int32 arrays, read and written in place
//    in the output: no packing, no scratch; the launches are chained with
//    programmatic dependent launch (pdl.cuh).
// Launches: 1 for T <= 2048; at T = 16384, 7; at T = 65536, 13.
// Bound: bytes, 16 B an entry (key and payload read once and written
// once); this schedule moves each entry through L2 once a pass, 1 + 2
// passes a stage above 2048 (+1 at the stages with 4 or more global
// distances).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "pdl.cuh"

namespace histore {

constexpr int BS_THREADS = 256;
constexpr int BS_E = 8;                      // elements a thread
constexpr int BS_CHUNK = BS_THREADS * BS_E;  // 2048
constexpr int BS_GBITS = 3;                  // distances a global pass

struct BsTile {
  int32_t k[BS_CHUNK + BS_CHUNK / 32];
  int32_t v[BS_CHUNK + BS_CHUNK / 32];
};

// one word of padding every 32: both layouts' accesses are free of bank
// conflicts
__device__ __forceinline__ int bs_pad(int x) { return x + (x >> 5); }

// the compare-exchange of the pair (lower a, upper b) of a stage
// ascending (up) or descending
__device__ __forceinline__ void bs_cx(int32_t& ka, int32_t& va, int32_t& kb,
                                      int32_t& vb, bool up) {
  const bool s = up ? ka > kb : ka < kb;
  const int32_t k0 = ka, v0 = va;
  ka = s ? kb : ka;
  va = s ? vb : va;
  kb = s ? k0 : kb;
  vb = s ? v0 : vb;
}

// layout A: thread t holds chunk elements 8 t + e; layout B: 256 e + t
__device__ __forceinline__ void bs_a_to_b(int32_t (&k)[BS_E],
                                          int32_t (&v)[BS_E], BsTile& s) {
  const int t = threadIdx.x;
#pragma unroll
  for (int e = 0; e < BS_E; ++e) {
    s.k[bs_pad(BS_E * t + e)] = k[e];
    s.v[bs_pad(BS_E * t + e)] = v[e];
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < BS_E; ++e) {
    k[e] = s.k[bs_pad(BS_THREADS * e + t)];
    v[e] = s.v[bs_pad(BS_THREADS * e + t)];
  }
  __syncthreads();
}

__device__ __forceinline__ void bs_b_to_a(int32_t (&k)[BS_E],
                                          int32_t (&v)[BS_E], BsTile& s) {
  const int t = threadIdx.x;
#pragma unroll
  for (int e = 0; e < BS_E; ++e) {
    s.k[bs_pad(BS_THREADS * e + t)] = k[e];
    s.v[bs_pad(BS_THREADS * e + t)] = v[e];
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < BS_E; ++e) {
    k[e] = s.k[bs_pad(BS_E * t + e)];
    v[e] = s.v[bs_pad(BS_E * t + e)];
  }
  __syncthreads();
}

// Where a thread's elements sit in their rows: element e is at row index
// (ia + e) & tm in layout A and (ib + 256 e) & tm in layout B (tm = T - 1)
struct BsPlace {
  int ia, ib, tm;
};

__device__ __forceinline__ BsPlace bs_place(long long f0, long long T) {
  const long long t = threadIdx.x;
  return BsPlace{int((f0 + BS_E * t) & (T - 1)), int((f0 + t) & (T - 1)),
                 int(T - 1)};
}

// distance B (1, 2, 4) in layout A, or 256 B in layout B, of stage kk
template <int B, bool LAYOUT_B>
__device__ __forceinline__ void bs_reg_step(int32_t (&k)[BS_E],
                                            int32_t (&v)[BS_E],
                                            const BsPlace& at, int kk) {
#pragma unroll
  for (int e = 0; e < BS_E; ++e) {
    if (e & B) continue;
    const int i = LAYOUT_B ? (at.ib + BS_THREADS * e) & at.tm
                           : (at.ia + e) & at.tm;
    bs_cx(k[e], v[e], k[e | B], v[e | B], (i & kk) == 0);
  }
}

// distance j (8 ... 128) of stage kk (>= 16) in layout A: lanes j / 8
// apart.  A thread's 8 elements share the stage's direction, so each
// takes its partner's entry when the partner's key is the one its
// position keeps (strictly: ties stay)
__device__ __forceinline__ void bs_shfl_step(int32_t (&k)[BS_E],
                                             int32_t (&v)[BS_E],
                                             const BsPlace& at, int kk,
                                             int j) {
  const int m = j / BS_E;
  const bool lower = (threadIdx.x & m) == 0;
  const bool keep_min = lower == ((at.ia & kk) == 0);
#pragma unroll
  for (int e = 0; e < BS_E; ++e) {
    const int32_t pk = __shfl_xor_sync(0xffffffffu, k[e], m);
    const int32_t pv = __shfl_xor_sync(0xffffffffu, v[e], m);
    const bool take = pk != k[e] && ((pk < k[e]) == keep_min);
    k[e] = take ? pk : k[e];
    v[e] = take ? pv : v[e];
  }
}

// the distances jtop ... 1 (jtop < 2048) of stage kk on a chunk held in
// layout A (in layout B when in_b: then jtop = 1024); ends in layout A
__device__ __forceinline__ void bs_stage(int32_t (&k)[BS_E],
                                         int32_t (&v)[BS_E], BsTile& s,
                                         const BsPlace& at, int kk, int jtop,
                                         bool in_b) {
  int j = jtop;
  if (j >= BS_THREADS) {
    if (!in_b) bs_a_to_b(k, v, s);
    if (j >= 4 * BS_THREADS) bs_reg_step<4, true>(k, v, at, kk);
    if (j >= 2 * BS_THREADS) bs_reg_step<2, true>(k, v, at, kk);
    bs_reg_step<1, true>(k, v, at, kk);
    bs_b_to_a(k, v, s);
    j = BS_THREADS / 2;
  }
  for (; j >= BS_E; j >>= 1) bs_shfl_step(k, v, at, kk, j);
  if (j >= 4) bs_reg_step<4, false>(k, v, at, kk);
  if (j >= 2) bs_reg_step<2, false>(k, v, at, kk);
  bs_reg_step<1, false>(k, v, at, kk);
}

// the chunk's elements in layout A to ok / ov (16-byte aligned), those
// below n
__device__ __forceinline__ void bs_store_a(int32_t* __restrict__ ok,
                                           int32_t* __restrict__ ov,
                                           const int32_t (&k)[BS_E],
                                           const int32_t (&v)[BS_E],
                                           long long f0, long long n) {
  const long long f = f0 + BS_E * (long long)threadIdx.x;
  if (f + BS_E <= n) {
    int4* pk = reinterpret_cast<int4*>(ok + f);
    int4* pv = reinterpret_cast<int4*>(ov + f);
    pk[0] = make_int4(k[0], k[1], k[2], k[3]);
    pk[1] = make_int4(k[4], k[5], k[6], k[7]);
    pv[0] = make_int4(v[0], v[1], v[2], v[3]);
    pv[1] = make_int4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int e = 0; e < BS_E; ++e) {
      if (f + e < n) {
        ok[f + e] = k[e];
        ov[f + e] = v[e];
      }
    }
  }
}

// every stage k <= min(T, 2048) of chunk blockIdx.x, input to output
__global__ void __launch_bounds__(BS_THREADS)
    bs_local_kernel(const int32_t* __restrict__ keys,
                    const int32_t* __restrict__ vals,
                    int32_t* __restrict__ ok, int32_t* __restrict__ ov,
                    long long n, long long T) {
  __shared__ BsTile s;
  pdl_trigger();
  pdl_wait();
  const long long f0 = (long long)blockIdx.x * BS_CHUNK;
  int32_t k[BS_E], v[BS_E];
#pragma unroll
  for (int e = 0; e < BS_E; ++e) {  // layout B: coalesced, any alignment
    const long long f = f0 + BS_THREADS * e + threadIdx.x;
    k[e] = f < n ? keys[f] : 0;
    v[e] = f < n ? vals[f] : 0;
  }
  bs_b_to_a(k, v, s);
  const BsPlace at = bs_place(f0, T);
  const int K = T < BS_CHUNK ? int(T) : BS_CHUNK;
  for (int kk = 2; kk <= K; kk <<= 1) bs_stage(k, v, s, at, kk, kk / 2, false);
  bs_store_a(ok, ov, k, v, f0, n);
}

// the distances 1024 ... 1 of stage kk > 2048 in chunk blockIdx.x
__global__ void __launch_bounds__(BS_THREADS)
    bs_chunk_kernel(int32_t* __restrict__ ok, int32_t* __restrict__ ov,
                    long long n, long long T, long long kk) {
  __shared__ BsTile s;
  pdl_trigger();
  pdl_wait();
  const long long f0 = (long long)blockIdx.x * BS_CHUNK;
  int32_t k[BS_E], v[BS_E];
#pragma unroll
  for (int e = 0; e < BS_E; ++e) {
    const long long f = f0 + BS_THREADS * e + threadIdx.x;
    k[e] = ok[f];
    v[e] = ov[f];
  }
  bs_stage(k, v, s, bs_place(f0, T), int(kk), BS_CHUNK / 2, true);
  bs_store_a(ok, ov, k, v, f0, n);
}

// the M distances jlo << (M - 1) ... jlo (>= 2048) of stage kk: a thread
// the 2^M elements whose flat index differs in bits [log jlo, + M)
template <int M>
__global__ void __launch_bounds__(BS_THREADS)
    bs_global_kernel(int32_t* __restrict__ ok, int32_t* __restrict__ ov,
                     long long n, long long T, long long kk, int lj) {
  constexpr int E = 1 << M;
  pdl_trigger();
  pdl_wait();
  const long long g = (long long)blockIdx.x * BS_THREADS + threadIdx.x;
  if (g >= (n >> M)) return;
  const long long low = g & ((1LL << lj) - 1);
  const long long f0 = ((g >> lj) << (lj + M)) | low;
  int32_t k[E], v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    k[e] = ok[f0 + ((long long)e << lj)];
    v[e] = ov[f0 + ((long long)e << lj)];
  }
#pragma unroll
  for (int b = M - 1; b >= 0; --b) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (e & (1 << b)) continue;
      const int i = int((f0 + ((long long)e << lj)) & (T - 1));
      bs_cx(k[e], v[e], k[e | (1 << b)], v[e | (1 << b)],
            (i & int(kk)) == 0);
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    ok[f0 + ((long long)e << lj)] = k[e];
    ov[f0 + ((long long)e << lj)] = v[e];
  }
}

inline cudaError_t bs_global(int m, unsigned blocks, cudaStream_t st,
                             int32_t* ok, int32_t* ov, long long n,
                             long long T, long long kk, int lj) {
  switch (m) {
    case 1:
      return launch(bs_global_kernel<1>, blocks, BS_THREADS, st, ok, ov, n,
                    T, kk, lj);
    case 2:
      return launch(bs_global_kernel<2>, blocks, BS_THREADS, st, ok, ov, n,
                    T, kk, lj);
    default:
      return launch(bs_global_kernel<3>, blocks, BS_THREADS, st, ok, ov, n,
                    T, kk, lj);
  }
}

// sort each row of keys / vals [R, T] (T a power of two) into ok / ov
// (16-byte aligned) on stream st
inline cudaError_t sort_rows(const int32_t* keys, const int32_t* vals,
                             int32_t* ok, int32_t* ov, long long R,
                             long long T, cudaStream_t st) {
  const long long n = R * T;
  if (n == 0) return cudaSuccess;
  const long long blocks = (n + BS_CHUNK - 1) / BS_CHUNK;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t e = launch(bs_local_kernel, unsigned(blocks), BS_THREADS, st,
                         keys, vals, ok, ov, n, T);
  int lt = 0;
  while ((1LL << lt) < T) ++lt;
  for (int lk = 12; lk <= lt && e == cudaSuccess; ++lk) {
    const long long kk = 1LL << lk;
    // the distances 2^(lk - 1) ... 2^11, up to BS_GBITS a pass
    for (int hb = lk - 1; hb >= 11 && e == cudaSuccess;) {
      const int m = hb - 10 < BS_GBITS ? hb - 10 : BS_GBITS;
      const long long threads = n >> m;
      e = bs_global(m, unsigned((threads + BS_THREADS - 1) / BS_THREADS), st,
                    ok, ov, n, T, kk, hb - m + 1);
      hb -= m;
    }
    if (e == cudaSuccess)
      e = launch(bs_chunk_kernel, unsigned(blocks), BS_THREADS, st, ok, ov, n,
                 T, kk);
  }
  return e;
}

}  // namespace histore
