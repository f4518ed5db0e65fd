// Rowwise bitonic (key, payload) sort, for sm_90a.
//
// Replaces: src/repro/kernels/_bitonic_sort.py:60 bitonic_sort_kernel
// (body _kernel :42, _compare_exchange :23).  Bit-exact with
// repro_torch.kernels.ops.bitonic_sort_plain on keys AND payloads.
//
// The network is not stable: the payloads of tied keys land where it puts
// them.  So this is JAX's network step for step (pair_sort.cuh: stages
// 2 ... T, distances stage / 2 ... 1, swap when asc ? lo > hi : lo < hi
// with asc from the lower element's index), comparing keys only; inside
// one step the pairs are disjoint, so thread order cannot change a bit.
//
// Three steps on the caller's stream: pack each row into the [R, T]
// uint64 scratch as (biased key << 32 | payload); pair_sort.cuh's
// sort_rows (shared memory while a row fits in 16384 entries,
// global passes above that); unpack.  T is a power of two.
//
// Bound: bytes, 16 B an entry (key and payload read, both written); this
// design moves about 40 B an entry on the shared-memory path.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_sort.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void pack_kernel(const int32_t* __restrict__ keys,
                            const int32_t* __restrict__ vals,
                            histore::u64* __restrict__ d, long long n) {
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < n; t += (long long)gridDim.x * blockDim.x)
    d[t] = histore::pack_pair(keys[t], uint32_t(vals[t]));
}

__global__ void unpack_kernel(const histore::u64* __restrict__ d,
                              int32_t* __restrict__ out_keys,
                              int32_t* __restrict__ out_vals, long long n) {
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < n; t += (long long)gridDim.x * blockDim.x) {
    const histore::u64 v = d[t];
    out_keys[t] = histore::pair_key(v);
    out_vals[t] = int32_t(uint32_t(v));
  }
}

unsigned grid_for(long long n) {
  long long b = (n + THREADS - 1) / THREADS;
  return unsigned(b > 65536 ? 65536 : (b < 1 ? 1 : b));
}

}  // namespace

// keys, vals, out_keys, out_vals: [R, T] int32, T a power of two;
// scratch: [R, T] uint64.
extern "C" int histore_bitonic_sort(const void* keys, const void* vals,
                                    void* out_keys, void* out_vals,
                                    void* scratch, long long R, long long T,
                                    void* stream) {
  if (R < 0 || T < 0 || (T & (T - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (R == 0 || T == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  histore::u64* d = (histore::u64*)scratch;
  const long long n = R * T;
  pack_kernel<<<grid_for(n), THREADS, 0, st>>>((const int32_t*)keys,
                                               (const int32_t*)vals, d, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if ((e = histore::sort_rows(d, R, T, st)) != cudaSuccess)
    return (int)e;
  unpack_kernel<<<grid_for(n), THREADS, 0, st>>>(d, (int32_t*)out_keys,
                                                 (int32_t*)out_vals, n);
  return (int)cudaGetLastError();
}
