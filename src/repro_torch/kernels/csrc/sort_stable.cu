// Rowwise stable (key, payload) sort, for sm_90a.
//
// Replaces: src/repro/kernels/_fused.py:442 sort_pairs_stable_kernel
// (body _sort_stable_body, :431, over _bitonic_multi :157).  Bit-exact with
// repro_torch.kernels.ops.sort_stable_plain (torch.sort(stable=True) and a
// gather): the order (key, column index) is total, so every correct sort
// gives the same bits as the Pallas network.
//
// Three steps on the caller's stream: pack each row into the [R, TP]
// uint64 scratch as (biased key << 32 | column), TP = T rounded up to a
// power of two with (key_inf, column >= T) padding, which sorts after
// every real entry; pair_sort.cuh's sort_rows<FULL> (shared memory while
// a row fits in 16384 entries, global passes above that); unpack the key
// from the high half and gather the payload at the column in the low
// half, for the first T entries.
//
// Bound: bytes, 16 B an entry (key and payload read, both written).  This
// design moves about 40 B an entry on the shared-memory path (the
// scratch written, read and written by the sort, read again, plus the
// payload gather), more for each global pass of a larger row.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_sort.cuh"

namespace {

constexpr int32_t KEY_INF = 0x7fffffff;
constexpr int THREADS = 256;

__global__ void pack_kernel(const int32_t* __restrict__ keys,
                            histore::u64* __restrict__ d, long long R,
                            long long T, long long TP) {
  const long long n = R * TP;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < n; t += (long long)gridDim.x * blockDim.x) {
    const long long r = t / TP, i = t % TP;
    const int32_t k = i < T ? keys[r * T + i] : KEY_INF;
    d[t] = histore::pack_pair(k, uint32_t(i));
  }
}

__global__ void unpack_kernel(const histore::u64* __restrict__ d,
                              const int32_t* __restrict__ vals,
                              int32_t* __restrict__ out_keys,
                              int32_t* __restrict__ out_vals, long long R,
                              long long T, long long TP) {
  const long long n = R * T;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < n; t += (long long)gridDim.x * blockDim.x) {
    const long long r = t / T, i = t % T;
    const histore::u64 v = d[r * TP + i];
    out_keys[t] = histore::pair_key(v);
    out_vals[t] = vals[r * T + (long long)uint32_t(v)];
  }
}

unsigned grid_for(long long n) {
  long long b = (n + THREADS - 1) / THREADS;
  return unsigned(b > 65536 ? 65536 : (b < 1 ? 1 : b));
}

}  // namespace

// keys, vals, out_keys, out_vals: [R, T] int32; scratch: [R, TP] uint64,
// TP the power of two >= T.
extern "C" int histore_sort_stable(const void* keys, const void* vals,
                                   void* out_keys, void* out_vals,
                                   void* scratch, long long R, long long T,
                                   long long TP, void* stream) {
  if (R < 0 || T < 0 || TP < T || (TP & (TP - 1)) != 0 ||
      T > 0x100000000LL)
    return (int)cudaErrorInvalidValue;
  if (R == 0 || T == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  histore::u64* d = (histore::u64*)scratch;
  pack_kernel<<<grid_for(R * TP), THREADS, 0, st>>>((const int32_t*)keys, d,
                                                    R, T, TP);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if ((e = histore::sort_rows<true>(d, R, TP, st)) != cudaSuccess)
    return (int)e;
  unpack_kernel<<<grid_for(R * T), THREADS, 0, st>>>(
      d, (const int32_t*)vals, (int32_t*)out_keys, (int32_t*)out_vals, R, T,
      TP);
  return (int)cudaGetLastError();
}
