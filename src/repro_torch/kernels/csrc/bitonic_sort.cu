// Rowwise bitonic (key, payload) sort, for sm_90a.
//
// Replaces: src/repro/kernels/_bitonic_sort.py:60 bitonic_sort_kernel
// (body _kernel :42, _compare_exchange :23).  Bit-exact with
// repro_torch.kernels.ops.bitonic_sort_plain on keys AND payloads.
//
// The network is not stable: the payloads of tied keys land where it puts
// them.  So this runs JAX's network compare-exchange for compare-exchange
// (pair_sort.cuh: stages 2 ... T, distances stage / 2 ... 1, swap when
// asc ? lo > hi : lo < hi with asc from the lower element's index),
// comparing keys only, on its own schedule: 2048-entry chunks a block,
// 8 entries a thread in registers, the short distances by register
// swaps and warp shuffles, the long ones in passes that each cover up
// to three distances.  T is a power of two.
//
// Bound: bytes, 16 B an entry (key and payload read, both written).  At
// [16, 4096], [1, 16384] and [1, 65536] that is 0.3, 0.08 and 0.3 us on
// the card, under a launch; what the schedule pays for is the passes over
// L2 (3, 7 and 13 launches chained by programmatic dependent launch) and
// the in-chunk work of the 2048-entry stages.  The parent's design (one
// block a row of 16384 in shared memory, a global pass a distance,
// separate pack and unpack) ran [1, 16384] on one SM.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_sort.cuh"

// keys, vals, out_keys, out_vals: [R, T] int32, T a power of two; the
// outputs 16-byte aligned
extern "C" int histore_bitonic_sort(const void* keys, const void* vals,
                                    void* out_keys, void* out_vals,
                                    long long R, long long T, void* stream) {
  if (R < 0 || T < 0 || T > (1LL << 30) || (T & (T - 1)) != 0 ||
      ((reinterpret_cast<uintptr_t>(out_keys) |
        reinterpret_cast<uintptr_t>(out_vals)) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (R == 0 || T == 0) return (int)cudaGetLastError();
  cudaError_t e = histore::sort_rows(
      (const int32_t*)keys, (const int32_t*)vals, (int32_t*)out_keys,
      (int32_t*)out_vals, R, T, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
