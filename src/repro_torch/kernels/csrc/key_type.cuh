// The key widths of the index kernels: int32 keys (the default store, the
// JAX package's x32 mode) and int64 keys (a store built with
// key_dtype=torch.int64, the JAX package's x64 mode).  A kernel on keys is
// a template on the key type K, instantiated for both widths, each with an
// extern "C" entry point of its own (histore_* and histore_*_i64).
// Addresses, signatures and fingerprints stay int32 at both widths.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace histore {

// the largest key, the sorted index's empty slot (key_inf)
template <class K>
__host__ __device__ constexpr K key_inf();
template <>
__host__ __device__ constexpr int32_t key_inf<int32_t>() {
  return 0x7fffffff;
}
template <>
__host__ __device__ constexpr int64_t key_inf<int64_t>() {
  return 0x7fffffffffffffffLL;
}

// the keys one 16 B load holds: 4 int32 keys or 2 int64 keys
template <class K>
__host__ __device__ constexpr int per16() {
  return int(16 / sizeof(K));
}

// v = the per16<K>() keys at p, p 16-byte aligned, in one 16 B load
template <class K>
__device__ __forceinline__ void load16(const K* p, K* v) {
  if constexpr (sizeof(K) == 4) {
    const int4 x = *reinterpret_cast<const int4*>(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
    const longlong2 x = *reinterpret_cast<const longlong2*>(p);
    v[0] = K(x.x);
    v[1] = K(x.y);
  }
}

}  // namespace histore
