// The key mix of the hybrid index on the card, shared by hash_probe.cu and
// group_probe.cu (mirror of repro_torch.core.hashing, which mirrors
// src/repro/core/hashing.py:36-60, and of the owner-group hash of
// src/repro/core/kvstore.py:173).
//
// Keys are int32, so the high word of the reference's key is 0 and
// fmix32(hi ^ 0x9E3779B9) is a constant.  All of it is wrapping uint32
// arithmetic, native here (the PyTorch version emulates it in int64).
#pragma once

#include <stdint.h>

namespace histore {

// murmur3's finalizer
__host__ __device__ constexpr uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

constexpr uint32_t H1_SALT = fmix32(0x9E3779B9u);

// h1 = fmix32(lo ^ fmix32(0x9E3779B9)), h2 = fmix32(fmix32(lo ^ 0x85EBCA77))
struct KeyMix {
  uint32_t h1, h2;
};

__device__ __forceinline__ KeyMix key_mix(int32_t key) {
  const uint32_t lo = uint32_t(key);
  return KeyMix{fmix32(lo ^ H1_SALT), fmix32(fmix32(lo ^ 0x85EBCA77u))};
}

// a probe's descriptors: the bucket (n_buckets a power of two), the 31-bit
// odd signature and the fingerprint
struct Desc {
  int64_t bucket;
  int32_t sig, fp;
};

__device__ __forceinline__ Desc descriptors(const KeyMix& m,
                                            int64_t n_buckets) {
  return Desc{int64_t(m.h1 & uint32_t(n_buckets - 1)),
              int32_t(((m.h1 >> 1) | 1u) & 0x7FFFFFFFu), int32_t(m.h2)};
}

// the group that owns a key among G: fmix32(h2 ^ 0xA5A5A5A5) mod G
__device__ __forceinline__ int owner_group(const KeyMix& m, int G) {
  return int(fmix32(m.h2 ^ 0xA5A5A5A5u) % uint32_t(G));
}

// the last replica r < R that server g holds of group og in the shifted
// layout (slot r of server g holds group (g - r - 1) mod G), -1 for none:
// the lane's last selected replica, as rep_sel[r] = (og == (g - r - 1) mod G)
// selects them
__device__ __forceinline__ int owned_replica(int og, int g, int G, int R) {
  const int r0 = ((g - 1 - og) % G + G) % G;
  return r0 < R ? r0 + (R - 1 - r0) / G * G : -1;
}

}  // namespace histore
