// The legacy per-query GET probe of the chained hash index, for sm_90a.
//
// Replaces: src/repro/kernels/_hash_probe.py:77 hash_probe_kernel (body
// _kernel :26).  Bit-exact with repro_torch.kernels.ops.
// legacy_hash_probe_plain (ref_hash_probe).
//
// For each query (bucket b, signature s, fingerprint f) it reads the [CS]
// chain row of bucket b and returns the first slot whose sig and fp both
// match: its addr, found, and off / S + 1 sub-bucket reads.  It takes no
// fill: a miss costs max(ceil(occ / S), 1) with occ the row's nonzero
// signatures (tombstones count), counted from the row itself.  So it
// shares hash_walk.cuh's compare but not its miss rule; where the index
// keeps occ == fill its outputs equal hash_probe.cu's.
//
// Bound: memory.  Per query 12 B of descriptors in and 12 B out, one
// 128 B sig row, the fp word of each slot whose sig matches, one addr
// word on a hit: every row read is a gather at a random bucket.
// Design: one warp per query; the 32 lanes read 32 slots a pass (one pass
// at CS = 32), __ballot_sync + __ffs give the first match and __popc of a
// second ballot the occupied slots.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void legacy_hash_probe_kernel(const int32_t* __restrict__ bucket,
                                         const int32_t* __restrict__ qsig,
                                         const int32_t* __restrict__ qfp,
                                         const int32_t* __restrict__ sig,
                                         const int32_t* __restrict__ fp,
                                         const int32_t* __restrict__ addr,
                                         int32_t* __restrict__ out_addr,
                                         int32_t* __restrict__ out_found,
                                         int32_t* __restrict__ out_acc,
                                         int64_t Q, int cs, int S) {
  const int lane = threadIdx.x & 31;
  const int64_t q =
      (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (q >= Q) return;  // whole warps exit together: Q is per warp
  const int64_t b = bucket[q];
  const int32_t s = qsig[q], f = qfp[q];
  const int32_t* srow = sig + b * cs;
  const int32_t* frow = fp + b * cs;
  int off = -1, occ = 0;
  for (int base = 0; base < cs; base += 32) {
    const int slot = base + lane;
    bool m = false, used = false;
    if (slot < cs) {
      const int32_t sv = srow[slot];
      used = sv != 0;
      m = sv == s && frow[slot] == f;
    }
    const unsigned hit = __ballot_sync(0xffffffffu, m);
    occ += __popc(__ballot_sync(0xffffffffu, used));
    if (hit) {
      off = base + __ffs(hit) - 1;
      break;
    }
  }
  if (lane == 0) {
    if (off >= 0) {
      out_addr[q] = addr[b * cs + off];
      out_found[q] = 1;
      out_acc[q] = off / S + 1;
    } else {
      out_addr[q] = -1;
      out_found[q] = 0;
      out_acc[q] = max((occ + S - 1) / S, 1);
    }
  }
}

}  // namespace

extern "C" int histore_legacy_hash_probe(const void* bucket, const void* qsig,
                                         const void* qfp, const void* sig,
                                         const void* fp, const void* addr,
                                         void* out_addr, void* out_found,
                                         void* out_acc, long long Q, int cs,
                                         int S, void* stream) {
  if (S < 1 || cs < 1) return (int)cudaErrorInvalidValue;
  if (Q > 0) {
    const int threads = 256;  // 8 queries per block
    const long long blocks = (Q * 32 + threads - 1) / threads;
    legacy_hash_probe_kernel<<<(unsigned)blocks, threads, 0,
                               (cudaStream_t)stream>>>(
        (const int32_t*)bucket, (const int32_t*)qsig, (const int32_t*)qfp,
        (const int32_t*)sig, (const int32_t*)fp, (const int32_t*)addr,
        (int32_t*)out_addr, (int32_t*)out_found, (int32_t*)out_acc,
        (int64_t)Q, cs, S);
  }
  return (int)cudaGetLastError();
}
