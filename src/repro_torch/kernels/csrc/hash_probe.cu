// GET probe of the chained hash index, for sm_90a.
//
// Replaces: src/repro/kernels/_fused.py:204 hash_probe_block_kernel (body
// _hash_probe, :68).  Bit-exact with repro_torch.core.hash_index.lookup.
//
// For each query (bucket b, signature qsig, fingerprint qfp) it walks the
// [CS] chain row of bucket b, matches sig and fp, and returns the first
// matching slot's addr (or -1), found, and n_accesses: a hit costs
// off / S + 1 sub-bucket reads, a miss ceil(max(fill[b], 1) / S).  The
// walk is histore::hash_walk (hash_walk.cuh), shared with group_probe.cu.
//
// Bound: memory.  Per query about 24 B of descriptors in and results out,
// plus two 128 B rows (sig, fp), one addr and one fill word: every access
// after the descriptors is a gather at a random bucket, so the card's
// latency hides only behind many queries in flight.
// Design: one warp per query, the chain walk of hash_walk.cuh.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_walk.cuh"

namespace {

__global__ void hash_probe_kernel(const int32_t* __restrict__ bucket,
                                  const int32_t* __restrict__ qsig,
                                  const int32_t* __restrict__ qfp,
                                  const int32_t* __restrict__ sig,
                                  const int32_t* __restrict__ fp,
                                  const int32_t* __restrict__ addr,
                                  const int32_t* __restrict__ fill,
                                  int32_t* __restrict__ out_addr,
                                  int32_t* __restrict__ out_found,
                                  int32_t* __restrict__ out_acc,
                                  int64_t Q, int cs, int S) {
  const int lane = threadIdx.x & 31;
  const int64_t q =
      (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (q >= Q) return;  // whole warps exit together: Q is per warp
  const histore::Probe p = histore::hash_walk(sig, fp, addr, fill, bucket[q],
                                              qsig[q], qfp[q], cs, S, lane);
  if (lane == 0) {
    out_addr[q] = p.addr;
    out_found[q] = p.found;
    out_acc[q] = p.acc;
  }
}

}  // namespace

extern "C" int histore_hash_probe(const void* bucket, const void* qsig,
                                  const void* qfp, const void* sig,
                                  const void* fp, const void* addr,
                                  const void* fill, void* out_addr,
                                  void* out_found, void* out_acc,
                                  long long Q, int cs, int S,
                                  void* stream) {
  if (Q > 0) {
    const int threads = 256;  // 8 queries per block
    const long long blocks = (Q * 32 + threads - 1) / threads;
    hash_probe_kernel<<<(unsigned)blocks, threads, 0,
                        (cudaStream_t)stream>>>(
        (const int32_t*)bucket, (const int32_t*)qsig, (const int32_t*)qfp,
        (const int32_t*)sig, (const int32_t*)fp, (const int32_t*)addr,
        (const int32_t*)fill, (int32_t*)out_addr, (int32_t*)out_found,
        (int32_t*)out_acc, (int64_t)Q, cs, S);
  }
  return (int)cudaGetLastError();
}
