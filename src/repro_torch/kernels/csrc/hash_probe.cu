// GET probe of the chained hash index, for sm_90a.
//
// Replaces: src/repro/kernels/_fused.py:204 hash_probe_block_kernel (body
// _hash_probe, :68).  Bit-exact with repro_torch.core.hash_index.lookup.
//
// For each query (bucket b, signature qsig, fingerprint qfp) it walks the
// [CS] chain row of bucket b, matches sig and fp, and returns the first
// matching slot's addr (or -1), found, and n_accesses: a hit costs
// off / S + 1 sub-bucket reads, a miss ceil(max(fill[b], 1) / S).
//
// Bound: memory.  Per query about 24 B of descriptors in and results out,
// plus two 128 B rows (sig, fp), one addr and one fill word: every access
// after the descriptors is a gather at a random bucket, so the card's
// latency hides only behind many queries in flight.
// Design: one warp per query.  The 32 lanes cover 32 chain slots a pass
// (one pass at CS = 32), so each row is read as one coalesced 128 B
// transaction per array; __ballot_sync + __ffs give the first match.
#include <cuda_runtime.h>
#include <stdint.h>

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
  const int64_t b = bucket[q];
  const int32_t s = qsig[q];
  const int32_t f = qfp[q];
  const int32_t* srow = sig + b * cs;
  const int32_t* frow = fp + b * cs;
  int off = -1;
  for (int base = 0; base < cs; base += 32) {
    const int slot = base + lane;
    bool m = false;
    if (slot < cs) m = (srow[slot] == s) && (frow[slot] == f);
    const unsigned hit = __ballot_sync(0xffffffffu, m);
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
      const int occ = max(fill[b], 1);
      out_addr[q] = -1;
      out_found[q] = 0;
      out_acc[q] = (occ + S - 1) / S;
    }
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
