// GET probe of the chained hash index, for sm_90a.
//
// Replaces: src/repro/kernels/_fused.py:204 hash_probe_block_kernel (body
// _hash_probe, :68).  Bit-exact with repro_torch.core.hash_index.lookup.
//
// It takes the raw keys, int32 (histore_hash_probe) or int64
// (histore_hash_probe_i64, the same template; the table stays int32):
// each query's lanes compute the key mix (key_mix.cuh, native uint32; an
// int64 key mixes its high word too) and its descriptors (bucket, signature,
// fingerprint), then walk the [cs] chain row of the bucket, match sig and
// fp, and return the first matching slot's addr (or -1), found, and
// n_accesses: a hit costs off / S + 1 sub-bucket reads, a miss
// ceil(max(fill[b], 1) / S).  The walk is histore::hash_walk
// (hash_walk.cuh), shared with group_probe.cu.
//
// Bound: memory.  Per query the key in (4 B, or 8 B at int64) and 9 B of
// results out, plus two 128 B rows (sig, fp), one addr and one fill word:
// at Q = 16384, 4587520 B at int32 keys and 4653056 B at int64 (0.001369
// and 0.001389 ms at 3.35 TB/s).  Every access after the key is a gather
// at a random bucket, so the card's latency hides only behind many
// queries in flight.  The int64 layout changes only the key's load.
// Design: the hashing costs no memory traffic and no launch of its own; 4
// lanes a query, two 16 B loads each per row, so a warp has 8 queries in
// flight, and the fill word is read beside the rows (other lane counts
// and an early addr read were timed, PERF.md §6).
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_walk.cuh"
#include "key_mix.cuh"

namespace {

constexpr int W = 4;  // lanes a query

template <class K>
__global__ void hash_probe_kernel(const K* __restrict__ keys,
                                  const int32_t* __restrict__ sig,
                                  const int32_t* __restrict__ fp,
                                  const int32_t* __restrict__ addr,
                                  const int32_t* __restrict__ fill,
                                  int32_t* __restrict__ out_addr,
                                  uint8_t* __restrict__ out_found,
                                  int32_t* __restrict__ out_acc, int64_t Q,
                                  int64_t nb, int cs, int S, bool vec) {
  const int64_t q = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) / W;
  if (q >= Q) return;  // whole groups exit together
  const histore::Desc d =
      histore::descriptors(histore::key_mix(keys[q]), nb);
  const histore::Probe p = histore::hash_walk<W>(
      sig, fp, addr, fill, d.bucket, d.sig, d.fp, cs, S, vec);
  if ((threadIdx.x & (W - 1)) == 0) {
    out_addr[q] = p.addr;
    out_found[q] = uint8_t(p.found);
    out_acc[q] = p.acc;
  }
}

bool aligned16(const void* p) { return (uintptr_t(p) & 15) == 0; }

template <class K>
int probe(const void* keys, const void* sig, const void* fp, const void* addr,
          const void* fill, void* out_addr, void* out_found, void* out_acc,
          long long Q, long long nb, int cs, int S, void* stream) {
  if (nb < 1 || (nb & (nb - 1)) || cs < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  if (Q > 0) {
    const bool vec = cs % 4 == 0 && aligned16(sig) && aligned16(fp) &&
                     aligned16(addr);
    const int threads = 256;  // 256 / W queries a block
    const long long blocks = (Q * W + threads - 1) / threads;
    hash_probe_kernel<K><<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
        (const K*)keys, (const int32_t*)sig, (const int32_t*)fp,
        (const int32_t*)addr, (const int32_t*)fill, (int32_t*)out_addr,
        (uint8_t*)out_found, (int32_t*)out_acc, (int64_t)Q, (int64_t)nb, cs,
        S, vec);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// keys: [Q] int32; sig/fp/addr: [nb, cs] int32; fill: [nb] int32, nb a
// power of two; out_addr and out_acc [Q] int32, out_found [Q] bool
extern "C" int histore_hash_probe(const void* keys, const void* sig,
                                  const void* fp, const void* addr,
                                  const void* fill, void* out_addr,
                                  void* out_found, void* out_acc,
                                  long long Q, long long nb, int cs, int S,
                                  void* stream) {
  return probe<int32_t>(keys, sig, fp, addr, fill, out_addr, out_found,
                        out_acc, Q, nb, cs, S, stream);
}

// the same with keys [Q] int64
extern "C" int histore_hash_probe_i64(const void* keys, const void* sig,
                                      const void* fp, const void* addr,
                                      const void* fill, void* out_addr,
                                      void* out_found, void* out_acc,
                                      long long Q, long long nb, int cs,
                                      int S, void* stream) {
  return probe<int64_t>(keys, sig, fp, addr, fill, out_addr, out_found,
                        out_acc, Q, nb, cs, S, stream);
}
