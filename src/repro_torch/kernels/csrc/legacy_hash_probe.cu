// The legacy per-query GET probe of the chained hash index, for sm_90a.
//
// Replaces: src/repro/kernels/_hash_probe.py:77 hash_probe_kernel (body
// _kernel :26).  Bit-exact with repro_torch.kernels.ops.
// legacy_hash_probe_plain (ref_hash_probe).
//
// For each query (bucket b, signature s, fingerprint f) it reads the [cs]
// chain row of bucket b and returns the first slot whose sig and fp both
// match: its addr, found, and off / S + 1 sub-bucket reads.  It takes no
// fill: a miss costs max(ceil(occ / S), 1) with occ the row's nonzero
// signatures (tombstones count), counted from the row itself.  So it
// shares hash_walk.cuh's loads but not its miss rule (which row 1 and the
// group probe keep); where the index keeps occ == fill its outputs equal
// hash_probe.cu's.
//
// Three entry points, one template: histore_legacy_hash_probe_keys takes
// the raw int32 keys and hashes them on the card (key_mix.cuh: the key
// mix, then bucket = h1 & (nb - 1), the signature and the fingerprint, as
// core/hashing.py computes them for any nb), so the routed
// ops.hash_probe is one launch; histore_legacy_hash_probe_keys_i64 does
// the same for int64 keys, both words mixed (JAX's bucket_of / sig_fp_of
// at the keys' width); histore_legacy_hash_probe takes the three int32
// descriptors, as the JAX kernel does.  The table is int32 at every
// width.
//
// Bound: memory.  Per query 4 B of key in (8 B at int64, 12 B of
// descriptors for the descriptor entry) and 9 B out (12 B), one 128 B sig row at cs = 32, and a
// 32 B sector for each fp word the function needs (the slots up to the
// first match whose sig matches: almost only a hit's) and for the addr
// word of a hit; every row read is a gather at a random bucket, so
// latency hides only behind many queries in flight.
// Design: W = 8 lanes a query (4, row 1's lane count, was timed beside it
// on this path and was slower, PERF.md §6), V = 32 / W = 4 consecutive
// slots a lane in one 16 B load of the sig row (scalar loads where the
// row is not 16-byte aligned or cs % 4 != 0), so a warp has 32 / W
// queries in flight.  The fp and addr words are read only where the sig
// matches, which keeps the fp and addr rows out of most queries; both in
// one round, by every lane with a candidate at once, so a hit costs three
// dependent reads (key, sig row, fp and addr), as row 1's does.  A group
// ballot and __ffs give the first match; its lane writes the outputs.  On
// a miss each lane has counted its nonzero signatures over every pass,
// and one __reduce_add_sync over the group gives occ.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_walk.cuh"
#include "key_mix.cuh"

namespace {

constexpr int W = 8;  // lanes a query

// KEYS: q0 holds the keys (of type Q0: int32 or int64), else the buckets
// (int32, and qsig, qfp the other two descriptors).  F: the type of found
// (bool for the keys-in entries, int32 as JAX's kernel returns it for the
// descriptor-in one).
template <bool KEYS, typename Q0, typename F>
__global__ void legacy_hash_probe_kernel(const Q0* __restrict__ q0,
                                         const int32_t* __restrict__ qsig,
                                         const int32_t* __restrict__ qfp,
                                         const int32_t* __restrict__ sig,
                                         const int32_t* __restrict__ fp,
                                         const int32_t* __restrict__ addr,
                                         int32_t* __restrict__ out_addr,
                                         F* __restrict__ out_found,
                                         int32_t* __restrict__ out_acc,
                                         int64_t Q, int64_t nb, int cs, int S,
                                         bool vec) {
  constexpr int V = 32 / W;
  const int64_t q = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) / W;
  if (q >= Q) return;  // whole groups exit together
  int64_t b;
  int32_t s, f;
  if (KEYS) {
    const histore::Desc d = histore::descriptors(histore::key_mix(q0[q]), nb);
    b = d.bucket;
    s = d.sig;
    f = d.fp;
  } else {
    b = int64_t(q0[q]);
    s = qsig[q];
    f = qfp[q];
  }
  const int wl = threadIdx.x & 31;
  const int lead = wl & ~(W - 1);
  const unsigned mask = histore::group_mask<W>();
  const int32_t* srow = sig + b * cs;
  int occ = 0;  // this lane's nonzero signatures
  for (int base = 0; base < cs; base += 32) {
    const int first = base + (wl - lead) * V;
    int32_t sv[V];
    histore::load_slots<V>(srow, first, cs, vec, sv);
    unsigned cand = 0;  // the lane's slots whose sig matches
#pragma unroll
    for (int t = 0; t < V; ++t) {
      occ += sv[t] != 0;  // 0 past cs
      cand |= unsigned(first + t < cs && sv[t] == s) << t;
    }
    // the candidates in slot order, each lane on its own first one at the
    // same time (a load inside a branch on t would run once for each t
    // among the warp's lanes); the fp and addr words in one round
    int t_hit = -1;
    int32_t a_hit = -1;
    while (cand) {
      const int t = __ffs(cand) - 1;
      const int64_t i = b * cs + first + t;
      const int32_t fv = fp[i], av = addr[i];
      if (fv == f) {
        t_hit = t;
        a_hit = av;
        break;
      }
      cand &= cand - 1;
    }
    const unsigned hit = __ballot_sync(mask, t_hit >= 0) & mask;
    if (hit) {
      if (wl == __ffs(hit) - 1) {
        const int off = first + t_hit;
        out_addr[q] = a_hit;
        out_found[q] = F(1);
        out_acc[q] = off / S + 1;
      }
      return;
    }
  }
  occ = __reduce_add_sync(mask, occ);
  if (wl == lead) {
    out_addr[q] = -1;
    out_found[q] = F(0);
    out_acc[q] = max((occ + S - 1) / S, 1);
  }
}

bool aligned16(const void* p) { return (uintptr_t(p) & 15) == 0; }

template <bool KEYS, typename Q0, typename F>
int launch(const void* q0, const void* qsig, const void* qfp, const void* sig,
           const void* fp, const void* addr, void* out_addr, void* out_found,
           void* out_acc, long long Q, long long nb, int cs, int S,
           void* stream) {
  if (nb < 1 || cs < 1 || S < 1) return (int)cudaErrorInvalidValue;
  if (Q > 0) {
    const bool vec = cs % 4 == 0 && aligned16(sig);
    const int threads = 256;  // 256 / W queries a block
    const long long blocks = (Q * W + threads - 1) / threads;
    legacy_hash_probe_kernel<KEYS, Q0, F><<<(unsigned)blocks, threads, 0,
                                            (cudaStream_t)stream>>>(
        (const Q0*)q0, (const int32_t*)qsig, (const int32_t*)qfp,
        (const int32_t*)sig, (const int32_t*)fp, (const int32_t*)addr,
        (int32_t*)out_addr, (F*)out_found, (int32_t*)out_acc, (int64_t)Q,
        (int64_t)nb, cs, S, vec);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// keys: [Q] int32; sig/fp/addr: [nb, cs] int32; out_addr and out_acc [Q]
// int32, out_found [Q] bool
extern "C" int histore_legacy_hash_probe_keys(
    const void* keys, const void* sig, const void* fp, const void* addr,
    void* out_addr, void* out_found, void* out_acc, long long Q,
    long long nb, int cs, int S, void* stream) {
  return launch<true, int32_t, uint8_t>(keys, nullptr, nullptr, sig, fp,
                                        addr, out_addr, out_found, out_acc,
                                        Q, nb, cs, S, stream);
}

// the same with keys [Q] int64
extern "C" int histore_legacy_hash_probe_keys_i64(
    const void* keys, const void* sig, const void* fp, const void* addr,
    void* out_addr, void* out_found, void* out_acc, long long Q,
    long long nb, int cs, int S, void* stream) {
  return launch<true, int64_t, uint8_t>(keys, nullptr, nullptr, sig, fp,
                                        addr, out_addr, out_found, out_acc,
                                        Q, nb, cs, S, stream);
}

// bucket/qsig/qfp: [Q] int32 descriptors; sig/fp/addr: [nb, cs] int32;
// out_addr, out_found and out_acc [Q] int32
extern "C" int histore_legacy_hash_probe(const void* bucket, const void* qsig,
                                         const void* qfp, const void* sig,
                                         const void* fp, const void* addr,
                                         void* out_addr, void* out_found,
                                         void* out_acc, long long Q, int cs,
                                         int S, void* stream) {
  return launch<false, int32_t, int32_t>(bucket, qsig, qfp, sig, fp, addr,
                                         out_addr, out_found, out_acc, Q, 1,
                                         cs, S, stream);
}
