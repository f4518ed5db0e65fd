// The fused GET probe of the distributed store, for sm_90a.
//
// Replaces: src/repro/kernels/_fused.py:332 group_probe_kernel (body
// _group_body: _hash_probe :68 + _backup_combine :112).  Bit-exact with
// repro_torch.kernels.ops.group_probe_stacked_plain and, with rep_sel
// given, group_probe_plain (hash_index.lookup plus backup_probe_plain).
//
// One call serves the G servers of a distributed GET chunk: for the raw
// keys rk [G, Q] each server received, it returns seven [G, Q] arrays
// (the found flags bool, the rest int32): the hash half (h_addr, h_found,
// h_acc), the chain walk of server g's hash table; the backup half
// (b_addr, b_found, b_acc), the probe of the replicas server g holds (per
// lane the last selected replica answers from its pending log window,
// newest entry first, else from its sorted replica; window_scan.cuh has
// the semantics and the reference's KEY_INF quirk); and the key's owner
// group.  Each lane hashes its key on the
// card (key_mix.cuh): the descriptors, the owner group og among the
// store's `groups` and the replica it selects, rep_sel[r] = (og ==
// (g0 + g - r - 1) mod groups), unless rep_sel is given (ops.group_probe,
// one group, JAX's signature).  The stack holds the G servers g0 ..
// g0 + G - 1 of the store: all of them on one process (g0 = 0, groups =
// G), a rank's L of them over W ranks.  The store's
// stacked leaves are read by base pointer and strides: nothing is copied
// or built per call.  Keys are int32 (histore_group_probe) or int64
// (histore_group_probe_i64, the same template on K, JAX's x64 store): the
// raw keys and the replicas' sorted and log keys take the store's width;
// the hash table, addresses, ops and the outputs stay int32 at both.
//
// Bound: bytes.  The hash half reads a key (4 B, or 8 B at int64) and
// two 128 B chain rows per lane; the backup half, for each selected lane,
// the window's keys and the descent's levels x fanout keys (a 16 B load
// holds 4 int32 keys or 2 int64 ones).  On the store's healthy GET only
// the padding lanes of the exchange buffers select a replica.
// Design: a memset of `best` for all G, then two kernels on one stream.
// window_scan.cuh's scan_kernel over (query blocks, slices, G), whose
// blocks with no selected lane stop after reading their queries; then the
// finish, 2 lanes a query over all G x Q lanes, launched with
// programmatic dependent launch (pdl.cuh): it hashes its key and walks
// the hash chain (hash_walk.cuh) while the scan runs, waits for the scan,
// then answers the backup half (window_scan.cuh's backup_answer).  2 lanes
// is the fastest lane count on the GET chunk, where few lanes descend; 4
// is faster where half the lanes descend, traffic no path sends (PERF.md
// §6).
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_walk.cuh"
#include "key_mix.cuh"
#include "pdl.cuh"
#include "window_scan.cuh"

namespace {

constexpr int W = 2;  // lanes a query

// a server's hash table: sig, fp and addr [G, nb, cs], fill [G, nb]
struct HashTables {
  histore::Leaf<int32_t> sig, fp, addr, fill;
};

template <class K>
__global__ void group_finish_kernel(const K* __restrict__ rkeys,
                                    histore::Select select, HashTables ht,
                                    histore::StackedReplicas<K> rp,
                                    const int32_t* __restrict__ best,
                                    int32_t* __restrict__ out,
                                    uint8_t* __restrict__ found, int64_t Q,
                                    int G, int64_t nb, int cs, int S,
                                    bool vec, int64_t cap, int64_t lcap,
                                    int fanout, int levels) {
  const int64_t GQ = int64_t(G) * Q;
  const int64_t qi = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) / W;
  if (qi >= GQ) return;  // whole groups exit together
  const int g = int(qi / Q);
  const int lane = threadIdx.x & (W - 1);
  const K key = rkeys[qi];
  const histore::KeyMix m = histore::key_mix(key);
  const histore::Desc d = histore::descriptors(m, nb);
  const histore::Probe h = histore::hash_walk<W>(
      ht.sig.at(0, g), ht.fp.at(0, g), ht.addr.at(0, g), ht.fill.at(0, g),
      d.bucket, d.sig, d.fp, cs, S, vec);
  const int sel = select(qi, key, g);
  histore::pdl_wait();  // `best` is the scan's
  const histore::Probe b = histore::backup_answer<W, false>(
      rp, sel, g, best, qi, key, cap, lcap, fanout, levels, lane);
  if (lane == 0) {
    out[qi] = h.addr;
    out[GQ + qi] = h.acc;
    out[2 * GQ + qi] = b.addr;
    out[3 * GQ + qi] = b.acc;
    out[4 * GQ + qi] = histore::owner_group(m, select.G);
    found[qi] = uint8_t(h.found);
    found[GQ + qi] = uint8_t(b.found);
  }
}

bool aligned16(const void* p, int64_t stride) {
  return (uintptr_t(p) & 15) == 0 && stride % 4 == 0;
}

template <class K>
int group_probe(const void* rkeys, const void* rep_sel, const void* tables,
                const void* replicas, void* out, void* found, void* best,
                long long Q, int G, long long nb, int cs, int S, int R,
                long long cap, long long lcap, int fanout, int levels,
                int groups, int g0, void* stream) {
  if (G < 1 || R < 1 || cap < 1 || lcap < 1 || nb < 1 || (nb & (nb - 1)) ||
      cs < 1 || S < 1 || g0 < 0 || groups < g0 + G)
    return (int)cudaErrorInvalidValue;
  const HashTables ht = *(const HashTables*)tables;
  const histore::StackedReplicas<K> rp =
      *(const histore::StackedReplicas<K>*)replicas;
  const histore::Select select{(const int32_t*)rep_sel, R, groups, g0};
  if (Q > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t e = histore::launch_window_scan(rkeys, select, rp, best, Q, G,
                                                R, lcap, s);
    if (e != cudaSuccess) return (int)e;
    const bool vec = cs % 4 == 0 && aligned16(ht.sig.p, ht.sig.sg) &&
                     aligned16(ht.fp.p, ht.fp.sg) &&
                     aligned16(ht.addr.p, ht.addr.sg);
    const int threads = 256;  // 256 / W queries a block
    const long long blocks = ((long long)G * Q * W + threads - 1) / threads;
    e = histore::launch(group_finish_kernel<K>, (unsigned)blocks, threads, s,
                        (const K*)rkeys, select, ht, rp,
                        (const int32_t*)best, (int32_t*)out,
                        (uint8_t*)found, (int64_t)Q, G,
                        (int64_t)nb, cs, S, vec, (int64_t)cap, (int64_t)lcap,
                        fanout, levels);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// rkeys: [G, Q] int32; rep_sel: [G, Q, R] int32 or null; tables: the
// HashTables (nb a power of two); replicas: the StackedReplicas (both host
// structs, laid out as repro_torch.kernels._build's); out: [5, G, Q] int32
// (h_addr, h_acc, b_addr, b_acc, owner group); found: [2, G, Q] bool
// (h_found, b_found); best: [G, Q] int32 scratch; groups: the store's
// group count, g0: the stack's first group (G, 0 on one process).
extern "C" int histore_group_probe(const void* rkeys, const void* rep_sel,
                                   const void* tables, const void* replicas,
                                   void* out, void* found, void* best,
                                   long long Q, int G,
                                   long long nb, int cs, int S, int R,
                                   long long cap, long long lcap, int fanout,
                                   int levels, int groups, int g0,
                                   void* stream) {
  return group_probe<int32_t>(rkeys, rep_sel, tables, replicas, out, found,
                              best, Q, G, nb, cs, S, R, cap, lcap, fanout,
                              levels, groups, g0, stream);
}

// the same with rkeys [G, Q] int64 and the replicas' sorted and log keys
// int64 (the same host struct: only the pointees' type differs); the
// outputs as above
extern "C" int histore_group_probe_i64(const void* rkeys, const void* rep_sel,
                                       const void* tables,
                                       const void* replicas, void* out,
                                       void* found, void* best, long long Q,
                                       int G, long long nb, int cs, int S,
                                       int R, long long cap, long long lcap,
                                       int fanout, int levels, int groups,
                                       int g0, void* stream) {
  return group_probe<int64_t>(rkeys, rep_sel, tables, replicas, out, found,
                              best, Q, G, nb, cs, S, R, cap, lcap, fanout,
                              levels, groups, g0, stream);
}
