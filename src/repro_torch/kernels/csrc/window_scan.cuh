// The pending-log window lookup and the backup finish, shared by
// backup_probe.cu and group_probe.cu (mirror of _pending_lookup and
// _backup_combine, src/repro/kernels/_fused.py:97 and :112, and of
// repro_torch.kernels.ops.backup_probe_plain).
//
// Per lane: rep_sel[q, r] != 0 selects replica r, and a later selected
// replica overwrites an earlier one, so only the LAST selected replica
// decides the answer.  That replica first looks the key up in its pending
// log window [applied, tail), newest entry wins: a PUT gives (addr, found),
// a DEL (-1, not found).  On a miss it descends its sorted replica.  A
// selected lane reports n_accesses = levels + 1; a lane with no replica
// selected gives (-1, 0, 0).
//
// The reference compares against every ring slot and reads a slot outside
// the window as KEY_INF.  So for q = KEY_INF and a window shorter than the
// ring, the newest "match" is the slot at sequence position
// applied + lcap - 1, whatever stale op and addr it holds.  backup_answer
// answers that case directly; the lookup reads the live window only.
//
// Both probes share the code below.  The backup probe reads its R replica
// states through a device table of pointers (Replicas) and rep_sel from
// memory, one group; the group probe reads the store's stacked [R, G]
// leaves by base pointer and strides (StackedReplicas<K>) for G groups along
// blockIdx.z, and each lane's replica comes from its key's owner group
// (Select, key_mix.cuh) unless rep_sel is given.
//
//  1. scan_kernel (after a memset of `best`): a lookup of the window, not
//     a scan of it.  256 threads a block, each with 4 queries (1024 a
//     block), and the window split into SPLITS slices along blockIdx.y.
//     A lane whose answer is the KEY_INF slot looks up nothing.  For each
//     replica that some lane of the block selects and looks up, the block
//     takes its slice newest first in tiles of up to TILE entries; for
//     each tile it builds a hash table in shared memory, key -> the
//     newest position of that key in the tile (linear probing at a load
//     of at most 1/2, atomicCAS on the key, atomicMax on the position;
//     the key KEY_INF, the table's empty mark, keeps its newest position
//     beside the table), then each open lane probes it once and closes
//     on a hit; the block stops once every lane has one.  Work per block
//     is the slice plus its lanes, not their product.  A block none of
//     whose lanes selects a replica reads its queries and stops.
//     atomicMax combines the slices: best[q] is 1 + the newest match's
//     position in the window, 0 for none.  No [Q, lcap] matrix.  The
//     table (WinTable) holds 2048 int32 entries in 4096 (key, position)
//     pairs, 32 KB; at int64 keys 1024 entries in 2048 slots of an 8 B
//     key and a 4 B position, 24 KB, so a window takes twice the tiles.
//  2. backup_answer: W lanes a query.  It answers from the log entry
//     best[q] names (or the KEY_INF slot), else runs a descent of
//     descent.cuh on its replica: the lane form's descent_split
//     (backup_finish: LANES lanes a query, a node searched as every
//     SPLIT-th key then SPLIT, level 0 in 16 B loads) or descent_lanes<W>
//     (the group probe's finish).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "descent.cuh"
#include "key_mix.cuh"
#include "pdl.cuh"

namespace histore {

constexpr int SCAN_THREADS = 256;
constexpr int SCAN_QPT = 4;                          // queries a thread
constexpr int SCAN_Q = SCAN_THREADS * SCAN_QPT;      // queries a block
constexpr int SPLITS = 16;
constexpr int8_t OP_PUT = 1;

// the replicas' pointer sets, read from a DEVICE table of 7 * R pointers,
// replica by replica: skeys, saddrs, lkeys, laddrs, lops, applied, tail
// (`applied` and `tail` are device scalars), the keys K; nothing bounds R.
// One group: the g of each accessor is 0.
template <class K>
struct Replicas {
  using Key = K;
  const void* const* p;
  __device__ const K* skeys(int r, int) const { return (const K*)p[7 * r]; }
  __device__ const int32_t* saddrs(int r, int) const {
    return (const int32_t*)p[7 * r + 1];
  }
  __device__ const K* lkeys(int r, int) const {
    return (const K*)p[7 * r + 2];
  }
  __device__ const int32_t* laddrs(int r, int) const {
    return (const int32_t*)p[7 * r + 3];
  }
  __device__ const int8_t* lops(int r, int) const {
    return (const int8_t*)p[7 * r + 4];
  }
  __device__ int64_t applied(int r, int) const {
    return *(const int32_t*)p[7 * r + 5];
  }
  __device__ int64_t tail(int r, int) const {
    return *(const int32_t*)p[7 * r + 6];
  }
};

// one leaf of a state stacked along [R, G]: the row of replica r of group
// g starts at p + r * sr + g * sg (strides in elements; a [G] leaf has
// sr = 0).  The same layout as repro_torch.kernels._build.Leaf.
template <class T>
struct Leaf {
  const T* p;
  int64_t sr, sg;
  __device__ const T* at(int r, int g) const { return p + r * sr + g * sg; }
};

// the store's backups as they lie on the card: SortedIndex keys and addrs
// [R, G, cap], UpdateLog keys, addrs and ops [R, G, lcap], applied and
// tail [R, G]; the keys K (int32 or int64), the rest as at either width
template <class K>
struct StackedReplicas {
  using Key = K;
  Leaf<K> skeys_;
  Leaf<int32_t> saddrs_;
  Leaf<K> lkeys_;
  Leaf<int32_t> laddrs_;
  Leaf<int8_t> lops_;
  Leaf<int32_t> applied_, tail_;
  __device__ const K* skeys(int r, int g) const { return skeys_.at(r, g); }
  __device__ const int32_t* saddrs(int r, int g) const {
    return saddrs_.at(r, g);
  }
  __device__ const K* lkeys(int r, int g) const { return lkeys_.at(r, g); }
  __device__ const int32_t* laddrs(int r, int g) const {
    return laddrs_.at(r, g);
  }
  __device__ const int8_t* lops(int r, int g) const { return lops_.at(r, g); }
  __device__ int64_t applied(int r, int g) const {
    return *applied_.at(r, g);
  }
  __device__ int64_t tail(int r, int g) const { return *tail_.at(r, g); }
};

// the last selected replica of lane qi, -1 for none
__device__ __forceinline__ int last_selected(const int32_t* rep_sel,
                                             int64_t qi, int R) {
  int sel = -1;
  for (int r = 0; r < R; ++r)
    if (rep_sel[qi * R + r] != 0) sel = r;
  return sel;
}

// the replica that answers lane qi (= g * Q + q) of the stack's server g:
// rep_sel [G * Q, R] read from memory, or, where it is null, the last
// replica server g0 + g holds of the key's owner group among the store's
// G groups (the shifted layout; a rank's stack holds groups g0 ..)
struct Select {
  const int32_t* rep_sel;
  int R, G, g0;
  template <class K>
  __device__ int operator()(int64_t qi, K q, int g) const {
    if (rep_sel != nullptr) return last_selected(rep_sel, qi, R);
    return owned_replica(owner_group(key_mix(q), G), g0 + g, G, R);
  }
};

namespace {

// A tile's table in shared memory: key -> the newest position of that key
// in the tile, by linear probing at a load of at most 1/2; key_inf marks
// an empty slot, so that key keeps its newest position in inf_pos.  int32
// keys: TILE 2048 entries into 4096 (key, position) pairs, 32 KB; int64
// keys: TILE 1024 into 2048 slots of an 8 B key and a 4 B position, 24 KB.
template <class K>
struct WinTable;

template <>
struct WinTable<int32_t> {
  static constexpr int TILE = 2048;  // window entries a table holds
  static constexpr int SLOT_BITS = 12;
  static constexpr int SLOTS = 1 << SLOT_BITS;
  int2 tab[SLOTS];
  int32_t inf_pos;

  static __device__ __forceinline__ uint32_t slot_of(int32_t k) {
    // Fibonacci hashing: the top SLOT_BITS bits of k * 2^32 / phi
    return (uint32_t(k) * 0x9E3779B1u) >> (32 - SLOT_BITS);
  }
  __device__ __forceinline__ void clear(int tid) {
    for (int s = tid; s < SLOTS; s += SCAN_THREADS)
      tab[s] = make_int2(KEY_INF, -1);
    if (tid == 0) inf_pos = -1;
  }
  // newest position p of key k
  __device__ __forceinline__ void insert(int32_t k, int32_t p) {
    if (k == KEY_INF) {
      atomicMax(&inf_pos, p);
      return;
    }
    for (uint32_t s = slot_of(k);; s = (s + 1) & (SLOTS - 1)) {
      const int32_t prev = atomicCAS(&tab[s].x, KEY_INF, k);
      if (prev == KEY_INF || prev == k) {
        atomicMax(&tab[s].y, p);
        return;
      }
    }
  }
  // the newest position of q in the tile, -1 if it is not there; the
  // table is at most half full, so an empty slot ends every probe
  __device__ __forceinline__ int32_t lookup(int32_t q) const {
    if (q == KEY_INF) return inf_pos;
    for (uint32_t s = slot_of(q);; s = (s + 1) & (SLOTS - 1)) {
      const int2 e = tab[s];
      if (e.x == q) return e.y;
      if (e.x == KEY_INF) return -1;
    }
  }
};

template <>
struct WinTable<int64_t> {
  static constexpr int TILE = 1024;
  static constexpr int SLOT_BITS = 11;
  static constexpr int SLOTS = 1 << SLOT_BITS;
  static constexpr unsigned long long EMPTY =
      (unsigned long long)key_inf<int64_t>();
  unsigned long long key[SLOTS];
  int32_t pos[SLOTS];
  int32_t inf_pos;

  static __device__ __forceinline__ uint32_t slot_of(int64_t k) {
    // Fibonacci hashing: the top SLOT_BITS bits of k * 2^64 / phi
    return uint32_t((uint64_t(k) * 0x9E3779B97F4A7C15ull) >>
                    (64 - SLOT_BITS));
  }
  __device__ __forceinline__ void clear(int tid) {
    for (int s = tid; s < SLOTS; s += SCAN_THREADS) {
      key[s] = EMPTY;
      pos[s] = -1;
    }
    if (tid == 0) inf_pos = -1;
  }
  __device__ __forceinline__ void insert(int64_t k, int32_t p) {
    if (k == key_inf<int64_t>()) {
      atomicMax(&inf_pos, p);
      return;
    }
    const unsigned long long uk = (unsigned long long)k;
    for (uint32_t s = slot_of(k);; s = (s + 1) & (SLOTS - 1)) {
      const unsigned long long prev = atomicCAS(&key[s], EMPTY, uk);
      if (prev == EMPTY || prev == uk) {
        atomicMax(&pos[s], p);
        return;
      }
    }
  }
  __device__ __forceinline__ int32_t lookup(int64_t q) const {
    if (q == key_inf<int64_t>()) return inf_pos;
    const unsigned long long uq = (unsigned long long)q;
    for (uint32_t s = slot_of(q);; s = (s + 1) & (SLOTS - 1)) {
      const unsigned long long e = key[s];
      if (e == uq) return pos[s];
      if (e == EMPTY) return -1;
    }
  }
};

static_assert(WinTable<int32_t>::SLOTS >= 2 * WinTable<int32_t>::TILE &&
                  WinTable<int64_t>::SLOTS >= 2 * WinTable<int64_t>::TILE,
              "a table at most half full");

template <class Rep>
__global__ void __launch_bounds__(SCAN_THREADS)
    scan_kernel(const typename Rep::Key* __restrict__ rkeys, Select select,
                Rep rp, int32_t* __restrict__ best, int64_t Q, int R,
                int64_t lcap) {
  using K = typename Rep::Key;
  constexpr int TILE = WinTable<K>::TILE;
  __shared__ WinTable<K> tab;
  // the finish may start (and walk its hash half) while this runs
  pdl_trigger();
  const int tid = threadIdx.x;
  const int g = blockIdx.z;
  int64_t qi[SCAN_QPT];               // g * Q + the lane's query
  K q[SCAN_QPT];
  int sel[SCAN_QPT];
#pragma unroll
  for (int i = 0; i < SCAN_QPT; ++i) {
    const int64_t qg = int64_t(blockIdx.x) * SCAN_Q + i * SCAN_THREADS + tid;
    const bool live = qg < Q;
    qi[i] = g * Q + qg;
    q[i] = live ? rkeys[qi[i]] : 0;
    sel[i] = live ? select(qi[i], q[i], g) : -1;
  }
  for (int r = 0; r < R; ++r) {
    const int64_t applied = rp.applied(r, g);
    const int64_t tail = rp.tail(r, g);
    // backup_answer answers q = KEY_INF without `best` while the window
    // is shorter than the ring, so such a lane (the exchange buffer's
    // padding) looks up nothing
    const bool short_win = tail - applied < lcap;
    unsigned open = 0;                // this thread's lanes still looking
#pragma unroll
    for (int i = 0; i < SCAN_QPT; ++i)
      if (sel[i] == r && !(q[i] == key_inf<K>() && short_win))
        open |= 1u << i;
    if (!__syncthreads_or(open != 0)) continue;  // block-uniform
    // the reference looks at sequence positions [applied, applied + lcap)
    const int64_t end = tail < applied + lcap ? tail : applied + lcap;
    const int64_t len = end > applied ? end - applied : 0;
    const int64_t per = (len + SPLITS - 1) / SPLITS;
    const int64_t s_lo = applied + blockIdx.y * per;
    const int64_t s_hi = s_lo + per < end ? s_lo + per : end;
    const K* __restrict__ lk = rp.lkeys(r, g);
    for (int64_t hi = s_hi; hi > s_lo;) {
      // also the barrier that keeps the last table until all have probed
      if (!__syncthreads_or(open != 0)) break;
      const int64_t lo = hi - TILE > s_lo ? hi - TILE : s_lo;
      const int n = int(hi - lo);
      tab.clear(tid);
      __syncthreads();
      // ring slot of position lo + i: n <= lcap, so one wrap at most
      const int64_t lo_idx = lo % lcap;
      for (int i = tid; i < n; i += SCAN_THREADS) {
        int64_t idx = lo_idx + i;
        if (idx >= lcap) idx -= lcap;
        tab.insert(lk[idx], int32_t(lo + i - applied));
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < SCAN_QPT; ++i) {
        if (!(open >> i & 1u)) continue;
        const int32_t p = tab.lookup(q[i]);
        if (p >= 0) {
          atomicMax(best + qi[i], p + 1);
          open &= ~(1u << i);
        }
      }
      hi = lo;
    }
  }
}

}  // namespace

// memset `best` ([G, Q] int32 scratch) and launch the window scan of the
// G groups on `s`
template <class Rep>
inline cudaError_t launch_window_scan(const void* rkeys, const Select& select,
                                      const Rep& rp, void* best, long long Q,
                                      int G, int R, long long lcap,
                                      cudaStream_t s) {
  cudaError_t e = cudaMemsetAsync(best, 0, size_t(G) * size_t(Q) * 4, s);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)((Q + SCAN_Q - 1) / SCAN_Q), SPLITS, G);
  scan_kernel<Rep><<<grid, SCAN_THREADS, 0, s>>>(
      (const typename Rep::Key*)rkeys, select, rp, (int32_t*)best,
      (int64_t)Q, R, (int64_t)lcap);
  return cudaGetLastError();
}

// the backup probe's: one group, rep_sel [Q, R] from memory
template <class K>
inline cudaError_t launch_window_scan(const void* rkeys, const void* rep_sel,
                                      const Replicas<K>& rp, void* best,
                                      long long Q, int R, long long lcap,
                                      cudaStream_t s) {
  return launch_window_scan(rkeys, Select{(const int32_t*)rep_sel, R, 1, 0},
                            rp, best, Q, 1, R, lcap, s);
}

// the backup half of query qi (key q, answered by replica sel of group g,
// -1 for none) on W lanes, its descent descent_split<W> (Split) or
// descent_lanes<W>; every lane of the group must call it, and all get the
// same result (every branch is uniform over the group)
template <int W, bool Split, class Rep>
__device__ __forceinline__ Probe backup_answer(
    const Rep& rp, int sel, int g, const int32_t* __restrict__ best,
    int64_t qi, typename Rep::Key q, int64_t cap, int64_t lcap, int fanout,
    int levels, int lane) {
  using K = typename Rep::Key;
  if (sel < 0) return Probe{-1, 0, 0};
  const int64_t applied = rp.applied(sel, g);
  const int64_t tail = rp.tail(sel, g);
  int64_t seq = -1;
  if (q == key_inf<K>() && tail - applied < lcap) {
    // every ring slot outside the window reads as KEY_INF: the newest
    // position of the reference's range matches, whatever it holds
    seq = applied + lcap - 1;
  } else if (best[qi] > 0) {
    seq = applied + best[qi] - 1;
  }
  if (seq >= 0) {
    const int64_t idx = seq % lcap;
    const bool put = rp.lops(sel, g)[idx] == OP_PUT;
    return Probe{put ? rp.laddrs(sel, g)[idx] : -1, put ? 1 : 0, levels + 1};
  }
  const K* __restrict__ keys = rp.skeys(sel, g);
  int64_t pos;
  K k;
  if constexpr (Split) {
    pos = descent_split<W>(keys, q, cap, fanout, levels, lane, k);
  } else {
    pos = descent_lanes<W>(keys, q, cap, fanout, levels, lane);
    k = keys[pos < cap ? pos : cap - 1];
  }
  const int64_t at = pos < cap ? pos : cap - 1;
  const bool found = k == q;
  return Probe{found ? rp.saddrs(sel, g)[at] : -1, found ? 1 : 0,
               levels + 1};
}

// the backup probe's: LANES lanes a query, rep_sel [Q, R] from memory
template <class K>
__device__ __forceinline__ Probe backup_finish(
    const int32_t* __restrict__ rep_sel, const Replicas<K>& rp,
    const int32_t* __restrict__ best, int64_t qi, K q, int R,
    int64_t cap, int64_t lcap, int fanout, int levels, int lane) {
  return backup_answer<LANES, true>(rp, last_selected(rep_sel, qi, R), 0,
                                    best, qi, q, cap, lcap, fanout, levels,
                                    lane);
}

}  // namespace histore
