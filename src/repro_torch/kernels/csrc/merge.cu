// Asynchronous apply of a log batch to a sorted replica, for sm_90a.
//
// Replaces: src/repro/kernels/_fused.py:404 merge_kernel (body _merge_body,
// :368).  Bit-exact with repro_torch.core.sorted_index.merge: newest wins
// per key, an existing entry precedes a batch entry with the same key,
// DELETEs compact away with the entry they hit, op-0 lanes are ignored,
// and keys that do not fit in cap are dropped while `size` still counts
// them.
//
// Bound: bytes.  The existing keys and addrs are read once and the new
// ones written once, 16 B a slot at int32 keys and 24 B at int64 (268 MB
// and 403 MB at cap = 2^24: 0.0801 and 0.1202 ms at 3.35 TB/s); the batch
// (9 B an entry, 13 at int64) is noise at m = 4096.
//
// histore_merge_i64 is the same template on int64 keys (key_type.cuh).
// Its tiles of keys double in shared memory (the 2048-entry parts, 16 KB
// each), so part A's addrs are read from device memory where the place
// step stores them (coalesced, in entry order) and not staged: a block
// holds 42 KB of static shared memory, under the 48 KB limit (int32: 34
// KB), so at most five blocks an SM by shared memory.  The copies are 16 B of 2
// keys, and the batch's sort moves 8 B keys.
//
// Design: a merge-path apply, five steps on the caller's stream, each
// launched with programmatic dependent launch (pdl.cuh) so that a kernel
// is scheduled while the one before it drains.
//  (a) sort: merge_sort.cuh's stable sort orders the batch by (key,
//      arrival), reading the int8 ops directly; its payload is
//      arrival << 1 | is-DELETE, and op-0 lanes carry key INF.  Any m:
//      one launch up to 2048 entries, a merge pass per doubling above.
//  (b) partition: the merged order (existing entries first on equal keys)
//      is cut into 2048-entry tiles; one warp a tile boundary finds how
//      many existing entries precede it with warp_merge_path
//      (merge_path.cuh), about log32(m) rounds of reads.
//  (c) count: one block a tile copies its existing keys (16-byte
//      cp.async) and its batch keys and payloads into shared memory and
//      counts keep = last of its key run & not a DELETE & key != INF with
//      no merged copy: an existing entry is the last unless the next
//      existing key or a batch key equals it, a batch entry unless the
//      next batch key does (apply_tile).
//  (d) scan: one block turns the tile counts into an offset per group of
//      16 tiles and the size.
//  (e) place: each tile again, now with the addrs; kept entries are
//      ranked by warp ballots, each lands at its tile's offset plus its
//      rank in the merged order (existing entry x: x + #(batch part <
//      key); batch entry y: y + #(existing part <= key)), stored while
//      below cap.  Each block also fills its share of the tail [size,
//      cap) with INF / -1.
// Why: the kernel this replaces placed every existing entry by a binary
// search of the batch (12 dependent reads each) into cap-sized scratch
// arrays that three more kernels read back: about 650 MB moved at cap =
// 2^24, 8 launches, and a 151 MB scratch.  A merge path cuts the work
// into equal tiles without touching most of the array; keeping a tile's
// two parts in their own order needs no merged copy, only a short
// bisection per entry into the other part, which holds a few batch
// entries at m = 4096.  The scratch is the sorted batch and per-tile
// words; (c) reads 64 MiB, (e) reads 128 MiB and writes 128 MiB, about
// 1.25x the bound's bytes.  A single pass with a decoupled look-back
// (no (c) and (d)) was measured slower on the H100: with about 800 tiles
// in flight, the look-back walks far before it meets an inclusive prefix.
#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_sort.cuh"

namespace histore {

// the batch as the sort reads it: key INF on op-0 lanes, payload
// arrival << 1 | is-DELETE
template <class K>
struct BatchLoad {
  const K* keys;
  const int8_t* ops;
  __device__ __forceinline__ void operator()(long long, long long i, K& k,
                                             int32_t& v) const {
    const K key = keys[i];
    const int32_t op = ops[i];  // both reads in flight
    k = op > 0 ? key : key_inf<K>();
    v = int32_t(i << 1) | (op == 2 ? 1 : 0);
  }
};

}  // namespace histore

namespace {

constexpr int THREADS = histore::MS_THREADS;
constexpr int ITEMS = histore::MS_ITEMS;
constexpr int TILE = histore::MS_TILE;
constexpr int WARPS = THREADS / 32;
constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_ITEMS = 16;

template <class K>
struct Args {
  const K* ek;            // [cap] existing keys, ascending, INF-padded
  const int32_t* ea;      // [cap] existing addrs
  long long cap;
  const K* sk;            // [m] sorted batch keys
  const int32_t* sp;      // [m] sorted batch payloads
  const int32_t* baddrs;  // [m] batch addrs, in arrival order
  long long m;
  long long L;            // cap + m
  long long ntiles;
  long long* split;       // [ntiles + 1] existing entries before each tile
  int32_t* bcnt;          // [ntiles] kept entries per tile
  long long* gpre;        // [groups] kept entries before each group of
                          // SCAN_ITEMS tiles
  long long* total;       // [1] kept entries in all
};

template <class K>
struct Scratch {
  K *sk, *tk;
  int32_t *sp, *tp, *bcnt;
  long long *split, *gpre, *total;
};

size_t align256(size_t x) { return (x + 255) & ~size_t(255); }

template <class K>
size_t carve(char* base, long long m, long long ntiles, Scratch<K>* s) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off += align256(bytes);
    return p;
  };
  const long long mt = m > TILE ? m : 0;  // the sort's second buffer
  s->sk = (K*)take(m * sizeof(K));
  s->sp = (int32_t*)take(m * 4);
  s->tk = (K*)take(mt * sizeof(K));
  s->tp = (int32_t*)take(mt * 4);
  s->split = (long long*)take((ntiles + 1) * 8);
  s->bcnt = (int32_t*)take(ntiles * 4);
  s->gpre = (long long*)take((ntiles + SCAN_ITEMS - 1) / SCAN_ITEMS * 8);
  s->total = (long long*)take(8);
  return off;
}

// 4-, 8- and 16-byte asynchronous copies from device to shared memory
// (cp.async): the copies of a whole tile are in flight at once and hold
// no registers
__device__ __forceinline__ void copy_entry(int32_t* dst, const int32_t* src) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void copy_entry(int64_t* dst, const int64_t* src) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
#else
  *dst = *src;
#endif
}

template <class K>
__device__ __forceinline__ void copy16(K* dst, const K* src) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
#else
  for (int q = 0; q < histore::per16<K>(); ++q) dst[q] = src[q];
#endif
}

// src[lo, hi) (src holds n entries) into shared memory at dst, 16-byte
// aligned: dst[g - lo + off] = src[g], for the returned off.  Where src
// is 16-byte aligned the copies are 16 bytes (E = 4 int32 or 2 int64
// keys) from lo rounded down to a multiple of E (off = lo % E), else one
// entry each (copy4: 4 or 8 bytes; off = 0).
template <class K>
__device__ __forceinline__ int copy_range(K* dst, const K* src, long long lo,
                                          long long hi, long long n) {
  constexpr long long E = histore::per16<K>();
  if ((reinterpret_cast<uintptr_t>(src) & 15) != 0) {
    for (long long g = lo + threadIdx.x; g < hi; g += THREADS)
      copy_entry(dst + (g - lo), src + g);
    return 0;
  }
  const long long a0 = lo & ~(E - 1);
  for (long long g = a0 + E * threadIdx.x; g < hi; g += E * THREADS) {
    if (g + E <= n) {
      copy16(dst + (g - a0), src + g);
    } else {
      for (long long q = g; q < n; ++q) copy_entry(dst + (q - a0), src + q);
    }
  }
  return int(lo - a0);
}

__device__ __forceinline__ void copy_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::);
#endif
}

// Prefix counts of a part's keep flags, kept as ballots: bit `lane` of
// bal[k WARPS + w] is entry k THREADS + 32 w + lane, base[] the kept
// entries before each ballot's first.
static_assert(ITEMS * WARPS == 64, "scan_kept: two ballots a lane");
struct Kept {
  unsigned bal[ITEMS * WARPS];
  int base[ITEMS * WARPS];
  int total;
};

// kept entries among the first e (0 <= e <= the part's length)
__device__ __forceinline__ int kept_before(const Kept& s, int e) {
  if (e >= ITEMS * THREADS) return s.total;
  const int w = e >> 5;  // = k WARPS + warp of entry e
  return s.base[w] + __popc(s.bal[w] & ((1u << (e & 31)) - 1));
}

// warp `scanner` turns the ballots in s into base[] and total
__device__ __forceinline__ void scan_kept(Kept& s, int scanner) {
  const int lane = threadIdx.x & 31;
  if (int(threadIdx.x >> 5) != scanner) return;
  const int c0 = __popc(s.bal[2 * lane]), c1 = __popc(s.bal[2 * lane + 1]);
  int incl = c0 + c1;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  s.base[2 * lane] = incl - c0 - c1;
  s.base[2 * lane + 1] = incl - c1;
  if (lane == 31) s.total = incl;
}

// One tile of the merged order: existing entries ek[i0, i1) (part A) and
// batch entries sk[j0, j1) (part B), in the order of their own arrays,
// copied to shared memory with the entry just past each part.  Keep needs
// no merged copy: an existing entry is the last of its key run unless the
// next existing key or a batch key equals it (a batch entry with its key
// follows it at once, so it lies in B or at j1); a batch entry is the
// last unless the next batch key equals it.  In the merged order,
// existing entry x has x + #(B < its key) entries before it and batch
// entry y has y + #(A <= its key).  Batch parts are short (m entries over
// (cap + m) / TILE tiles), so B is walked in a loop that usually turns
// once.  With int64 keys the place step reads part A's addrs from device
// memory (coalesced, in entry order), not staged: the tile's shared
// memory would pass 48 KB.
template <bool PLACE, class K>
__device__ __forceinline__ void apply_tile(const Args<K>& a, long long t,
                                           K* __restrict__ nk,
                                           int32_t* __restrict__ nv) {
  constexpr K KEY_INF = histore::key_inf<K>();
  constexpr bool STAGE_A = PLACE && sizeof(K) == 4;
  __shared__ __align__(16) K akeys_s[TILE + 8];
  __shared__ __align__(16) int32_t avals_s[STAGE_A ? TILE + 8 : 4];
  __shared__ K bkeys[TILE + 1];
  __shared__ int32_t bpay[TILE];
  __shared__ Kept ke, kb;
  __shared__ int wsum[WARPS];
  __shared__ long long off_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long d0 = t * TILE;
  const long long d1 = d0 + TILE < a.L ? d0 + TILE : a.L;
  const long long i0 = a.split[t], i1 = a.split[t + 1];
  const long long j0 = d0 - i0, j1 = d1 - i1;
  const int na = int(i1 - i0), nb = int(j1 - j0);
  const int nax = na + (i1 < a.cap ? 1 : 0);
  const int nbx = nb + (j1 < a.m ? 1 : 0);
  // part A and the existing key past it, in 16-byte copies
  const K* akeys = akeys_s + copy_range(akeys_s, a.ek, i0, i0 + nax, a.cap);
  const int32_t* avals =
      STAGE_A ? avals_s + copy_range(avals_s, a.ea, i0, i0 + na, a.cap)
              : a.ea + i0;
  for (int y = tid; y < nbx; y += THREADS) {
    copy_entry(bkeys + y, a.sk + j0 + y);
    if (y < nb) copy_entry(bpay + y, a.sp + j0 + y);
  }
  // (PLACE) the tile's offset: its group's prefix and the counts of the
  // tiles before it in the group, summed by warp 0 while the copies fly
  if (PLACE && warp == 0) {
    const long long g0 = t & ~(long long)(SCAN_ITEMS - 1);
    long long v = lane < t - g0 ? a.bcnt[g0 + lane] : 0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) off_s = a.gpre[t / SCAN_ITEMS] + v;
  }
  copy_wait();
  __syncthreads();
  // part A: key[k] is entry k THREADS + tid; c[k] = #(B and past < key)
  K key[ITEMS];
  int c[ITEMS];
  unsigned be[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int x = k * THREADS + tid;
    key[k] = akeys[x < na ? x : 0];
  }
  histore::ranks<ITEMS, false>(bkeys, nbx, key, c);
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int x = k * THREADS + tid;
    const bool in_b = c[k] < nbx && bkeys[c[k] < nbx ? c[k] : 0] == key[k];
    const bool succ =
        x + 1 < nax && akeys[x + 1 < nax ? x + 1 : 0] == key[k];
    be[k] = __ballot_sync(0xffffffffu,
                          x < na && key[k] != KEY_INF && !succ && !in_b);
  }
  // part B, a round of THREADS entries at a time
  const int rounds = (nb + THREADS - 1) / THREADS;
  int nbk = 0;
  for (int k = 0; k < rounds; ++k) {
    const int y = k * THREADS + tid;
    const K bk = bkeys[y < nb ? y : 0];
    const bool del = (bpay[y < nb ? y : 0] & 1) != 0;
    const bool dup = y + 1 < nbx && bkeys[y + 1 < nbx ? y + 1 : 0] == bk;
    const unsigned bal = __ballot_sync(
        0xffffffffu, y < nb && bk != KEY_INF && !del && !dup);
    nbk += __popc(bal);
    if (PLACE && lane == 0) kb.bal[k * WARPS + warp] = bal;
  }
  if (!PLACE) {
    int n = nbk;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) n += __popc(be[k]);
    if (lane == 0) wsum[warp] = n;
    __syncthreads();
    if (tid == 0) {
      int tot = 0;
      for (int w = 0; w < WARPS; ++w) tot += wsum[w];
      a.bcnt[t] = tot;
    }
    return;
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      ke.bal[k * WARPS + warp] = be[k];
      if (k >= rounds) kb.bal[k * WARPS + warp] = 0;
    }
  }
  __syncthreads();
  scan_kept(ke, 0);
  scan_kept(kb, 1);
  __syncthreads();
  const long long off = off_s;
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    if (be[k] & (1u << lane)) {
      const int x = k * THREADS + tid;
      const long long dest = off + ke.base[k * WARPS + warp] +
                             __popc(be[k] & below) +
                             kept_before(kb, c[k] < nb ? c[k] : nb);
      if (dest < a.cap) {
        nk[dest] = key[k];
        nv[dest] = avals[x];
      }
    }
  }
  for (int k = 0; k < rounds; ++k) {
    const int y = k * THREADS + tid;
    const unsigned bal = kb.bal[k * WARPS + warp];
    if (bal & (1u << lane)) {
      const K bk = bkeys[y];
      int e;
      histore::ranks<1, true>(akeys, na, &bk, &e);
      const long long dest = off + kb.base[k * WARPS + warp] +
                             __popc(bal & below) + kept_before(ke, e);
      if (dest < a.cap) {
        nk[dest] = bk;
        nv[dest] = a.baddrs[bpay[y] >> 1];
      }
    }
  }
  // this block's share of the tail [size, cap)
  const long long size = a.total[0];
  if (size < a.cap) {
    const long long share = (a.cap - size + a.ntiles - 1) / a.ntiles;
    const long long lo = size + t * share;
    const long long hi = lo + share < a.cap ? lo + share : a.cap;
    for (long long i = lo + tid; i < hi; i += THREADS) {
      nk[i] = KEY_INF;
      nv[i] = -1;
    }
  }
}

// (b) ---------------------------------------------------------------------
// split[t] = the existing entries before merged position t TILE: one
// warp a tile boundary
template <class K>
__global__ void __launch_bounds__(THREADS) partition_kernel(Args<K> a) {
  histore::pdl_trigger();
  histore::pdl_wait();
  const long long t = ((long long)blockIdx.x * THREADS + threadIdx.x) >> 5;
  if (t > a.ntiles) return;  // whole warps leave together
  const long long d = t * TILE < a.L ? t * TILE : a.L;
  const long long i = histore::warp_merge_path(a.ek, a.cap, a.sk, a.m, d);
  if ((threadIdx.x & 31) == 0) a.split[t] = i;
}

// (c) ---------------------------------------------------------------------
template <class K>
__global__ void __launch_bounds__(THREADS) count_kernel(Args<K> a) {
  histore::pdl_trigger();
  histore::pdl_wait();
  apply_tile<false, K>(a, blockIdx.x, nullptr, nullptr);
}

// (d) ---------------------------------------------------------------------
// exclusive scan of the tile counts by groups of SCAN_ITEMS tiles, one
// group a thread and SCAN_THREADS groups a round: a thread reads its
// group's counts as int4s, one block-wide scan of the group sums, and
// gpre[group] is written (a place block adds the counts of the tiles
// before it in its group)
template <class K>
__global__ void __launch_bounds__(SCAN_THREADS)
    scan_kernel(Args<K> a, int32_t* __restrict__ size_out) {
  histore::pdl_trigger();
  histore::pdl_wait();
  __shared__ long long wsum[SCAN_THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long groups = (a.ntiles + SCAN_ITEMS - 1) / SCAN_ITEMS;
  long long carry = 0;
  for (long long g0 = 0; g0 < groups; g0 += SCAN_THREADS) {
    const long long first = (g0 + tid) * SCAN_ITEMS;
    int s = 0;
    if (first + SCAN_ITEMS <= a.ntiles) {
#pragma unroll
      for (int k = 0; k < SCAN_ITEMS; k += 4) {
        const int4 q = *reinterpret_cast<const int4*>(a.bcnt + first + k);
        s += q.x + q.y + q.z + q.w;
      }
    } else {
      for (long long i = first; i < a.ntiles; ++i) s += a.bcnt[i];
    }
    long long incl = s;
    for (int o = 1; o < 32; o <<= 1) {
      const long long u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    long long w = wsum[lane];  // the warp totals, scanned by every warp
    for (int o = 1; o < 32; o <<= 1) {
      const long long u = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += u;
    }
    const long long before = __shfl_sync(0xffffffffu, w, (warp + 31) & 31);
    if (g0 + tid < groups)
      a.gpre[g0 + tid] = carry + (warp > 0 ? before : 0) + incl - s;
    carry += __shfl_sync(0xffffffffu, w, 31);
    __syncthreads();
  }
  if (tid == 0) {
    a.total[0] = carry;
    size_out[0] = int32_t(carry);
  }
}

// (e) ---------------------------------------------------------------------
template <class K>
__global__ void __launch_bounds__(THREADS)
    place_kernel(Args<K> a, K* __restrict__ nk, int32_t* __restrict__ nv) {
  histore::pdl_trigger();
  histore::pdl_wait();
  apply_tile<true, K>(a, blockIdx.x, nk, nv);
}

template <class K>
long long scratch_bytes(long long cap, long long m) {
  Scratch<K> s;
  return (long long)carve(nullptr, m, (cap + m + TILE - 1) / TILE, &s);
}

template <class K>
int merge(const void* ekeys, const void* eaddrs, const void* bkeys,
          const void* baddrs, const void* bops, void* nkeys, void* naddrs,
          void* size_out, void* scratch, long long cap, long long m,
          void* stream) {
  if (cap < 1 || m < 1 || m >= (1LL << 30)) return (int)cudaErrorInvalidValue;
  const long long L = cap + m;
  const long long ntiles = (L + TILE - 1) / TILE;
  if (ntiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Scratch<K> s;
  carve((char*)scratch, m, ntiles, &s);
  const Args<K> a{(const K*)ekeys, (const int32_t*)eaddrs, cap, s.sk,
                  s.sp, (const int32_t*)baddrs, m, L, ntiles, s.split,
                  s.bcnt, s.gpre, s.total};
  cudaError_t e = histore::stable_sort_rows(
      histore::BatchLoad<K>{(const K*)bkeys, (const int8_t*)bops}, 1, m,
      s.sk, s.sp, s.tk, s.tp, st);
  if (e != cudaSuccess) return (int)e;
  e = histore::launch(partition_kernel<K>,
                      unsigned((ntiles + 1 + WARPS - 1) / WARPS), THREADS, st,
                      a);
  if (e == cudaSuccess)
    e = histore::launch(count_kernel<K>, unsigned(ntiles), THREADS, st, a);
  if (e == cudaSuccess)
    e = histore::launch(scan_kernel<K>, 1, SCAN_THREADS, st, a,
                        (int32_t*)size_out);
  if (e == cudaSuccess)
    e = histore::launch(place_kernel<K>, unsigned(ntiles), THREADS, st, a,
                        (K*)nkeys, (int32_t*)naddrs);
  return (int)e;
}

}  // namespace

extern "C" long long histore_merge_scratch_bytes(long long cap,
                                                 long long m) {
  return scratch_bytes<int32_t>(cap, m);
}

extern "C" long long histore_merge_scratch_bytes_i64(long long cap,
                                                     long long m) {
  return scratch_bytes<int64_t>(cap, m);
}

// ekeys, eaddrs, nkeys, naddrs: [cap] int32; bkeys, baddrs: [m] int32;
// bops: [m] int8; size_out: [1] int32; scratch: the bytes
// histore_merge_scratch_bytes(cap, m) asks for.
extern "C" int histore_merge(const void* ekeys, const void* eaddrs,
                             const void* bkeys, const void* baddrs,
                             const void* bops, void* nkeys, void* naddrs,
                             void* size_out, void* scratch, long long cap,
                             long long m, void* stream) {
  return merge<int32_t>(ekeys, eaddrs, bkeys, baddrs, bops, nkeys, naddrs,
                        size_out, scratch, cap, m, stream);
}

// the same with int64 ekeys, bkeys and nkeys; scratch: the bytes
// histore_merge_scratch_bytes_i64(cap, m) asks for.
extern "C" int histore_merge_i64(const void* ekeys, const void* eaddrs,
                                 const void* bkeys, const void* baddrs,
                                 const void* bops, void* nkeys, void* naddrs,
                                 void* size_out, void* scratch,
                                 long long cap, long long m, void* stream) {
  return merge<int64_t>(ekeys, eaddrs, bkeys, baddrs, bops, nkeys, naddrs,
                        size_out, scratch, cap, m, stream);
}
