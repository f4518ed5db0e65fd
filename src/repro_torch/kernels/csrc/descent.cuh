// The directory descent over the sorted index (mirror of _descent,
// src/repro/kernels/_fused.py:83): the forms that the probes' finishes
// run (backup_probe.cu, group_probe.cu through window_scan.cuh), and the
// searches and the SCAN's range that sorted_search.cu and
// legacy_sorted_search.cu launch.  Also the probe result the hash walk
// and the backup finish return.
//
// Over ascending, INF-padded int32 keys, the descent walks the implicit
// fanout-ary directory: at level l (stride fanout^l) it reads the node
// keys[pos + j * stride], j < fanout (INF past the end), counts those
// <= q, and moves pos by max(cnt - 1, 0) * stride.  For q = KEY_INF every
// node counts, past the end too, and pos ends at fanout^levels - 1.
//
// descent_lanes<W>: the group probe's finish, W < 32 lanes a query (32 / W
// queries a warp); each lane issues its fanout / W node loads before one
// __reduce_add_sync counts them, one round a level.  Every lane must call
// it; all get the same pos.
//
// The other forms use what the keys being ascending gives: for q <
// KEY_INF the descent's pos after level l is the last position of level
// l's whole grid (the multiples of fanout^l below cap) whose key is <= q,
// or 0.  So several levels can be read in one round, and a node can be
// searched in pieces, with the same bits:
//  * the top grid: the levels from the top down to the lowest level l >= 1
//    whose grid has at most TOP_MAX keys below cap (Grid, make_grid) are
//    read together, as one grid (at cap 2^24, fanout 128: levels 3 and 2,
//    1024 keys at stride 2^14);
//  * the block form (search_block_kernel at Q <= BLOCK_FORM_MAX_Q, and
//    range_kernel): every thread of a block on one query.  Round 1 reads
//    the query (or the SCAN's lo from device memory) with the top grid;
//    one round a level below it, down to level 1; the last round reads
//    level 0's node with its addrs, and for the range the entries the take
//    needs, [node, node + fanout + limit), into shared memory.  Dependent
//    rounds: 3 at cap 2^24 (a warp descent a level: levels + 2 = 6);
//  * the lane form (search_lanes_kernel, larger Q): LANES lanes a query;
//    each block stages the top grid in shared memory once and each query
//    searches it there; a node of level l >= 1 is searched in two rounds,
//    every SPLIT-th key and then the SPLIT keys of the bracket (16 + 8
//    scattered sectors at fanout 128, not 128), and level 0's node in one
//    round of 16 B loads (16 sectors); the key at pos is one of them, so
//    only a hit reads once more (its addr).  At cap 2^24: 41 sectors a
//    query where a warp a level read about 268.  descent_split is the same
//    from the root, no top grid staged: the backup probe's finish, whose
//    queries each pick their replica.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace histore {

constexpr int32_t KEY_INF = 0x7fffffff;

// one query's answer: value address (-1 on a miss), found, n_accesses
struct Probe {
  int32_t addr;
  int32_t found;
  int32_t acc;
};

// the lanes of this thread's group of W within its warp (1-D blocks)
template <int W>
__device__ __forceinline__ unsigned group_mask() {
  static_assert(W >= 1 && W < 32 && (W & (W - 1)) == 0, "W divides 32");
  return ((1u << W) - 1u) << ((threadIdx.x & 31) & ~(W - 1));
}

template <int W>
__device__ __forceinline__ int64_t descent_lanes(
    const int32_t* __restrict__ keys, int32_t q, int64_t cap, int fanout,
    int levels, int lane) {
  const unsigned mask = group_mask<W>();
  int64_t stride = 1;
  for (int l = 1; l < levels; ++l) stride *= fanout;
  int64_t pos = 0;
  for (int l = levels - 1; l >= 0; --l) {
    int le = 0;
#pragma unroll 4
    for (int j = lane; j < fanout; j += W) {
      const int64_t gi = pos + int64_t(j) * stride;
      le += (gi < cap ? keys[gi] : KEY_INF) <= q ? 1 : 0;
    }
    const int cnt = int(__reduce_add_sync(mask, unsigned(le)));
    pos += int64_t(max(cnt - 1, 0)) * stride;
    stride /= fanout;
  }
  return pos;
}


// ---------------------------------------------------------------------------
// The searches and the SCAN's range
// ---------------------------------------------------------------------------
constexpr int TOP_MAX = 1024;        // top-grid keys read in one round
constexpr int MAX_FANOUT = 1024;     // the largest fanout the kernels take
constexpr int BLOCK_THREADS = 256;   // the block form
constexpr int SPAN_MAX = 2048;       // entries of the last round kept in smem
constexpr int BLOCK_FORM_MAX_Q = 256;  // Q at or below it: the block form
constexpr int LANES = 8;             // the lane form: lanes a query
constexpr int SPLIT = 8;             // a node: every SPLIT-th key, then SPLIT

// the directory's shape, derived once a launch
struct Grid {
  int64_t cap;
  int fanout, levels;
  int top_level;       // levels top_level .. levels - 1 read as one grid
  int top_n;           // that grid's keys below cap (0: levels == 1)
  int64_t top_stride;  // fanout^top_level
  int64_t inf_pos;     // fanout^levels - 1: the descent's pos for KEY_INF
};

inline Grid make_grid(long long cap, int fanout, int levels) {
  Grid g{cap, fanout, levels, 0, 0, 0, 0};
  int64_t p = 1;
  for (int l = 0; l < levels; ++l) p *= fanout;
  g.inf_pos = p - 1;
  if (levels >= 2) {
    int l = levels - 1;
    int64_t s = p / fanout;
    while (l > 1 && (cap + s / fanout - 1) / (s / fanout) <= TOP_MAX) {
      --l;
      s /= fanout;
    }
    g.top_level = l;
    g.top_stride = s;
    g.top_n = int((cap + s - 1) / s);  // <= fanout <= TOP_MAX at l = L - 1
  }
  return g;
}

// -- the block form --------------------------------------------------------
struct BlockShared {
  int32_t k[SPAN_MAX];
  int32_t a[SPAN_MAX];
  int red[BLOCK_THREADS / 32];
};

// the sum of every thread's c; every thread of the block must call it
__device__ __forceinline__ int block_sum(int c, int* red) {
  c = int(__reduce_add_sync(0xffffffffu, unsigned(c)));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = c;
  __syncthreads();
  int s = 0;
  for (int w = 0; w < int(blockDim.x >> 5); ++w) s += red[w];
  __syncthreads();
  return s;
}

// Every thread of the block on the query *qp, read in the same round as
// the top grid; q returns it.  For q < KEY_INF returns the start of level
// 0's node and leaves the keys and addrs of [node, node + span) in sm
// (KEY_INF and -1 past cap), span <= SPAN_MAX; for q = KEY_INF returns -1
// and reads nothing more.  Every thread must call it.
__device__ __forceinline__ int64_t block_node(
    const int32_t* __restrict__ keys, const int32_t* __restrict__ addrs,
    const int32_t* qp, const Grid& g, int span, BlockShared& sm,
    int32_t& q) {
  constexpr int PER = TOP_MAX / BLOCK_THREADS;
  const int t = threadIdx.x;
  q = *qp;
  int32_t tk[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int j = u * BLOCK_THREADS + t;
    tk[u] = j < g.top_n ? keys[int64_t(j) * g.top_stride] : KEY_INF;
  }
  int c = 0;
#pragma unroll
  for (int u = 0; u < PER; ++u) c += tk[u] <= q ? 1 : 0;
  // the sum's barrier comes before the branch on q, so that the top
  // grid's loads are issued with q's
  const int top = g.top_n > 0 ? block_sum(c, sm.red) : 0;
  if (q == KEY_INF) return -1;  // block-uniform
  int64_t pos = g.top_stride * max(top - 1, 0);
  int64_t s = g.top_stride;
  for (int l = g.top_level - 1; l >= 1; --l) {
    s /= g.fanout;
    int32_t nk[MAX_FANOUT / BLOCK_THREADS];
#pragma unroll
    for (int u = 0; u < MAX_FANOUT / BLOCK_THREADS; ++u) {
      const int j = u * BLOCK_THREADS + t;
      const int64_t gi = pos + int64_t(j) * s;
      nk[u] = j < g.fanout && gi < g.cap ? keys[gi] : KEY_INF;
    }
    int c = 0;
#pragma unroll
    for (int u = 0; u < MAX_FANOUT / BLOCK_THREADS; ++u)
      c += nk[u] <= q ? 1 : 0;
    pos += s * max(block_sum(c, sm.red) - 1, 0);
  }
#pragma unroll 4
  for (int i = t; i < span; i += BLOCK_THREADS) {
    const int64_t gi = pos + i;
    const bool in = gi < g.cap;
    sm.k[i] = in ? keys[gi] : KEY_INF;
    sm.a[i] = in ? addrs[gi] : -1;
  }
  __syncthreads();
  return pos;
}

// the offset in level 0's node (left in sm by block_node) of the last key
// <= q, or 0; every thread must call it
__device__ __forceinline__ int block_leaf(int32_t q, const Grid& g,
                                          BlockShared& sm) {
  int c = 0;
  for (int i = threadIdx.x; i < g.fanout; i += BLOCK_THREADS)
    c += sm.k[i] <= q ? 1 : 0;
  return max(block_sum(c, sm.red) - 1, 0);
}

// the search's outputs for query qi: the descent's pos, the key k at
// min(pos, cap - 1) and its addr a
__device__ __forceinline__ void search_out(
    int64_t qi, int64_t pos, int32_t q, int32_t k, int32_t a, int levels,
    int32_t* __restrict__ out_addr, int32_t* __restrict__ out_found,
    int32_t* __restrict__ out_acc, int32_t* __restrict__ out_pos,
    int32_t* __restrict__ out_lb) {
  const bool found = k == q;
  out_addr[qi] = found ? a : -1;
  out_found[qi] = found ? 1 : 0;
  out_acc[qi] = levels;
  if (out_pos != nullptr) {
    out_pos[qi] = (int32_t)pos;
    out_lb[qi] = (int32_t)(pos + (k < q ? 1 : 0));
  }
}

// One block a query.  Writes addr (or -1), found and n_accesses = levels;
// where out_pos is not null also the unclamped pos and the lower bound
// pos + (keys[min(pos, cap - 1)] < q).
__global__ void __launch_bounds__(BLOCK_THREADS)
    search_block_kernel(const int32_t* __restrict__ queries,
                        const int32_t* __restrict__ keys,
                        const int32_t* __restrict__ addrs,
                        int32_t* __restrict__ out_addr,
                        int32_t* __restrict__ out_found,
                        int32_t* __restrict__ out_acc,
                        int32_t* __restrict__ out_pos,
                        int32_t* __restrict__ out_lb, Grid g) {
  __shared__ BlockShared sm;
  const int64_t qi = blockIdx.x;
  int32_t q;
  const int64_t node =
      block_node(keys, addrs, queries + qi, g, g.fanout, sm, q);
  if (node < 0) {  // KEY_INF: pos past the end, the read clamped
    if (threadIdx.x == 0)
      search_out(qi, g.inf_pos, q, keys[g.cap - 1], addrs[g.cap - 1],
                 g.levels, out_addr, out_found, out_acc, out_pos, out_lb);
    return;
  }
  const int c = block_leaf(q, g, sm);
  if (threadIdx.x == 0)
    search_out(qi, node + c, q, sm.k[c], sm.a[c], g.levels, out_addr,
               out_found, out_acc, out_pos, out_lb);
}

// The SCAN [lo, hi] of replica r of group gi, block gi * R + r: leaves of
// [R, G, cap] read in place by element strides (0 for one replica), lo
// and hi [G] by their strides (0 when expanded).  Output: keys [G, R,
// limit], then addrs [G, R, limit], then the counts [G, R], int32.
struct RangeArgs {
  const int32_t* keys;
  const int32_t* addrs;
  int64_t ks_r, ks_g, as_r, as_g;
  const int32_t* lo;
  const int32_t* hi;
  int64_t lo_s, hi_s;
  int32_t* out;
  int64_t G, limit;
  int R;
};

// One block a (group, replica): the block form's descent, the lower bound
// pos + (keys[min(pos, cap - 1)] < lo), then the take of
// sorted_index.range_from_start: `limit` entries from the bound, each
// masked where at >= cap, k > hi or k == KEY_INF, and their count.
__global__ void __launch_bounds__(BLOCK_THREADS)
    range_kernel(RangeArgs p, Grid g) {
  __shared__ BlockShared sm;
  const int64_t b = blockIdx.x;
  const int64_t gi = b / p.R, r = b % p.R;
  const int32_t* __restrict__ keys = p.keys + r * p.ks_r + gi * p.ks_g;
  const int32_t* __restrict__ addrs = p.addrs + r * p.as_r + gi * p.as_g;
  const int32_t hi = p.hi[gi * p.hi_s];
  const int64_t want = g.fanout + p.limit;
  const int span = want < SPAN_MAX ? int(want) : SPAN_MAX;
  int32_t q;
  int64_t node = block_node(keys, addrs, p.lo + gi * p.lo_s, g, span, sm, q);
  int have = span;  // entries of the window in sm
  int64_t pos;
  int32_t k_at;
  if (node < 0) {  // KEY_INF
    pos = node = g.inf_pos;
    k_at = keys[g.cap - 1];
    have = 0;
  } else {
    const int c = block_leaf(q, g, sm);
    pos = node + c;
    k_at = sm.k[c];
  }
  const int64_t lb = pos + (k_at < q ? 1 : 0);
  int32_t* __restrict__ ok = p.out + b * p.limit;
  int32_t* __restrict__ oa = ok + p.G * p.R * p.limit;
  int n = 0;
  for (int64_t i = threadIdx.x; i < p.limit; i += BLOCK_THREADS) {
    const int64_t at = lb + i;
    const int64_t w = at - node;
    int32_t k = KEY_INF, a = -1;
    if (w < have) {
      k = sm.k[w];
      a = sm.a[w];
    } else if (at < g.cap) {
      k = keys[at];
      a = addrs[at];
    }
    const bool valid = at < g.cap && k <= hi && k != KEY_INF;
    ok[i] = valid ? k : KEY_INF;
    oa[i] = valid ? a : -1;
    n += valid ? 1 : 0;
  }
  n = block_sum(n, sm.red);
  if (threadIdx.x == 0) p.out[2 * p.G * p.R * p.limit + b] = n;
}

// -- the lane form ---------------------------------------------------------
// count of the node keys[pos + j s] <= q, j < fanout, below cap, on W
// lanes: every SPLIT-th key, then the SPLIT - 1 keys after the last of
// them <= q
template <int W>
__device__ __forceinline__ int split_count(const int32_t* __restrict__ keys,
                                           int64_t pos, int64_t s, int32_t q,
                                           int64_t cap, int fanout, int lane,
                                           unsigned mask) {
  const int nco = (fanout + SPLIT - 1) / SPLIT;
  int c = 0;
#pragma unroll 4
  for (int i = lane; i < nco; i += W) {
    const int64_t gi = pos + int64_t(i) * SPLIT * s;
    c += gi < cap && keys[gi] <= q ? 1 : 0;
  }
  const int cc = int(__reduce_add_sync(mask, unsigned(c)));
  if (cc == 0) return 0;
  const int base = SPLIT * (cc - 1);
  int f = 0;
#pragma unroll
  for (int m = 1 + lane; m < SPLIT; m += W) {
    const int j = base + m;
    const int64_t gi = pos + int64_t(j) * s;
    f += j < fanout && gi < cap && keys[gi] <= q ? 1 : 0;
  }
  return base + 1 + int(__reduce_add_sync(mask, unsigned(f)));
}

// level 0's node [pos, pos + fanout) in one round on W lanes (VEC: in 16 B
// loads; fanout % 4 == 0, keys 16-byte aligned): c returns the offset of
// the last key <= q (0 when none is); returns the key at that offset
template <int W, bool VEC>
__device__ __forceinline__ int32_t leaf_lanes(
    const int32_t* __restrict__ keys, int64_t pos, int32_t q, int64_t cap,
    int fanout, int lane, unsigned mask, int& c) {
  int best = -1;
  int32_t bestv = 0, firstv = KEY_INF;
  if constexpr (VEC) {
#pragma unroll 4
    for (int j4 = lane * 4; j4 < fanout; j4 += W * 4) {
      const int64_t gi = pos + j4;
      int32_t v[4];
      if (gi + 3 < cap) {
        const int4 x = *reinterpret_cast<const int4*>(keys + gi);
        v[0] = x.x;
        v[1] = x.y;
        v[2] = x.z;
        v[3] = x.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = gi + e < cap ? keys[gi + e] : KEY_INF;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (v[e] <= q) {
          best = j4 + e;
          bestv = v[e];
        }
      }
      if (j4 == 0) firstv = v[0];
    }
  } else {
#pragma unroll 4
    for (int j = lane; j < fanout; j += W) {
      const int64_t gi = pos + j;
      const int32_t v = gi < cap ? keys[gi] : KEY_INF;
      if (v <= q) {
        best = j;
        bestv = v;
      }
      if (j == 0) firstv = v;
    }
  }
  const int m = int(__reduce_max_sync(mask, unsigned(best + 1))) - 1;
  c = max(m, 0);
  if (m < 0) return __shfl_sync(mask, firstv, __ffs(mask) - 1);
  const int owner = __ffs(__ballot_sync(mask, best == m)) - 1;
  return __shfl_sync(mask, bestv, owner);
}

// for q < KEY_INF on W lanes: from pos at level `from` (stride s there),
// the levels from - 1 .. 1 split-searched, then level 0's node; returns
// the descent's pos, k the key there
template <int W, bool VEC>
__device__ __forceinline__ int64_t split_from(
    const int32_t* __restrict__ keys, int64_t pos, int64_t s, int from,
    int32_t q, int64_t cap, int fanout, int lane, unsigned mask,
    int32_t& k) {
  for (int l = from - 1; l >= 1; --l) {
    s /= fanout;
    pos += s * max(split_count<W>(keys, pos, s, q, cap, fanout, lane, mask) -
                       1,
                   0);
  }
  int c;
  k = leaf_lanes<W, VEC>(keys, pos, q, cap, fanout, lane, mask, c);
  return pos + c;
}

// The lane form's descent from the root, for a caller with no staged top
// grid (the backup probe's finish, whose queries each pick a replica):
// every level split-searched, level 0 in 16 B loads where the keys allow.
// Returns pos (fanout^levels - 1 for KEY_INF), k the key at min(pos,
// cap - 1).  Every lane of the group must call it.
template <int W>
__device__ __forceinline__ int64_t descent_split(
    const int32_t* __restrict__ keys, int32_t q, int64_t cap, int fanout,
    int levels, int lane, int32_t& k) {
  int64_t s = 1;
  for (int l = 0; l < levels; ++l) s *= fanout;
  if (q == KEY_INF) {
    k = keys[cap - 1];
    return s - 1;
  }
  const unsigned mask = group_mask<W>();
  if (fanout % 4 == 0 && (reinterpret_cast<uintptr_t>(keys) & 15) == 0)
    return split_from<W, true>(keys, 0, s, levels, q, cap, fanout, lane,
                                  mask, k);
  return split_from<W, false>(keys, 0, s, levels, q, cap, fanout, lane,
                                 mask, k);
}

// LANES lanes a query; the block stages the top grid in shared memory
template <bool VEC>
__global__ void __launch_bounds__(1024)
    search_lanes_kernel(const int32_t* __restrict__ queries,
                        const int32_t* __restrict__ keys,
                        const int32_t* __restrict__ addrs,
                        int32_t* __restrict__ out_addr,
                        int32_t* __restrict__ out_found,
                        int32_t* __restrict__ out_acc,
                        int32_t* __restrict__ out_pos,
                        int32_t* __restrict__ out_lb, int64_t Q, Grid g) {
  __shared__ int32_t top[TOP_MAX];
  const int t = threadIdx.x;
  const int64_t qi = (int64_t(blockIdx.x) * blockDim.x + t) / LANES;
  const int lane = t & (LANES - 1);
  const int32_t q = qi < Q ? queries[qi] : KEY_INF;
  for (int j = t; j < g.top_n; j += blockDim.x)
    top[j] = keys[int64_t(j) * g.top_stride];
  __syncthreads();
  if (qi >= Q) return;  // uniform over the query's lanes
  int64_t pos;
  int32_t k;
  if (q == KEY_INF) {
    pos = g.inf_pos;
    k = keys[g.cap - 1];
  } else {
    int lo = 0, n = g.top_n;  // the first staged key > q
    while (n > 0) {
      const int h = n >> 1;
      if (top[lo + h] <= q) {
        lo += h + 1;
        n -= h + 1;
      } else {
        n = h;
      }
    }
    pos = split_from<LANES, VEC>(
        keys, g.top_stride * max(lo - 1, 0), g.top_stride, g.top_level, q,
        g.cap, g.fanout, lane, group_mask<LANES>(), k);
  }
  if (lane == 0) {
    const int64_t at = pos < g.cap ? pos : g.cap - 1;
    search_out(qi, pos, q, k, k == q ? addrs[at] : -1, g.levels, out_addr,
               out_found, out_acc, out_pos, out_lb);
  }
}

template <bool VEC>
inline void launch_lanes(unsigned blocks, int threads, cudaStream_t st,
                         const void* queries, const void* keys,
                         const void* addrs, void* out_addr, void* out_found,
                         void* out_acc, void* out_pos, void* out_lb,
                         long long Q, const Grid& g) {
  search_lanes_kernel<VEC><<<blocks, threads, 0, st>>>(
      (const int32_t*)queries, (const int32_t*)keys, (const int32_t*)addrs,
      (int32_t*)out_addr, (int32_t*)out_found, (int32_t*)out_acc,
      (int32_t*)out_pos, (int32_t*)out_lb, (int64_t)Q, g);
}

inline bool grid_ok(long long cap, int fanout, int levels) {
  return cap >= 1 && fanout >= 1 && fanout <= MAX_FANOUT && levels >= 1;
}

// the search of Q queries: the block form at Q <= BLOCK_FORM_MAX_Q, else
// the lane form with 128 to 1024 threads a block, so that about 128
// blocks share the top grid's staging; returns the launch status
inline int launch_search(const void* queries, const void* keys,
                         const void* addrs, void* out_addr, void* out_found,
                         void* out_acc, void* out_pos, void* out_lb,
                         long long Q, long long cap, int fanout, int levels,
                         void* stream) {
  if (!grid_ok(cap, fanout, levels)) return (int)cudaErrorInvalidValue;
  if (Q > 0) {
    const Grid g = make_grid(cap, fanout, levels);
    cudaStream_t st = (cudaStream_t)stream;
    if (Q <= BLOCK_FORM_MAX_Q) {
      search_block_kernel<<<(unsigned)Q, BLOCK_THREADS, 0, st>>>(
          (const int32_t*)queries, (const int32_t*)keys,
          (const int32_t*)addrs, (int32_t*)out_addr, (int32_t*)out_found,
          (int32_t*)out_acc, (int32_t*)out_pos, (int32_t*)out_lb, g);
    } else {
      const long long lanes = Q * LANES;
      int threads = 1024;
      while (threads > 128 && (lanes + threads - 1) / threads < 128)
        threads >>= 1;
      const unsigned blocks = (unsigned)((lanes + threads - 1) / threads);
      const bool vec =
          fanout % 4 == 0 && (reinterpret_cast<uintptr_t>(keys) & 15) == 0;
      if (vec)
        launch_lanes<true>(blocks, threads, st, queries, keys, addrs,
                           out_addr, out_found, out_acc, out_pos, out_lb, Q,
                           g);
      else
        launch_lanes<false>(blocks, threads, st, queries, keys, addrs,
                            out_addr, out_found, out_acc, out_pos, out_lb, Q,
                            g);
    }
  }
  return (int)cudaGetLastError();
}

// the SCANs of G groups x R replicas, one block each
inline int launch_range(const RangeArgs& p, long long cap, int fanout,
                        int levels, void* stream) {
  if (!grid_ok(cap, fanout, levels) || p.G < 0 || p.R < 1 || p.limit < 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = p.G * p.R;
  if (blocks > 0)
    range_kernel<<<(unsigned)blocks, BLOCK_THREADS, 0,
                   (cudaStream_t)stream>>>(p, make_grid(cap, fanout, levels));
  return (int)cudaGetLastError();
}

}  // namespace histore
