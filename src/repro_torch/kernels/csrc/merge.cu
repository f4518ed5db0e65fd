// Asynchronous apply of a log batch to a sorted replica, for sm_90a.
//
// Replaces: src/repro/kernels/_fused.py:404 merge_kernel (body _merge_body,
// :368).  Bit-exact with repro_torch.core.sorted_index.merge: newest wins
// per key, DELETEs compact away, op-0 lanes are ignored, and keys that do
// not fit in cap are dropped while `size` still counts them.
//
// Bound: memory.  At cap = 2^24 the existing keys and addrs (128 MiB) are
// read and the new ones (128 MiB) written per apply; the batch (m = 4096)
// is noise.  Design, four steps on the caller's stream:
//  (a) sort: the batch, padded to MP = next pow2 of m, is packed as uint64
//      (biased key << 32 | arrival) and sorted by pair_sort.cuh's
//      sort_rows<FULL>, so the order is (key, arrival) as in the JAX
//      kernel; op-0 and padding lanes carry key INF.  The stable pair sort
//      of sort_stable.cu is the same sort: one block in shared memory up
//      to MP = 16384, global passes above that, so any batch is taken.
//  (b) merge-path ranks: existing entry i goes to i + #(batch < ek[i]),
//      batch entry j to j + #(existing <= sk[j]) (binary searches), so an
//      existing entry comes first on equal keys; both land in L = cap + MP
//      scratch arrays.
//  (c) keep = last of its key run & not a DELETE & key != INF, compacted
//      by a multi-block exclusive scan: per-tile counts, one block scans
//      the tile sums (and writes size), then each tile scatters its kept
//      entries to dest < cap.
//  (d) the tail [size, cap) is filled with INF / -1.
// The scratch round trip costs about three times the bound's bytes; a
// later version can fuse (b) into (c) with a merge-path partition.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_sort.cuh"

namespace {

constexpr int32_t KEY_INF = 0x7fffffff;
constexpr int TILE_THREADS = 256;
constexpr int TILE_ITEMS = 16;
constexpr int TILE = TILE_THREADS * TILE_ITEMS;

struct Scratch {
  histore::u64* sp;  // [MP] packed (key, arrival) pairs
  int32_t* sk;       // [MP] sorted batch keys
  int32_t* sa;       // [MP] sorted batch addrs
  uint8_t* sd;       // [MP] sorted batch is-DELETE
  int32_t* mk;       // [L] merged keys
  int32_t* ma;       // [L] merged addrs
  uint8_t* md;       // [L] merged is-DELETE
  int32_t* bcnt;     // [ntiles] kept entries per tile
  long long* boff;   // [ntiles] exclusive prefix of bcnt
};

size_t align256(size_t x) { return (x + 255) & ~size_t(255); }

size_t carve(char* base, long long cap, long long MP, Scratch* s) {
  const long long L = cap + MP;
  const long long ntiles = (L + TILE - 1) / TILE;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off += align256(bytes);
    return p;
  };
  s->sp = (histore::u64*)take(MP * 8);
  s->sk = (int32_t*)take(MP * 4);
  s->sa = (int32_t*)take(MP * 4);
  s->sd = (uint8_t*)take(MP);
  s->mk = (int32_t*)take(L * 4);
  s->ma = (int32_t*)take(L * 4);
  s->md = (uint8_t*)take(L);
  s->bcnt = (int32_t*)take(ntiles * 4);
  s->boff = (long long*)take(ntiles * 8);
  return off;
}

// (a) ---------------------------------------------------------------------
__global__ void pack_batch_kernel(const int32_t* __restrict__ bkeys,
                                  const int32_t* __restrict__ bops,
                                  long long m, long long MP,
                                  histore::u64* __restrict__ sp) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < MP; i += (long long)gridDim.x * blockDim.x) {
    const int32_t key = (i < m && bops[i] > 0) ? bkeys[i] : KEY_INF;
    sp[i] = histore::pack_pair(key, uint32_t(i));
  }
}

__global__ void unpack_batch_kernel(const histore::u64* __restrict__ sp,
                                    const int32_t* __restrict__ baddrs,
                                    const int32_t* __restrict__ bops,
                                    long long m, long long MP,
                                    int32_t* __restrict__ sk,
                                    int32_t* __restrict__ sa,
                                    uint8_t* __restrict__ sd) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < MP; i += (long long)gridDim.x * blockDim.x) {
    const histore::u64 v = sp[i];
    const long long idx = (long long)uint32_t(v);
    sk[i] = histore::pair_key(v);
    sa[i] = idx < m ? baddrs[idx] : -1;
    sd[i] = (idx < m && bops[idx] == 2) ? 1 : 0;
  }
}

// (b) ---------------------------------------------------------------------
__device__ __forceinline__ long long count_less(const int32_t* a,
                                                long long n, int32_t q) {
  long long lo = 0, hi = n;  // first index with a[i] >= q
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a[mid] < q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ long long count_leq(const int32_t* a,
                                               long long n, int32_t q) {
  long long lo = 0, hi = n;  // first index with a[i] > q
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a[mid] <= q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void place_kernel(const int32_t* __restrict__ ek,
                             const int32_t* __restrict__ ea, long long cap,
                             Scratch s, long long MP) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < cap) {
    const int32_t k = ek[t];
    const long long p = t + count_less(s.sk, MP, k);
    s.mk[p] = k;
    s.ma[p] = ea[t];
    s.md[p] = 0;
  } else if (t < cap + MP) {
    const long long j = t - cap;
    const int32_t k = s.sk[j];
    const long long p = j + count_leq(ek, cap, k);
    s.mk[p] = k;
    s.ma[p] = s.sa[j];
    s.md[p] = s.sd[j];
  }
}

// (c) ---------------------------------------------------------------------
__device__ __forceinline__ bool keep_at(const Scratch& s, long long p,
                                        long long L) {
  const int32_t k = s.mk[p];
  const bool last = (p == L - 1) || (s.mk[p + 1] != k);
  return last && s.md[p] == 0 && k != KEY_INF;
}

__global__ void tile_count_kernel(Scratch s, long long L) {
  __shared__ int warp_sums[TILE_THREADS / 32];
  const long long base = (long long)blockIdx.x * TILE;
  int c = 0;
  for (int i = threadIdx.x; i < TILE; i += TILE_THREADS) {
    const long long p = base + i;
    if (p < L && keep_at(s, p, L)) ++c;
  }
  for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int tot = 0;
    for (int w = 0; w < TILE_THREADS / 32; ++w) tot += warp_sums[w];
    s.bcnt[blockIdx.x] = tot;
  }
}

__global__ void tile_scan_kernel(Scratch s, long long ntiles,
                                 int32_t* __restrict__ size_out) {
  // one block of 1024 threads scans the tile counts in chunks of 1024
  __shared__ long long buf[1024];
  __shared__ long long carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (long long c0 = 0; c0 < ntiles; c0 += 1024) {
    const long long i = c0 + threadIdx.x;
    const long long v = i < ntiles ? s.bcnt[i] : 0;
    buf[threadIdx.x] = v;
    __syncthreads();
    for (int o = 1; o < 1024; o <<= 1) {  // Hillis-Steele inclusive scan
      const long long add = threadIdx.x >= o ? buf[threadIdx.x - o] : 0;
      __syncthreads();
      buf[threadIdx.x] += add;
      __syncthreads();
    }
    if (i < ntiles) s.boff[i] = carry + buf[threadIdx.x] - v;
    __syncthreads();
    if (threadIdx.x == 1023) carry += buf[1023];
    __syncthreads();
  }
  if (threadIdx.x == 0) size_out[0] = (int32_t)carry;
}

__global__ void tile_scatter_kernel(Scratch s, long long L, long long cap,
                                    int32_t* __restrict__ nk,
                                    int32_t* __restrict__ na) {
  __shared__ int warp_sums[TILE_THREADS / 32];
  const long long base =
      (long long)blockIdx.x * TILE + (long long)threadIdx.x * TILE_ITEMS;
  unsigned bits = 0;
  int c = 0;
  for (int k = 0; k < TILE_ITEMS; ++k) {
    const long long p = base + k;
    if (p < L && keep_at(s, p, L)) {
      bits |= 1u << k;
      ++c;
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = c;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += warp_sums[w];
  long long dest = s.boff[blockIdx.x] + before + incl - c;
  for (int k = 0; k < TILE_ITEMS; ++k) {
    if (bits & (1u << k)) {
      if (dest < cap) {
        nk[dest] = s.mk[base + k];
        na[dest] = s.ma[base + k];
      }
      ++dest;
    }
  }
}

// (d) ---------------------------------------------------------------------
__global__ void fill_tail_kernel(const int32_t* __restrict__ size,
                                 long long cap, int32_t* __restrict__ nk,
                                 int32_t* __restrict__ na) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < cap && i >= size[0]) {
    nk[i] = KEY_INF;
    na[i] = -1;
  }
}

}  // namespace

extern "C" long long histore_merge_scratch_bytes(long long cap,
                                                 long long MP) {
  Scratch s;
  return (long long)carve(nullptr, cap, MP, &s);
}

extern "C" int histore_merge(const void* ekeys, const void* eaddrs,
                             const void* bkeys, const void* baddrs,
                             const void* bops, void* nkeys, void* naddrs,
                             void* size_out, void* scratch, long long cap,
                             int m, int MP, void* stream) {
  if (MP < m || (MP & (MP - 1)) != 0 || cap < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Scratch s;
  carve((char*)scratch, cap, MP, &s);
  const long long L = cap + MP;
  const long long ntiles = (L + TILE - 1) / TILE;
  const unsigned bblocks = (unsigned)((MP + 255) / 256 < 65536
                                          ? (MP + 255) / 256 : 65536);
  pack_batch_kernel<<<bblocks, 256, 0, st>>>(
      (const int32_t*)bkeys, (const int32_t*)bops, m, MP, s.sp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if ((e = histore::sort_rows<true>(s.sp, 1, MP, st)) != cudaSuccess)
    return (int)e;
  unpack_batch_kernel<<<bblocks, 256, 0, st>>>(
      s.sp, (const int32_t*)baddrs, (const int32_t*)bops, m, MP, s.sk, s.sa,
      s.sd);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  place_kernel<<<(unsigned)((L + 255) / 256), 256, 0, st>>>(
      (const int32_t*)ekeys, (const int32_t*)eaddrs, cap, s, MP);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  tile_count_kernel<<<(unsigned)ntiles, TILE_THREADS, 0, st>>>(s, L);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  tile_scan_kernel<<<1, 1024, 0, st>>>(s, ntiles, (int32_t*)size_out);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  tile_scatter_kernel<<<(unsigned)ntiles, TILE_THREADS, 0, st>>>(
      s, L, cap, (int32_t*)nkeys, (int32_t*)naddrs);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  fill_tail_kernel<<<(unsigned)((cap + 255) / 256), 256, 0, st>>>(
      (const int32_t*)size_out, cap, (int32_t*)nkeys, (int32_t*)naddrs);
  return (int)cudaGetLastError();
}
