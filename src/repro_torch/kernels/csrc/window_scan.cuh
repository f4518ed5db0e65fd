// The pending-log window scan and the backup finish, shared by
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
// applied + lcap - 1, whatever stale op and addr it holds.  backup_finish
// answers that case directly; the scan looks at the live window only.
//
//  1. scan_kernel (after a memset of `best`): one thread per query, 128
//     queries a block, and the window split into SPLITS slices along
//     blockIdx.y.  A lane whose answer is the KEY_INF slot scans nothing.
//     For each replica that some lane of the block selects and scans,
//     the block stages its slice newest first in shared-memory tiles of
//     TILE keys; each thread scans a tile four keys a load and keeps its
//     newest match, and the block stops once every lane has one.  A block
//     none of whose lanes selects a replica reads its queries and stops.
//     atomicMax combines the slices: best[q] is 1 + the newest match's
//     position in the window, 0 for none.  No [Q, lcap] matrix.
//  2. backup_finish: one warp per query.  It answers from the log entry
//     best[q] names (or the KEY_INF slot), else runs the descent of
//     descent.cuh on its replica.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "descent.cuh"

namespace histore {

constexpr int SCAN_THREADS = 128;
constexpr int SPLITS = 16;
constexpr int TILE = 4096;
constexpr int8_t OP_PUT = 1;

// the replicas' pointer sets, read from a DEVICE table of 7 * R pointers,
// replica by replica: skeys, saddrs, lkeys, laddrs, lops, applied, tail
// (`applied` and `tail` are device scalars); nothing bounds R
struct Replicas {
  const void* const* p;
  __device__ const int32_t* skeys(int r) const {
    return (const int32_t*)p[7 * r];
  }
  __device__ const int32_t* saddrs(int r) const {
    return (const int32_t*)p[7 * r + 1];
  }
  __device__ const int32_t* lkeys(int r) const {
    return (const int32_t*)p[7 * r + 2];
  }
  __device__ const int32_t* laddrs(int r) const {
    return (const int32_t*)p[7 * r + 3];
  }
  __device__ const int8_t* lops(int r) const {
    return (const int8_t*)p[7 * r + 4];
  }
  __device__ int64_t applied(int r) const {
    return *(const int32_t*)p[7 * r + 5];
  }
  __device__ int64_t tail(int r) const {
    return *(const int32_t*)p[7 * r + 6];
  }
};

// the last selected replica of lane qi, -1 for none
__device__ __forceinline__ int last_selected(const int32_t* rep_sel,
                                             int64_t qi, int R) {
  int sel = -1;
  for (int r = 0; r < R; ++r)
    if (rep_sel[qi * R + r] != 0) sel = r;
  return sel;
}

namespace {

__global__ void scan_kernel(const int32_t* __restrict__ rkeys,
                            const int32_t* __restrict__ rep_sel,
                            Replicas rp, int32_t* __restrict__ best,
                            int64_t Q, int R, int64_t lcap) {
  __shared__ __align__(16) int32_t tile[TILE];
  const int64_t qi = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = qi < Q;
  const int32_t q = live ? rkeys[qi] : 0;
  const int sel = live ? last_selected(rep_sel, qi, R) : -1;
  for (int r = 0; r < R; ++r) {
    const int64_t applied = rp.applied(r);
    const int64_t tail = rp.tail(r);
    // backup_finish answers q = KEY_INF without `best` while the window
    // is shorter than the ring, so such a lane (the exchange buffer's
    // padding) scans nothing
    const bool mine = sel == r && !(q == KEY_INF && tail - applied < lcap);
    if (!__syncthreads_or(mine)) continue;  // block-uniform
    // the reference looks at sequence positions [applied, applied + lcap)
    const int64_t end = tail < applied + lcap ? tail : applied + lcap;
    const int64_t len = end > applied ? end - applied : 0;
    const int64_t per = (len + SPLITS - 1) / SPLITS;
    const int64_t s_lo = applied + blockIdx.y * per;
    const int64_t s_hi = s_lo + per < end ? s_lo + per : end;
    const int32_t* __restrict__ lk = rp.lkeys(r);
    bool open = mine;
    for (int64_t hi = s_hi; hi > s_lo;) {
      // also the barrier that keeps the last tile until all have read it
      if (!__syncthreads_or(open)) break;
      const int64_t lo = hi - TILE > s_lo ? hi - TILE : s_lo;
      const int n = int(hi - lo);
      const int64_t newest = (hi - 1) % lcap;
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        int64_t idx = newest - i;  // tile[i] holds position hi - 1 - i
        if (idx < 0) idx += lcap;
        tile[i] = lk[idx];
      }
      __syncthreads();
      if (open) {
        int hit = -1;
        int i = 0;
        for (; i + 4 <= n; i += 4) {
          const int4 v = *reinterpret_cast<const int4*>(tile + i);
          if (v.x == q) { hit = i; break; }
          if (v.y == q) { hit = i + 1; break; }
          if (v.z == q) { hit = i + 2; break; }
          if (v.w == q) { hit = i + 3; break; }
        }
        if (hit < 0)
          for (; i < n; ++i)
            if (tile[i] == q) { hit = i; break; }
        if (hit >= 0) {
          atomicMax(best + qi, int(hi - 1 - hit - applied) + 1);
          open = false;
        }
      }
      hi = lo;
    }
  }
}

}  // namespace

// memset `best` ([Q] int32 scratch) and launch the window scan on `s`
static inline cudaError_t launch_window_scan(const void* rkeys, const void* rep_sel,
                                      const Replicas& rp, void* best,
                                      long long Q, int R, long long lcap,
                                      cudaStream_t s) {
  cudaError_t e = cudaMemsetAsync(best, 0, size_t(Q) * 4, s);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)((Q + SCAN_THREADS - 1) / SCAN_THREADS), SPLITS);
  scan_kernel<<<grid, SCAN_THREADS, 0, s>>>(
      (const int32_t*)rkeys, (const int32_t*)rep_sel, rp, (int32_t*)best,
      (int64_t)Q, R, (int64_t)lcap);
  return cudaGetLastError();
}

// the backup half of query qi (key q); every lane of the warp must call
// it, and all get the same result (every branch is warp-uniform)
__device__ __forceinline__ Probe backup_finish(
    const int32_t* __restrict__ rep_sel, const Replicas& rp,
    const int32_t* __restrict__ best, int64_t qi, int32_t q, int R,
    int64_t cap, int64_t lcap, int fanout, int levels, int lane) {
  const int sel = last_selected(rep_sel, qi, R);
  if (sel < 0) return Probe{-1, 0, 0};
  const int64_t applied = rp.applied(sel);
  const int64_t tail = rp.tail(sel);
  int64_t seq = -1;
  if (q == KEY_INF && tail - applied < lcap) {
    // every ring slot outside the window reads as KEY_INF: the newest
    // position of the reference's range matches, whatever it holds
    seq = applied + lcap - 1;
  } else if (best[qi] > 0) {
    seq = applied + best[qi] - 1;
  }
  if (seq >= 0) {
    const int64_t idx = seq % lcap;
    const bool put = rp.lops(sel)[idx] == OP_PUT;
    return Probe{put ? rp.laddrs(sel)[idx] : -1, put ? 1 : 0, levels + 1};
  }
  const int32_t* __restrict__ keys = rp.skeys(sel);
  const int64_t pos = descent(keys, q, cap, fanout, levels, lane);
  const int64_t at = pos < cap ? pos : cap - 1;
  const bool found = keys[at] == q;
  return Probe{found ? rp.saddrs(sel)[at] : -1, found ? 1 : 0, levels + 1};
}

}  // namespace histore
