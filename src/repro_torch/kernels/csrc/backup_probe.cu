// Degraded-read probe across the sorted replicas, for sm_90a.
//
// Replaces: src/repro/kernels/_fused.py:283 backup_probe_kernel (bodies
// _backup_combine :112, _pending_lookup :97, _descent :83).  Bit-exact
// with repro_torch.kernels.ops.backup_probe_plain.
//
// Per lane the last selected replica answers: its pending log window,
// newest entry first, else its sorted replica (the semantics, the
// reference's KEY_INF quirk and the design are in window_scan.cuh, which
// group_probe.cu shares).
//
// Bound: bytes, the descent's node reads (levels x fanout keys per lane
// that misses the log) and the window's keys.  Design: a memset and two
// kernels on one stream: window_scan.cuh's scan_kernel (1024 queries a
// block, the window split into SPLITS slices along the grid, each slice
// built into a shared-memory hash table of the newest position of each
// key and probed once a lane, atomicMax of the newest match) and
// finish_kernel (histore::LANES = 8 lanes a query, histore::backup_finish:
// the lane form's descent, descent.cuh's descent_split, each node of
// levels >= 1 searched as every 8th key then 8, level 0 in 16 B loads;
// the key at pos comes with level 0's node, so a hit reads once more).
#include <cuda_runtime.h>
#include <stdint.h>

#include "window_scan.cuh"

namespace {

__global__ void finish_kernel(const int32_t* __restrict__ rkeys,
                              const int32_t* __restrict__ rep_sel,
                              histore::Replicas rp,
                              const int32_t* __restrict__ best,
                              int32_t* __restrict__ out_addr,
                              int32_t* __restrict__ out_found,
                              int32_t* __restrict__ out_acc, int64_t Q,
                              int R, int64_t cap, int64_t lcap, int fanout,
                              int levels) {
  const int lane = threadIdx.x & (histore::LANES - 1);
  const int64_t qi =
      (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) / histore::LANES;
  if (qi >= Q) return;  // uniform over the query's lanes
  const histore::Probe p = histore::backup_finish(
      rep_sel, rp, best, qi, rkeys[qi], R, cap, lcap, fanout, levels, lane);
  if (lane == 0) {
    out_addr[qi] = p.addr;
    out_found[qi] = p.found;
    out_acc[qi] = p.acc;
  }
}

}  // namespace

// ptrs: a DEVICE table of 7 * R pointers (histore::Replicas).
// best: [Q] int32 scratch.
extern "C" int histore_backup_probe(const void* rkeys, const void* rep_sel,
                                    const void* const* ptrs, void* out_addr,
                                    void* out_found, void* out_acc,
                                    void* best, long long Q, int R,
                                    long long cap, long long lcap,
                                    int fanout, int levels, void* stream) {
  if (R < 1 || cap < 1 || lcap < 1) return (int)cudaErrorInvalidValue;
  const histore::Replicas rp{ptrs};
  if (Q > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t e =
        histore::launch_window_scan(rkeys, rep_sel, rp, best, Q, R, lcap, s);
    if (e != cudaSuccess) return (int)e;
    const int threads = Q >= 32 ? 256 : 32;  // 32 queries a block
    const long long fblocks = (Q * histore::LANES + threads - 1) / threads;
    finish_kernel<<<(unsigned)fblocks, threads, 0, s>>>(
        (const int32_t*)rkeys, (const int32_t*)rep_sel, rp,
        (const int32_t*)best, (int32_t*)out_addr, (int32_t*)out_found,
        (int32_t*)out_acc, (int64_t)Q, R, (int64_t)cap, (int64_t)lcap,
        fanout, levels);
  }
  return (int)cudaGetLastError();
}
