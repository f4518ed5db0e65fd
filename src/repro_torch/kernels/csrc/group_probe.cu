// The fused GET probe of the distributed store, for sm_90a.
//
// Replaces: src/repro/kernels/_fused.py:332 group_probe_kernel (body
// _group_body: _hash_probe :68 + _backup_combine :112).  Bit-exact with
// repro_torch.kernels.ops.group_probe_plain (hash_index.lookup plus
// backup_probe_plain).
//
// For one group and Q queries it returns six [Q] int32 arrays: the hash
// half (h_addr, h_found, h_acc), the chain walk of the group's hash table
// for (bucket, qsig, qfp), and the backup half (b_addr, b_found, b_acc),
// the replica-select probe of the replicas the device holds: per lane the
// last selected replica answers from its pending log window, newest entry
// first, else from its sorted replica (window_scan.cuh has the semantics
// and the reference's KEY_INF quirk).
//
// Bound: bytes.  The hash half reads two 128 B chain rows per query; the
// backup half, for each selected lane, the window's keys and the
// descent's levels x fanout keys.  On the store's healthy GET only the
// padding lanes of the exchange buffer select a replica.
// Design: a memset and two kernels on one stream, reusing what
// hash_probe.cu and backup_probe.cu proved: window_scan.cuh's scan_kernel
// (the window's lookup through shared-memory hash tables), whose blocks
// with no selected lane stop after reading their queries,
// then one finishing kernel, a warp per query, that runs hash_walk.cuh's
// chain walk and window_scan.cuh's backup finish and writes all six
// outputs.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_walk.cuh"
#include "window_scan.cuh"

namespace {

__global__ void group_finish_kernel(
    const int32_t* __restrict__ bucket, const int32_t* __restrict__ qsig,
    const int32_t* __restrict__ qfp, const int32_t* __restrict__ rkeys,
    const int32_t* __restrict__ rep_sel, const int32_t* __restrict__ sig,
    const int32_t* __restrict__ fp, const int32_t* __restrict__ haddr,
    const int32_t* __restrict__ fill, histore::Replicas rp,
    const int32_t* __restrict__ best, int32_t* __restrict__ out_ha,
    int32_t* __restrict__ out_hf, int32_t* __restrict__ out_hc,
    int32_t* __restrict__ out_ba, int32_t* __restrict__ out_bf,
    int32_t* __restrict__ out_bc, int64_t Q, int cs, int S, int R,
    int64_t cap, int64_t lcap, int fanout, int levels) {
  const int lane = threadIdx.x & 31;
  const int64_t qi =
      (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (qi >= Q) return;  // warp-uniform
  const histore::Probe h = histore::hash_walk(
      sig, fp, haddr, fill, bucket[qi], qsig[qi], qfp[qi], cs, S, lane);
  const histore::Probe b = histore::backup_finish(
      rep_sel, rp, best, qi, rkeys[qi], R, cap, lcap, fanout, levels, lane);
  if (lane == 0) {
    out_ha[qi] = h.addr;
    out_hf[qi] = h.found;
    out_hc[qi] = h.acc;
    out_ba[qi] = b.addr;
    out_bf[qi] = b.found;
    out_bc[qi] = b.acc;
  }
}

}  // namespace

// bucket/qsig/qfp/rkeys: [Q] int32; rep_sel: [Q, R] int32; sig/fp/haddr:
// [nb, cs] int32; fill: [nb] int32; ptrs: a DEVICE table of 7 * R
// pointers (histore::Replicas); best: [Q] int32 scratch.
extern "C" int histore_group_probe(
    const void* bucket, const void* qsig, const void* qfp,
    const void* rkeys, const void* rep_sel, const void* sig, const void* fp,
    const void* haddr, const void* fill, const void* const* ptrs,
    void* out_ha, void* out_hf, void* out_hc, void* out_ba, void* out_bf,
    void* out_bc, void* best, long long Q, int cs, int S, int R,
    long long cap, long long lcap, int fanout, int levels, void* stream) {
  if (R < 1 || cap < 1 || lcap < 1) return (int)cudaErrorInvalidValue;
  const histore::Replicas rp{ptrs};
  if (Q > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t e =
        histore::launch_window_scan(rkeys, rep_sel, rp, best, Q, R, lcap, s);
    if (e != cudaSuccess) return (int)e;
    const int threads = Q >= 8 ? 256 : 32;  // 8 queries per block
    const long long blocks = (Q * 32 + threads - 1) / threads;
    group_finish_kernel<<<(unsigned)blocks, threads, 0, s>>>(
        (const int32_t*)bucket, (const int32_t*)qsig, (const int32_t*)qfp,
        (const int32_t*)rkeys, (const int32_t*)rep_sel,
        (const int32_t*)sig, (const int32_t*)fp, (const int32_t*)haddr,
        (const int32_t*)fill, rp, (const int32_t*)best, (int32_t*)out_ha,
        (int32_t*)out_hf, (int32_t*)out_hc, (int32_t*)out_ba,
        (int32_t*)out_bf, (int32_t*)out_bc, (int64_t)Q, cs, S, R,
        (int64_t)cap, (int64_t)lcap, fanout, levels);
  }
  return (int)cudaGetLastError();
}
