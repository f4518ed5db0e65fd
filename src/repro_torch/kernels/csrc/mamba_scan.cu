// Mamba-1 selective scan, forward, for sm_90a.
//
// Replaces: src/repro/kernels/mamba_scan.py:53 mamba_scan_kernel (its
// oracle kernels/ref.py:122 ref_mamba_scan; the port's plain version is
// repro_torch.kernels.mamba_scan.mamba_scan_plain).
//
// For each batch row b and channel d it runs the recurrence over t:
//   h[n] = exp(dt[t, d] * A[d, n]) * h[n] + (dt[t, d] * x[t, d]) * B[t, n]
//   y[t, d] = sum_n C[t, n] * h[n]
// with the float32 state carried along S; x, B, C and y are bf16, float16
// or float32 (one type for the four), dt and A float32.  Any B, S, di, N.
//
// Bound: at B = 1, S = 32768, di = 8192, N = 16 the S * di * N = 4.3e9
// exponentials at the SFU's 16 per clock per SM (about 1 ms) bound it
// more tightly than its bytes (x, dt, y: about 2.15 GB, 0.64 ms).
// Design: the TPU kernel's sequential grid axis over sequence chunks
// becomes a loop inside the block.  A block owns 32 channels of one batch
// row; four threads share a channel and each keeps ceil(N / 4) of its N
// states in registers (the sum over n is finished with two warp
// shuffles).  Each chunk of 32 time steps of dt, dt * x, B and C is staged
// in shared memory with coalesced loads, and the chunk's y is written back
// coalesced from shared memory.  Nothing in device memory but the inputs
// and y; no block divisibility is needed.  A state wider than 64 is run in
// tiles of 64 states, one after the other in the block: each tile runs the
// whole sequence and adds its part of y into a float32 accumulator (y
// itself for float32, a scratch the wrapper gives otherwise), and the last
// tile writes y.  The grid is flat, (di / 32 blocks) x B along grid.x, so
// B is not bounded by grid.y.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int G = 4;              // threads per channel: N split across them
constexpr int DB = 32;            // channels per block
constexpr int THREADS = DB * G;   // 128
constexpr int TC = 32;            // time steps staged per chunk
constexpr int NPT_MAX = 16;       // states a thread holds: tiles of 64

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half(v);
}

template <typename T, int NPT>
__global__ void __launch_bounds__(THREADS)
    mamba_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const T* __restrict__ Bm, const T* __restrict__ Cm,
                      const float* __restrict__ A, T* y, float* yacc,
                      int S, int di, int N) {
  constexpr int NS = G * NPT;     // states a tile holds
  __shared__ float s_dt[TC][DB];
  __shared__ float s_dx[TC][DB];
  __shared__ float s_B[TC][NS];
  __shared__ float s_C[TC][NS];
  __shared__ float s_y[TC][DB];

  const int tid = threadIdx.x;
  const int j = tid % G;          // this thread's states: n = n0 + j + G * i
  const int dl = tid / G;
  const int nd = (di + DB - 1) / DB;
  const int64_t b = blockIdx.x / nd;
  const int d0 = int(blockIdx.x % nd) * DB;
  const int d = d0 + dl;

  for (int n0 = 0; n0 < N; n0 += NS) {
    const int nt = min(NS, N - n0);   // states of this tile
    const bool first = n0 == 0, last = n0 + NS >= N;
    float a_n[NPT], h[NPT];
#pragma unroll
    for (int i = 0; i < NPT; ++i) {
      const int n = j + G * i;
      a_n[i] = (n < nt && d < di) ? A[int64_t(d) * N + n0 + n] : 0.f;
      h[i] = 0.f;
    }

    for (int t0 = 0; t0 < S; t0 += TC) {
      const int tc = min(TC, S - t0);
      __syncthreads();            // the last chunk's reads of shared are done
      for (int idx = tid; idx < tc * DB; idx += THREADS) {
        const int tt = idx / DB, dd = idx % DB, dg = d0 + dd;
        float dv = 0.f, xv = 0.f;
        if (dg < di) {
          const int64_t off = (b * S + t0 + tt) * int64_t(di) + dg;
          dv = dt[off];
          xv = to_f(x[off]);
        }
        s_dt[tt][dd] = dv;
        s_dx[tt][dd] = dv * xv;
      }
      for (int idx = tid; idx < tc * nt; idx += THREADS) {
        const int tt = idx / nt, nn = idx % nt;
        const int64_t off = (b * S + t0 + tt) * int64_t(N) + n0 + nn;
        s_B[tt][nn] = to_f(Bm[off]);
        s_C[tt][nn] = to_f(Cm[off]);
      }
      __syncthreads();
      for (int tt = 0; tt < tc; ++tt) {
        const float dtv = s_dt[tt][dl];
        const float dxv = s_dx[tt][dl];
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < NPT; ++i) {
          const int n = j + G * i;
          if (n < nt) {
            const float a = expf(dtv * a_n[i]);
            h[i] = a * h[i] + dxv * s_B[tt][n];
            acc += h[i] * s_C[tt][n];
          }
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        if (j == 0) s_y[tt][dl] = acc;
      }
      __syncthreads();
      // each (tt, dd) has one owner thread, the same in every tile, so it
      // reads back only what it wrote itself
      for (int idx = tid; idx < tc * DB; idx += THREADS) {
        const int tt = idx / DB, dd = idx % DB, dg = d0 + dd;
        if (dg < di) {
          const int64_t off = (b * S + t0 + tt) * int64_t(di) + dg;
          float v = s_y[tt][dd];
          if (!first) v += yacc[off];
          if (last)
            y[off] = from_f<T>(v);
          else
            yacc[off] = v;
        }
      }
    }
  }
}

template <typename T, int NPT>
void launch(const void* x, const void* dt, const void* Bm, const void* Cm,
            const void* A, void* y, void* yacc, int64_t Bsz, int S, int di,
            int N, cudaStream_t stream) {
  const int64_t blocks = int64_t((di + DB - 1) / DB) * Bsz;
  mamba_scan_kernel<T, NPT><<<unsigned(blocks), THREADS, 0, stream>>>(
      (const T*)x, (const float*)dt, (const T*)Bm, (const T*)Cm,
      (const float*)A, (T*)y, (float*)yacc, S, di, N);
}

template <typename T>
void dispatch(const void* x, const void* dt, const void* Bm, const void* Cm,
              const void* A, void* y, void* yacc, int64_t Bsz, int S,
              int di, int N, cudaStream_t stream) {
  if (N <= G)
    launch<T, 1>(x, dt, Bm, Cm, A, y, yacc, Bsz, S, di, N, stream);
  else if (N <= 2 * G)
    launch<T, 2>(x, dt, Bm, Cm, A, y, yacc, Bsz, S, di, N, stream);
  else if (N <= 4 * G)
    launch<T, 4>(x, dt, Bm, Cm, A, y, yacc, Bsz, S, di, N, stream);
  else if (N <= 8 * G)
    launch<T, 8>(x, dt, Bm, Cm, A, y, yacc, Bsz, S, di, N, stream);
  else
    launch<T, NPT_MAX>(x, dt, Bm, Cm, A, y, yacc, Bsz, S, di, N, stream);
}

}  // namespace

// x, B, C, y: float32 (dtype 0), bf16 (1) or float16 (2); dt, A: float32.
// All contiguous: x, dt, y [Bsz, S, di]; B, C [Bsz, S, N]; A [di, N].
// yacc: a float32 [Bsz, S, di] accumulator when N > 64 and y is not float32
// (y itself serves for float32), else unused.
extern "C" int histore_mamba_scan(const void* x, const void* dt,
                                  const void* Bm, const void* Cm,
                                  const void* A, void* y, void* yacc,
                                  long long Bsz, int S, int di, int N,
                                  int dtype, void* stream) {
  if (Bsz <= 0 || S <= 0 || di <= 0) return (int)cudaGetLastError();
  if (N <= 0 || dtype < 0 || dtype > 2 ||
      (long long)((di + DB - 1) / DB) * Bsz > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (N > G * NPT_MAX && yacc == nullptr) {
    if (dtype != 0) return (int)cudaErrorInvalidValue;
    yacc = y;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    dispatch<__nv_bfloat16>(x, dt, Bm, Cm, A, y, yacc, Bsz, S, di, N, st);
  else if (dtype == 2)
    dispatch<__half>(x, dt, Bm, Cm, A, y, yacc, Bsz, S, di, N, st);
  else
    dispatch<float>(x, dt, Bm, Cm, A, y, yacc, Bsz, S, di, N, st);
  return (int)cudaGetLastError();
}
