// Mamba-1 selective scan, forward, for sm_90a.
//
// Replaces: src/repro/kernels/mamba_scan.py:53 mamba_scan_kernel (its
// oracle kernels/ref.py:122 ref_mamba_scan; the port's plain version is
// repro_torch.kernels.mamba_scan.mamba_scan_plain).
//
// For each batch row b and channel d it runs the recurrence over t:
//   h[n] = exp(dt[t, d] * A[d, n]) * h[n] + (dt[t, d] * x[t, d]) * B[t, n]
//   y[t, d] = sum_n C[t, n] * h[n]
// with the float32 state carried along S; x, B, C and y are bf16 or float32
// (one type for the four), dt and A float32.
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
// and y; no block divisibility is needed.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int G = 4;              // threads per channel: N split across them
constexpr int DB = 32;            // channels per block
constexpr int THREADS = DB * G;   // 128
constexpr int TC = 32;            // time steps staged per chunk

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int NPT>
__global__ void __launch_bounds__(THREADS)
    mamba_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const T* __restrict__ Bm, const T* __restrict__ Cm,
                      const float* __restrict__ A, T* __restrict__ y, int S,
                      int di, int N) {
  constexpr int NS = G * NPT;     // states a channel can hold
  __shared__ float s_dt[TC][DB];
  __shared__ float s_dx[TC][DB];
  __shared__ float s_B[TC][NS];
  __shared__ float s_C[TC][NS];
  __shared__ float s_y[TC][DB];

  const int tid = threadIdx.x;
  const int j = tid % G;          // this thread's states: n = j + G * i
  const int dl = tid / G;
  const int d0 = blockIdx.x * DB;
  const int d = d0 + dl;
  const int64_t b = blockIdx.y;

  float a_n[NPT], h[NPT];
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    const int n = j + G * i;
    a_n[i] = (n < N && d < di) ? A[int64_t(d) * N + n] : 0.f;
    h[i] = 0.f;
  }

  for (int t0 = 0; t0 < S; t0 += TC) {
    const int tc = min(TC, S - t0);
    __syncthreads();              // the last chunk's reads of shared are done
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
    for (int idx = tid; idx < tc * N; idx += THREADS) {
      const int tt = idx / N, nn = idx % N;
      const int64_t off = (b * S + t0 + tt) * int64_t(N) + nn;
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
        if (n < N) {
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
    for (int idx = tid; idx < tc * DB; idx += THREADS) {
      const int tt = idx / DB, dd = idx % DB, dg = d0 + dd;
      if (dg < di)
        y[(b * S + t0 + tt) * int64_t(di) + dg] = from_f<T>(s_y[tt][dd]);
    }
  }
}

template <typename T, int NPT>
void launch(const void* x, const void* dt, const void* Bm, const void* Cm,
            const void* A, void* y, int Bsz, int S, int di, int N,
            cudaStream_t stream) {
  const dim3 grid((di + DB - 1) / DB, Bsz);
  mamba_scan_kernel<T, NPT><<<grid, THREADS, 0, stream>>>(
      (const T*)x, (const float*)dt, (const T*)Bm, (const T*)Cm,
      (const float*)A, (T*)y, S, di, N);
}

template <typename T>
int dispatch(const void* x, const void* dt, const void* Bm, const void* Cm,
             const void* A, void* y, int Bsz, int S, int di, int N,
             cudaStream_t stream) {
  if (N <= G)
    launch<T, 1>(x, dt, Bm, Cm, A, y, Bsz, S, di, N, stream);
  else if (N <= 2 * G)
    launch<T, 2>(x, dt, Bm, Cm, A, y, Bsz, S, di, N, stream);
  else if (N <= 4 * G)
    launch<T, 4>(x, dt, Bm, Cm, A, y, Bsz, S, di, N, stream);
  else if (N <= 8 * G)
    launch<T, 8>(x, dt, Bm, Cm, A, y, Bsz, S, di, N, stream);
  else if (N <= 16 * G)
    launch<T, 16>(x, dt, Bm, Cm, A, y, Bsz, S, di, N, stream);
  else
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// x, B, C, y: bf16 when is_bf16, else float32; dt, A: float32.  All
// contiguous: x, dt, y [Bsz, S, di]; B, C [Bsz, S, N]; A [di, N], N <= 64.
extern "C" int histore_mamba_scan(const void* x, const void* dt,
                                  const void* Bm, const void* Cm,
                                  const void* A, void* y, int Bsz, int S,
                                  int di, int N, int is_bf16, void* stream) {
  if (Bsz <= 0 || S <= 0 || di <= 0) return (int)cudaGetLastError();
  if (N <= 0 || Bsz > 65535) return (int)cudaErrorInvalidValue;
  const int st =
      is_bf16 ? dispatch<__nv_bfloat16>(x, dt, Bm, Cm, A, y, Bsz, S, di, N,
                                        (cudaStream_t)stream)
              : dispatch<float>(x, dt, Bm, Cm, A, y, Bsz, S, di, N,
                                (cudaStream_t)stream);
  if (st != 0) return st;
  return (int)cudaGetLastError();
}
