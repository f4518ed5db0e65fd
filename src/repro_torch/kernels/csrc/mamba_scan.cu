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
// more tightly than its bytes (x, dt, y: about 2.15 GB, 0.64 ms) and its
// four float32 operations per exponential (about 0.5 ms).
//
// Design: sequential along time, the independent work hoisted.  Why not
// a scan that is parallel along time: x, dt and y are [B, S, di], so the
// coalesced axis is the channel, and di x N = 131072 independent
// recurrences at B = 1 already give 1024 warps, 2 for each of the 528
// schedulers.  What a scheduler needs is independent work inside each
// warp, and the recurrence has plenty: a state's critical path is one FMA
// a step (h = a * h + b), while the exponential and dt * x * B of every
// step do not depend on h.  A time-parallel scan would add a running
// product of the decays, a cross-thread scan and a second FMA to every
// element (about 40% more issue, and the SFU-bound kernel then becomes
// issue-bound) to buy parallelism this layout does not lack.
//   * Warp-specialised blocks of 8 warps.  4 scanning warps own 32
//     channels of one batch row, a lane each, and split a tile of at most
//     64 states: warp w holds states [w NPT, (w + 1) NPT) of its 32
//     channels in registers.  So a step's B and C are one address for a
//     warp (a broadcast read of shared memory), dt and dt * x one float2
//     a lane, and each warp stores its part of y; no shuffles.  4 staging
//     warps load the next chunk of TC = 32 steps (dt, x, B, C, coalesced
//     along channels and states) into registers while the scanning warps
//     scan this one, store it to shared memory as float32 (dt * x formed
//     once per (t, d), B and C converted once per block), and write the
//     last chunk's y back, the 4 parts summed, coalesced.  Two stages of
//     shared memory; named barriers hand each stage over (FULL: staged,
//     EMPTY: scanned), so the scan never waits on device memory and no
//     barrier stops the whole block.  (cp.async would need aligned 4-, 8-
//     or 16-byte pieces, which 2-byte elements at an odd di or N do not
//     give, and would leave every reading thread to convert them.)  The
//     grid is flat, (di / 32 blocks) x B along grid.x, so B is not
//     bounded by grid.y; 2 blocks an SM (128 registers a thread).
//   * The scan runs U = 8 steps at a time (fewer above 16 states): their
//     shared-memory reads are issued together, then their U x NPT
//     independent exponentials around the NPT one-FMA chains, then their
//     parts of y are stored.  Exponentials are ex2.approx on
//     dt * (A log2 e), A prescaled once per state: one SFU operation and
//     one multiply each, exactly one per (b, t, d, n).
//   * No predicate in the step loop: steps past S and channels past di
//     are staged with dt = 0 (a decay of 1 and no input), states past N
//     with A = B = C = 0, so they leave h unchanged and add nothing to y.
//   * A state wider than 64 is run in tiles of 64 states, one after the
//     other in the block: each tile runs the whole sequence and adds its
//     part of y into a float32 accumulator (y itself for float32, a
//     scratch the wrapper gives otherwise), and the last tile writes y.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int W = 4;              // scanning warps: the state groups of a tile
constexpr int DB = 32;            // channels a block: a lane each
constexpr int STAGERS = 128;      // staging threads: 4 warps
constexpr int THREADS = STAGERS + 32 * W;   // 256
constexpr int NPT_MAX = 16;       // states a thread holds: tiles of 64
constexpr int TC = 32;            // steps of a chunk
constexpr int FULL = 1, EMPTY = 3;  // named barriers, one pair a stage
constexpr float LOG2E = 1.4426950408889634f;

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
template <typename T>
__device__ __forceinline__ T zero() { return from_f<T>(0.f); }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the stage handoff: a named barrier of all THREADS, which one side
// passes without waiting (arrive) and the other waits on (sync)
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(THREADS) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  __threadfence_block();
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(THREADS) : "memory");
}

// NPT consecutive floats from 16-byte-aligned shared memory (NPT in 1, 2, 4k)
template <int NPT>
__device__ __forceinline__ void load_states(const float* p, float* v) {
  if constexpr (NPT % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NPT; i += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + i);
      v[i] = f.x; v[i + 1] = f.y; v[i + 2] = f.z; v[i + 3] = f.w;
    }
  } else if constexpr (NPT == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x; v[1] = f.y;
  } else {
    v[0] = p[0];
  }
}

template <int NPT>
struct Cfg {
  static constexpr int NS = W * NPT;                  // states of a tile
  // steps whose shared-memory reads are issued together: 8, or fewer
  // where 2 U NPT values of B and C would crowd the registers
  static constexpr int U = NPT <= 4 ? 8 : 32 / NPT;
  static constexpr int EX = TC * DB / STAGERS;        // dt, x a stager loads
  static constexpr int EB = TC * NS / STAGERS;        // B, C a stager loads
  static_assert(TC * DB % STAGERS == 0 && TC * NS % STAGERS == 0, "");
  static_assert(TC % U == 0 && STAGERS % NS == 0, "");
};

// the block's shared memory, two stages: a chunk's (dt, dt * x) per
// (t, channel), B and C per (t, state), and each scanning warp's part of
// its y per (t, channel)
template <int NPT>
struct Smem {
  static constexpr int NS = Cfg<NPT>::NS;
  float2 dtdx[2][TC][DB];
  __align__(16) float B[2][TC][NS];
  __align__(16) float C[2][TC][NS];
  float y[2][W][TC][DB];
};

// one chunk's inputs in a stager's registers, loaded a chunk ahead
template <typename T, int NPT>
struct Staged {
  float dt[Cfg<NPT>::EX];
  T x[Cfg<NPT>::EX];
  T b[Cfg<NPT>::EB];
  T c[Cfg<NPT>::EB];
};

// The chunks of all tiles in order, k = tile * nchunks + c; chunk k
// uses stage k % 2.
template <typename T, int NPT>
__global__ void __launch_bounds__(THREADS, 2)
    mamba_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const T* __restrict__ Bm, const T* __restrict__ Cm,
                      const float* __restrict__ A, T* y, float* yacc,
                      int S, int di, int N) {
  using K = Cfg<NPT>;
  constexpr int NS = K::NS, U = K::U;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<NPT>& sm = *reinterpret_cast<Smem<NPT>*>(smem_raw);

  const int nd = (di + DB - 1) / DB;
  const int64_t b = blockIdx.x / nd;
  const int d0 = int(blockIdx.x % nd) * DB;
  const int nchunks = (S + TC - 1) / TC;
  const int ntiles = (N + NS - 1) / NS;
  const int64_t total = int64_t(ntiles) * nchunks;
  const int lane = threadIdx.x % DB;
  const int d = d0 + lane;          // every thread's channel

  if (threadIdx.x < STAGERS) {
    // ---- staging warps: load chunk k + 1 while chunk k is scanned ------
    const int p = threadIdx.x;
    const int r0 = p / DB, rb = p / NS, nn = p % NS;
    const int64_t step_x = int64_t(STAGERS / DB) * di;
    const int64_t step_b = int64_t(STAGERS / NS) * N;
    Staged<T, NPT> st;
    // chunk k's inputs into registers (zeros past the edges)
    auto load = [&](int64_t k) {
      const int tile = int(k / nchunks), t0 = int(k % nchunks) * TC;
      const int n0 = tile * NS, nt = min(NS, N - n0);
      const int64_t o = (b * S + t0 + r0) * int64_t(di) + d;
#pragma unroll
      for (int e = 0; e < K::EX; ++e) {
        const bool ok = d < di && t0 + r0 + e * (STAGERS / DB) < S;
        st.dt[e] = ok ? dt[o + e * step_x] : 0.f;
        st.x[e] = ok ? x[o + e * step_x] : zero<T>();
      }
      const int64_t ob = (b * S + t0 + rb) * int64_t(N) + n0 + nn;
#pragma unroll
      for (int e = 0; e < K::EB; ++e) {
        const bool ok = nn < nt && t0 + rb + e * (STAGERS / NS) < S;
        st.b[e] = ok ? Bm[ob + e * step_b] : zero<T>();
        st.c[e] = ok ? Cm[ob + e * step_b] : zero<T>();
      }
    };
    // the registers into stage s, as float32, dt * x formed once
    auto store = [&](int s) {
#pragma unroll
      for (int e = 0; e < K::EX; ++e)
        sm.dtdx[s][r0 + e * (STAGERS / DB)][lane] =
            make_float2(st.dt[e], st.dt[e] * to_f(st.x[e]));
#pragma unroll
      for (int e = 0; e < K::EB; ++e) {
        sm.B[s][rb + e * (STAGERS / NS)][nn] = to_f(st.b[e]);
        sm.C[s][rb + e * (STAGERS / NS)][nn] = to_f(st.c[e]);
      }
    };
    // chunk k's y, the scanning warps' parts summed, to device memory;
    // each (t, channel) has one owner thread, the same in every tile, so
    // yacc is read back only by the thread that wrote it
    auto write_y = [&](int64_t k) {
      const int s = int(k & 1);
      const int tile = int(k / nchunks), t0 = int(k % nchunks) * TC;
      const bool first = tile == 0, last = tile == ntiles - 1;
      const int64_t o = (b * S + t0 + r0) * int64_t(di) + d;
#pragma unroll
      for (int e = 0; e < K::EX; ++e) {
        const int tt = r0 + e * (STAGERS / DB);
        if (d < di && t0 + tt < S) {
          float v = 0.f;
#pragma unroll
          for (int g = 0; g < W; ++g) v += sm.y[s][g][tt][lane];
          const int64_t off = o + e * step_x;
          if (!first) v += yacc[off];
          if (last)
            y[off] = from_f<T>(v);
          else
            yacc[off] = v;
        }
      }
    };

    load(0);
    for (int64_t k = 0; k < total; ++k) {
      const int s = int(k & 1);
      if (k >= 2) {                 // stage s and its y free: chunk k - 2
        bar_sync(EMPTY + s);        // is scanned
        write_y(k - 2);
      }
      store(s);
      bar_arrive(FULL + s);
      if (k + 1 < total) load(k + 1);
    }
    for (int64_t k = total >= 2 ? total - 2 : 0; k < total; ++k) {
      bar_sync(EMPTY + int(k & 1));
      write_y(k);
    }
  } else {
    // ---- scanning warps: warp w holds states w NPT + i of the tile -----
    const int w = (threadIdx.x - STAGERS) / 32;
    float a2[NPT], h[NPT];
    for (int64_t k = 0; k < total; ++k) {
      const int s = int(k & 1);
      if (k % nchunks == 0) {       // a new tile of states
        const int n0 = int(k / nchunks) * NS, nt = min(NS, N - n0);
#pragma unroll
        for (int i = 0; i < NPT; ++i) {
          const int n = w * NPT + i;
          a2[i] = (n < nt && d < di) ? A[int64_t(d) * N + n0 + n] * LOG2E
                                     : 0.f;
          h[i] = 0.f;
        }
      }
      bar_sync(FULL + s);
      // U steps at a time: all their shared-memory reads first, then the
      // exponentials and the chains, then their parts of y
#pragma unroll 1
      for (int tb = 0; tb < TC; tb += U) {
        float2 dx[U];
        float bv[U][NPT], cv[U][NPT], ys[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          dx[u] = sm.dtdx[s][tb + u][lane];
          load_states<NPT>(&sm.B[s][tb + u][w * NPT], bv[u]);
          load_states<NPT>(&sm.C[s][tb + u][w * NPT], cv[u]);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float acc = 0.f;
#pragma unroll
          for (int i = 0; i < NPT; ++i) {
            h[i] = fmaf(ex2(dx[u].x * a2[i]), h[i], dx[u].y * bv[u][i]);
            acc = fmaf(cv[u][i], h[i], acc);
          }
          ys[u] = acc;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) sm.y[s][w][tb + u][lane] = ys[u];
      }
      bar_arrive(EMPTY + s);
    }
  }
}

template <typename T, int NPT>
cudaError_t launch(const void* x, const void* dt, const void* Bm,
                   const void* Cm, const void* A, void* y, void* yacc,
                   int64_t Bsz, int S, int di, int N, cudaStream_t stream) {
  const int64_t blocks = int64_t((di + DB - 1) / DB) * Bsz;
  const int bytes = int(sizeof(Smem<NPT>));
  // above 48 KB a block's shared memory must be asked for
  const cudaError_t e = cudaFuncSetAttribute(
      mamba_scan_kernel<T, NPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return e;
  mamba_scan_kernel<T, NPT><<<unsigned(blocks), THREADS, bytes, stream>>>(
      (const T*)x, (const float*)dt, (const T*)Bm, (const T*)Cm,
      (const float*)A, (T*)y, (float*)yacc, S, di, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* dt, const void* Bm,
                     const void* Cm, const void* A, void* y, void* yacc,
                     int64_t Bsz, int S, int di, int N, cudaStream_t st) {
  if (N <= W)
    return launch<T, 1>(x, dt, Bm, Cm, A, y, yacc, Bsz, S, di, N, st);
  if (N <= 2 * W)
    return launch<T, 2>(x, dt, Bm, Cm, A, y, yacc, Bsz, S, di, N, st);
  if (N <= 4 * W)
    return launch<T, 4>(x, dt, Bm, Cm, A, y, yacc, Bsz, S, di, N, st);
  if (N <= 8 * W)
    return launch<T, 8>(x, dt, Bm, Cm, A, y, yacc, Bsz, S, di, N, st);
  return launch<T, NPT_MAX>(x, dt, Bm, Cm, A, y, yacc, Bsz, S, di, N, st);
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
  if (N > W * NPT_MAX && yacc == nullptr) {
    if (dtype != 0) return (int)cudaErrorInvalidValue;
    yacc = y;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(x, dt, Bm, Cm, A, y, yacc, Bsz, S,
                                        di, N, st);
  if (dtype == 2)
    return (int)dispatch<__half>(x, dt, Bm, Cm, A, y, yacc, Bsz, S, di, N,
                                 st);
  return (int)dispatch<float>(x, dt, Bm, Cm, A, y, yacc, Bsz, S, di, N, st);
}
