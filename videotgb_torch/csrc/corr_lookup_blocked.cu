// Query-blocked RAFT correlation-pyramid lookup for Hopper (sm_90a), plain
// C interface.
//
// Replaces the Pallas TPU kernel tools/lookupprobe.py::_blocked_kernel
// (driven by blocked_lookup). It computes the same function as
// corr_lookup.cu (the windowed bilinear lookup, r <= 4, zero padding, f32
// sums, output (P, Q, L*(2r+1)^2) in the pyramid's dtype, channel
// l*(2r+1)^2 + (x offset)*(2r+1) + (y offset)), but reads the query-minor
// pyramid the other way round: kernel B gathers each query's taps, which lie
// Q elements apart; this kernel streams whole scanlines of a block of
// queries, pyr[p, y*wl : (y+1)*wl, q0 : q0+qb], which are contiguous along
// the queries, through shared memory.
//
//   * One block per (pair, block of qb queries; 128 is ~4.5 scanlines of a
//     28-wide map), 3*qb threads: thread (q, g) owns query q and the three
//     y offsets 3g .. 3g+2, with 9 x-offset accumulators each (27 f32).
//   * Per level, the block streams a window of scanlines through a fixed
//     64 KB of shared memory, a chunk of rows at a time (a whole level-0 map
//     of a 128-query block is 200 KB in bf16 and 400 KB in f32, beyond a
//     block's 227 KB). The rows stay in the pyramid's dtype and arrive by
//     16-byte cp.async, every copy of a chunk in flight at once: with one
//     384-thread block per SM, loads issued a few at a time leave the kernel
//     waiting on memory latency. Q must be a multiple of 8 (bf16) or 4
//     (f32) queries, so that a copy holds whole queries.
//     With skip, the window is [floor(min cy/2^l) - r - 1,
//     floor(max cy/2^l) + r + 2] over the block's queries, clipped to the
//     map: the TPU probe's "qskip" row skipping, done exactly (the bounds
//     carry one spare row each side for f32 rounding of cy/2^l + offset).
//     Without skip, every scanline of the level is streamed (the TPU
//     probe's "qblock").
//   * A staged scanline contributes to a y offset only where it is one of
//     that offset's two bilinear rows; out-of-map taps are zero, as in the
//     dense hat-weight form of the plain version.
//   * The block's outputs of one level (qb x 81) are staged in shared memory
//     (row stride 81, odd, so lanes of consecutive queries hit distinct
//     banks) and written as runs of 81 contiguous channels per query.
//
// Bound on the H100: memory. The bytes a lookup must move are the in-map
// part of each query's (2r+2)^2 corner window per level, the coordinates
// and the output; at 256 pairs of 28x28 in bf16 the output alone is 130 MB
// (~39 us at 3.35 TB/s). The kernel reads every scanline of its window for
// all qb queries, more than each query needs, but coalesced.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kGroups = 3;               // threads per query
constexpr int kJ = 3;                    // y offsets per thread
constexpr int kMaxK = kGroups * kJ;      // 2r+1 <= 9
constexpr int kMaxQB = 128;
constexpr int kRowBytes = 64 * 1024;     // staged scanlines per chunk

struct Params {
  const void* level[kMaxLevels];
  int hl[kMaxLevels];
  int wl[kMaxLevels];
  int n_levels;
  const float* coords;  // (P, Q, 2) as (x, y)
  void* out;            // (P, Q, n_levels * K * K)
  int P, Q, radius, qb, skip;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

// float -> int for a row bound, clamped first so that no conversion
// overflows
__device__ __forceinline__ int clamp_row(float y, int hl) {
  return static_cast<int>(fminf(fmaxf(y, -1.f), static_cast<float>(hl)));
}

template <typename T>
__global__ void __launch_bounds__(kGroups * kMaxQB)
corr_lookup_blocked_kernel(const Params p) {
  extern __shared__ float smem[];
  __shared__ float red[2][kGroups * kMaxQB / 32];
  const int qb = p.qb;
  const int K = 2 * p.radius + 1;
  const int KK = K * K;
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // queries per copy
  float* outs = smem;                                  // [qb][KK], one level
  T* rows = reinterpret_cast<T*>(smem + qb * KK);      // [R][wl][qb]
  const int vpp = qb / kVec;  // copies per (row, x) position

  const int pair = blockIdx.y;
  const int q0 = blockIdx.x * qb;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int ql = tid % qb;  // qb is a multiple of 32: a warp has one g
  const int g = tid / qb;
  const int q = q0 + ql;
  const bool valid = q < p.Q;
  const int ncols = p.n_levels * KK;

  float cx = 0.f, cy = 0.f;
  if (valid) {
    cx = p.coords[(static_cast<long long>(pair) * p.Q + q) * 2];
    cy = p.coords[(static_cast<long long>(pair) * p.Q + q) * 2 + 1];
  }
  // the block's min and max cy over its valid queries
  float ymin = valid ? cy : INFINITY;
  float ymax = valid ? cy : -INFINITY;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ymin = fminf(ymin, __shfl_xor_sync(0xffffffffu, ymin, off));
    ymax = fmaxf(ymax, __shfl_xor_sync(0xffffffffu, ymax, off));
  }
  if ((tid & 31) == 0) {
    red[0][tid >> 5] = ymin;
    red[1][tid >> 5] = ymax;
  }
  __syncthreads();
  for (int w = 0; w < nthreads / 32; ++w) {
    ymin = fminf(ymin, red[0][w]);
    ymax = fmaxf(ymax, red[1][w]);
  }

  for (int lvl = 0; lvl < p.n_levels; ++lvl) {
    const int hl = p.hl[lvl];
    const int wl = p.wl[lvl];
    const T* map = static_cast<const T*>(p.level[lvl]) +
                   static_cast<long long>(pair) * hl * wl * p.Q + q0;
    const float sc = 1.0f / static_cast<float>(1 << lvl);

    // this thread's bilinear taps, computed as corr_lookup.cu does
    int y0[kJ], x0[kMaxK];
    float ty[kJ], tx[kMaxK];
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) {
      const int j = g * kJ + jj;
      const float y = cy * sc + static_cast<float>(j - p.radius);
      const float yf = floorf(y);
      ty[jj] = y - yf;
      // a y offset past 2r, or a query past Q, matches no row
      y0[jj] = (j < K && valid) ? static_cast<int>(yf) : -0x40000000;
    }
#pragma unroll
    for (int i = 0; i < kMaxK; ++i) {
      const float x = cx * sc + static_cast<float>(i - p.radius);
      const float xf = floorf(x);
      tx[i] = x - xf;
      x0[i] = static_cast<int>(xf);
    }
    float acc[kJ][kMaxK];
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj)
#pragma unroll
      for (int i = 0; i < kMaxK; ++i) acc[jj][i] = 0.f;

    int lo = 0, hi = hl - 1;
    if (p.skip) {
      lo = max(lo, clamp_row(floorf(ymin * sc) - p.radius - 1, hl));
      hi = min(hi, clamp_row(floorf(ymax * sc) + p.radius + 2, hl));
    }
    // rows per chunk, >= 1 (checked on the host)
    const int per_chunk =
        kRowBytes / (wl * qb * static_cast<int>(sizeof(T)));
    for (int y_start = lo; y_start <= hi; y_start += per_chunk) {
      const int nr = min(per_chunk, hi - y_start + 1);
      __syncthreads();  // the previous chunk is consumed
      // 16-byte asynchronous copies of the chunk's (row, x) positions for
      // the block's queries, all in flight at once
      const int n = nr * wl * vpp;
      for (int v = tid; v < n; v += nthreads) {
        const int pos = v / vpp;
        const int qv = (v - pos * vpp) * kVec;
        T* dst = rows + pos * qb + qv;
        if (q0 + qv < p.Q)
          __pipeline_memcpy_async(
              dst, map + static_cast<long long>(y_start * wl + pos) * p.Q + qv,
              16);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncthreads();
      for (int r = 0; r < nr; ++r) {
        const int y = y_start + r;
        const T* row = rows + r * wl * qb + ql;
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj) {
          float wy;
          if (y == y0[jj]) {
            wy = 1.f - ty[jj];
          } else if (y == y0[jj] + 1) {
            wy = ty[jj];
          } else {
            continue;
          }
#pragma unroll
          for (int i = 0; i < kMaxK; ++i) {
            const int xa = x0[i];
            const float va = (xa >= 0 && xa < wl) ? to_f(row[xa * qb]) : 0.f;
            const float vb =
                (xa + 1 >= 0 && xa + 1 < wl) ? to_f(row[(xa + 1) * qb]) : 0.f;
            acc[jj][i] += wy * ((1.f - tx[i]) * va + tx[i] * vb);
          }
        }
      }
    }

    // stage this level's (qb, KK) outputs, then write them coalesced
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) {
      const int j = g * kJ + jj;
      if (j >= K) continue;
#pragma unroll
      for (int i = 0; i < kMaxK; ++i)
        if (i < K) outs[ql * KK + i * K + j] = acc[jj][i];
    }
    __syncthreads();
    T* out = static_cast<T*>(p.out) +
             (static_cast<long long>(pair) * p.Q + q0) * ncols + lvl * KK;
    for (int e = tid; e < qb * KK; e += nthreads) {
      const int qq = e / KK;
      if (q0 + qq < p.Q)
        out[static_cast<long long>(qq) * ncols + (e - qq * KK)] =
            from_f<T>(outs[e]);
    }
    __syncthreads();  // outs is free for the next level
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int smem = p.qb * (2 * p.radius + 1) * (2 * p.radius + 1) * 4 +
                   kRowBytes;
  cudaError_t err = cudaFuncSetAttribute(
      corr_lookup_blocked_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Q + p.qb - 1) / p.qb, p.P);
  corr_lookup_blocked_kernel<T><<<grid, kGroups * p.qb, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// levels: host array of n_levels device pointers, each (P, hl*wl, Q);
// hl / wl: host arrays of the level sizes; coords: device (P, Q, 2) f32;
// out: device (P, Q, n_levels*(2r+1)^2). qb: queries per block, a multiple
// of 32 up to 128; skip: stream only the scanlines the block's queries
// touch. dtype: 0 = float32, 1 = bfloat16. Returns the launch's
// cudaError_t; the kernel does not synchronise.
extern "C" int corr_lookup_blocked(const void* const* levels, const int* hl,
                                   const int* wl, int n_levels,
                                   const void* coords, void* out, int P,
                                   int Q, int radius, int qb, int skip,
                                   int dtype, void* stream) {
  if (n_levels <= 0 || n_levels > kMaxLevels || P <= 0 || P > 65535 ||
      Q <= 0 || radius < 0 || 2 * radius + 1 > kMaxK || qb < 32 ||
      qb > kMaxQB || qb % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // a 16-byte copy holds whole queries and stays aligned
  const int esize = dtype == 0 ? 4 : 2;
  if (Q % (16 / esize) != 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  for (int l = 0; l < kMaxLevels; ++l) {
    p.level[l] = l < n_levels ? levels[l] : nullptr;
    p.hl[l] = l < n_levels ? hl[l] : 0;
    p.wl[l] = l < n_levels ? wl[l] : 0;
    if (l < n_levels && (p.hl[l] <= 0 || p.wl[l] <= 0 ||
                         p.wl[l] * qb * esize > kRowBytes))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  p.n_levels = n_levels;
  p.coords = static_cast<const float*>(coords);
  p.out = out;
  p.P = P;
  p.Q = Q;
  p.radius = radius;
  p.qb = qb;
  p.skip = skip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(p, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(p, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
