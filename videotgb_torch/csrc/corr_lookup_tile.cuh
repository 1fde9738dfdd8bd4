// The tile body of the RAFT correlation lookup for Hopper (sm_90a), shared
// by kernel B (corr_lookup.cu, the counterpart of
// videotgb_tpu/ops/correlation_pallas.py::_lookup_kernel) and kernel E
// (corr_lookup_blocked.cu, the counterpart of
// tools/lookupprobe.py::_blocked_kernel).
//
// The function: for pair p, query q at (cx, cy), level l and window offsets
// i (x) and j (y) in [-r, r], r <= 4, sample the level-l map at
// (cx / 2^l + i, cy / 2^l + j) bilinearly with zero padding and write it to
// channel l*(2r+1)^2 + (i+r)*(2r+1) + (j+r) of out (P, Q, L*(2r+1)^2), in
// the pyramid's dtype, from f32 sums. Levels are query-minor, (P, Hl*Wl, Q):
// position (y, x) of a level holds one value for every query, contiguous.
//
// What holds the gather body (corr_lookup.cu) back: a thread per (query,
// level, x offset), so neighbouring lanes read taps Q elements apart and
// each two-byte load fills a 32-byte sector of its own; scattered 18-byte
// stores.
//
// This body:
//   * One block per (pair, run of qb consecutive queries): every copy of the
//     pyramid is a run of qb contiguous queries at one position, so a
//     staged scanline is wl x qb values, [x][query] in shared memory.
//   * Per level it stages only the scanlines its queries reach: query q
//     reads rows floor(cy/2^l) - r .. floor(cy/2^l) + r + 1 (cy/2^l is exact
//     in f32: 2^-l is a power of two), so the window is
//     [floor(min cy/2^l) - r, floor(max cy/2^l) + r + 1] over the block's
//     queries, clipped to the map (ops/correlation_pallas.py::lookup_window
//     mirrors it; with skip = 0, kernel E's "qblock", the whole map).
//   * A producer warp, one thread of it, brings each window in by TMA (a
//     2-D tensor map over (P*Hl*Wl positions, Q queries) per level, a box of
//     one scanline: wl positions x qb queries, zeros past Q) into a ring of
//     two stages on full / empty mbarriers, a chunk of rows a stage; a
//     window longer than a stage is cut into chunks that share one row, so
//     every pair of bilinear rows (y, y + 1) lies in one chunk. The next
//     chunk, and the next level, load while this one is consumed.
//   * Consumers: 3 threads a query, thread g owning x offsets 3g .. 3g + 2.
//     Once its loads overlap, the body is bound by instruction issue (on an
//     H100 a build without loads or waits ran nearly as long as the whole
//     kernel), so the work per output is cut down: per chunk a thread reads its
//     query's 2r + 2 rows at once (addresses clamped into the chunk, 4 reads
//     a row with no predicates: a column or row off the map weighs zero in
//     weights set once per level), lerps them along x (3 a row), forms every
//     y offset (one lerp each) and keeps those whose row pair the chunk holds
//     (the first chunk of a window also those above it, the last those below
//     it: the rows outside the window are off the map). Sums are f32 in
//     registers, 27 a thread per level, stored in packed pairs. (9 threads a
//     query, one x offset each, ran slower: more issue in all.)
//   * Lanes map to queries so that a warp's reads of one staged position hit
//     32 distinct banks: consecutive queries for f32; for bf16 with qb a
//     multiple of 64, every other query of 64.
//   * The block's outputs for all levels, qb * L * (2r+1)^2 values, are one
//     contiguous region of out: staged in shared memory in the output dtype
//     and written by one bulk store.
//
// Bound on the H100: memory. The function needs only each query's corner
// windows, but in the query-minor layout a copy is a run of queries, so the
// body reads whole scanlines of its windows (chip_smoke.py prints these
// bytes beside the bound, and the rate they reach) and writes the output
// once. At the serving path's 16 pairs the 26 MB bf16 pyramid stays in the
// 50 MB L2; at 256 pairs (410 MB) it streams from HBM.
//
// Needs: f32 or bf16, Q a multiple of 16 bytes of queries and 16-byte
// aligned levels (TMA), wl <= 256 (a box dimension), r <= 4, qb a multiple
// of 32 up to 128, and the block's shared memory (smem_bytes, all of it
// dynamic) within 227 KB.
// The C entries refuse anything else; ops/correlation_pallas.py::lookup_body
// sends such inputs of kernel B to the gather body.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <atomic>
#include <chrono>

#include "mma_util.cuh"

namespace corr_tile {

constexpr int kMaxLevels = 8;
constexpr int kMaxK = 9;  // 2r + 1 <= 9
constexpr int kMaxQB = 128;
constexpr int kStages = 2;  // the ring
constexpr int kAlign = 128;  // TMA destinations: stages and staged rows
constexpr int kSmemPerBlock = 232448;
constexpr int kProducer = 32;  // the producer warp

constexpr int kGroups = 3;             // threads a query
constexpr int kPer = kMaxK / kGroups;  // x offsets a thread
constexpr int kMaxThreads = kProducer + kGroups * kMaxQB;
constexpr int kWarps = kMaxThreads / 32;
constexpr int kMaxDevices = 64;
// the block's min and max cy: a float of each a warp
constexpr int kRedBytes = 2 * kWarps * 4;

struct Maps {
  CUtensorMap level[kMaxLevels];
};

struct Params {
  int hl[kMaxLevels];
  int wl[kMaxLevels];
  int n_levels;
  const float* coords;  // (P, Q, 2) as (x, y)
  void* out;            // (P, Q, n_levels * K * K)
  int P, Q, radius, qb, stage_bytes, skip;
};

__host__ __device__ __forceinline__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// bytes of one staged scanline (wl positions of qb queries), padded so that
// every row starts 128-byte aligned
__host__ __device__ __forceinline__ int row_bytes(int wl, int qb, int esize) {
  return round_up(wl * qb * esize, kAlign);
}

// the block's shared memory, all of it dynamic: alignment slack, the output
// tile, the stages, a full and an empty mbarrier per stage and the cy
// reduction
inline int smem_bytes(int qb, int ncols, int esize, int stage_bytes) {
  return kAlign + round_up(qb * ncols * esize, kAlign) +
         kStages * (stage_bytes + 16) + kRedBytes;
}

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

// The rows [lo, hi] of a level (scale sc, hl rows) that queries with cy in
// [ymin, ymax] read; lo > hi where none is on the map.
__device__ __forceinline__ void window(const Params& p, float ymin,
                                       float ymax, float sc, int hl, int& lo,
                                       int& hi) {
  if (!p.skip) {
    lo = 0;
    hi = hl - 1;
    return;
  }
  const float r = static_cast<float>(p.radius);
  lo = static_cast<int>(
      fminf(fmaxf(floorf(ymin * sc) - r, 0.f), static_cast<float>(hl)));
  hi = static_cast<int>(fminf(fmaxf(floorf(ymax * sc) + r + 1.f, -1.f),
                              static_cast<float>(hl - 1)));
}

// floor(v) as an int, clamped to [lo, hi] first (past those every tap of the
// window is off the map, and no conversion overflows)
__device__ __forceinline__ int clamp_floor(float f, int lo, int hi) {
  return static_cast<int>(
      fminf(fmaxf(f, static_cast<float>(lo)), static_cast<float>(hi)));
}

// Store a thread's kPer x K outputs of one level (K = 9: 27 values, one
// contiguous run of the staged output row) in pairs: one conversion and one
// 4-byte (bf16) or 8-byte (f32) store per pair, a single value first where
// the run starts off the pair's alignment.
template <typename T>
__device__ __forceinline__ void store_run(T* o, const float (&a)[kPer][kMaxK]) {
  constexpr int n = kPer * kMaxK;
  auto at = [&](int e) { return a[e / kMaxK][e % kMaxK]; };
  auto pair = [&](int e) {
    if constexpr (sizeof(T) == 2) {
      *reinterpret_cast<__nv_bfloat162*>(o + e) =
          __floats2bfloat162_rn(at(e), at(e + 1));
    } else {
      *reinterpret_cast<float2*>(o + e) = make_float2(at(e), at(e + 1));
    }
  };
  if (reinterpret_cast<uintptr_t>(o) % (2 * sizeof(T)) == 0) {
#pragma unroll
    for (int e = 0; e + 1 < n; e += 2) pair(e);
    o[n - 1] = from_f<T>(at(n - 1));
  } else {
    o[0] = from_f<T>(at(0));
#pragma unroll
    for (int e = 1; e + 1 < n; e += 2) pair(e);
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
tile_kernel(const __grid_constant__ Maps maps, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int esize = static_cast<int>(sizeof(T));
  const int qb = p.qb;
  const int K = 2 * p.radius + 1;
  const int KK = K * K;
  const int ncols = p.n_levels * KK;
  const uint32_t raw = mma_util::smem_addr(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~static_cast<uint32_t>(kAlign - 1);
  uint8_t* const gbase = smem_raw + (base - raw);
  T* const outs = reinterpret_cast<T*>(gbase);  // [qb][ncols]
  const int obytes = round_up(qb * ncols * esize, kAlign);
  const uint32_t stage0 = base + obytes;
  const uint8_t* const gstage0 = gbase + obytes;
  const uint32_t bars = stage0 + kStages * p.stage_bytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  float(*const red)[kWarps] = reinterpret_cast<float(*)[kWarps]>(
      gbase + obytes + kStages * (p.stage_bytes + 16));

  const int pair = blockIdx.y;
  const int q0 = blockIdx.x * qb;
  const int nq = min(qb, p.Q - q0);
  const int lanes = round_up(qb, 32);  // threads of one x-offset group
  const int tid = threadIdx.x;
  const bool producer = tid < kProducer;
  const int c = tid - kProducer;
  const int g = producer ? 0 : c / lanes;
  const int u = producer ? 0 : c - g * lanes;
  // bf16 pairs of neighbouring queries share a 4-byte bank word: with every
  // other query a warp's 32 lanes read 32 distinct words of a position
  const int ql = (esize == 2 && qb % 64 == 0)
                     ? (u & ~63) + 2 * (u & 31) + ((u >> 5) & 1)
                     : u;
  const bool has_query = !producer && ql < nq;
  float cx = 0.f, cy = 0.f;
  if (has_query) {
    const float* xy = p.coords + 2 * (static_cast<long long>(pair) * p.Q +
                                      q0 + ql);
    cx = xy[0];
    cy = xy[1];
  }

  // the block's min and max cy over its queries
  float ymin = has_query ? cy : INFINITY;
  float ymax = has_query ? cy : -INFINITY;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ymin = fminf(ymin, __shfl_xor_sync(0xffffffffu, ymin, off));
    ymax = fmaxf(ymax, __shfl_xor_sync(0xffffffffu, ymax, off));
  }
  if ((tid & 31) == 0) {
    red[0][tid >> 5] = ymin;
    red[1][tid >> 5] = ymax;
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mma_util::mbar_init(full(s), 1);
      mma_util::mbar_init(empty(s), kGroups * lanes / 32);  // one a warp
    }
    mma_util::mbar_init_fence();
  }
  __syncthreads();
  for (int w = 0; w < static_cast<int>(blockDim.x) / 32; ++w) {
    ymin = fminf(ymin, red[0][w]);
    ymax = fmaxf(ymax, red[1][w]);
  }

  if (producer) {
    if (tid != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int l = 0; l < p.n_levels; ++l) {
      const int hl = p.hl[l], wl = p.wl[l];
      int lo, hi;
      window(p, ymin, ymax, 1.f / static_cast<float>(1 << l), hl, lo, hi);
      const int rb = row_bytes(wl, qb, esize);
      const int per_stage = p.stage_bytes / rb;  // >= 2, checked on the host
      const int first = pair * hl * wl;          // position (0, 0) of pair
      for (int s = lo; s <= hi;) {
        const int e = min(s + per_stage - 1, hi);
        mma_util::mbar_wait(empty(stage), phase ^ 1);  // round 0 passes
        mma_util::mbar_arrive_expect_tx(full(stage),
                                        (e - s + 1) * wl * qb * esize);
        const uint32_t dst = stage0 + stage * p.stage_bytes;
        for (int y = s; y <= e; ++y)
          mma_util::tma_load_2d(dst + (y - s) * rb, &maps.level[l],
                                full(stage), q0, first + y * wl);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
        if (e == hi) break;
        s = e;  // the chunks share a row
      }
    }
    return;
  }

  // a consumer: query ql, x offsets kPer * g ..
  const bool active = has_query && kPer * g < K;
  int stage = 0;
  uint32_t phase = 0;
  for (int l = 0; l < p.n_levels; ++l) {
    const int hl = p.hl[l], wl = p.wl[l];
    const float sc = 1.f / static_cast<float>(1 << l);
    int lo, hi;
    window(p, ymin, ymax, sc, hl, lo, hi);
    const int rb = row_bytes(wl, qb, esize);
    const int per_stage = p.stage_bytes / rb;

    // this query's taps: columns fx - r + i + {0, 1} with weight tx on the
    // second, rows fy - r + j + {0, 1} with weight ty on the second; a tap
    // off the map weighs zero
    const float bx = cx * sc, by = cy * sc;
    const float fxf = floorf(bx), fyf = floorf(by);
    const float tx = bx - fxf, ty = by - fyf;
    const int x0 =
        clamp_floor(fxf, -(p.radius + 2), wl + p.radius) - p.radius + kPer * g;
    const int ybase =
        clamp_floor(fyf, -(p.radius + 2), hl + p.radius) - p.radius;
    int coff[kPer + 1];  // element of column x0 + k, clamped onto the map
    float wa[kPer], wb[kPer];
#pragma unroll
    for (int k = 0; k <= kPer; ++k)
      coff[k] = min(max(x0 + k, 0), wl - 1) * qb + ql;
#pragma unroll
    for (int ii = 0; ii < kPer; ++ii) {
      wa[ii] = (x0 + ii >= 0 && x0 + ii < wl) ? 1.f - tx : 0.f;
      wb[ii] = (x0 + ii + 1 >= 0 && x0 + ii + 1 < wl) ? tx : 0.f;
    }
    float wy0[kMaxK], wy1[kMaxK];
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      wy0[j] = (ybase + j >= 0 && ybase + j < hl) ? 1.f - ty : 0.f;
      wy1[j] = (ybase + j + 1 >= 0 && ybase + j + 1 < hl) ? ty : 0.f;
    }

    float acc[kPer][kMaxK];
#pragma unroll
    for (int ii = 0; ii < kPer; ++ii)
#pragma unroll
      for (int j = 0; j < kMaxK; ++j) acc[ii][j] = 0.f;

    for (int s = lo; s <= hi;) {
      const int e = min(s + per_stage - 1, hi);
      mma_util::mbar_wait(full(stage), phase);
      const T* rows =
          reinterpret_cast<const T*>(gstage0 + stage * p.stage_bytes);
      // y offsets whose row pair (ybase + j, ybase + j + 1) this chunk holds:
      // ybase + j in [s, e - 1], all above in a window's first chunk, all
      // below in its last
      const int jlo = s == lo ? 0 : max(0, s - ybase);
      const int jhi = e == hi ? K - 1 : min(K - 1, e - 1 - ybase);
      if (active && jlo <= jhi) {
        // rows ybase + t, each clamped into the chunk: a row outside it
        // that a kept y offset reads is off the map (weight zero)
        float h[kMaxK + 1][kPer];
#pragma unroll
        for (int t = 0; t <= kMaxK; ++t) {
          const T* src =
              rows + min(max(ybase + t - s, 0), e - s) * (rb / esize);
          float v[kPer + 1];
#pragma unroll
          for (int k = 0; k <= kPer; ++k) v[k] = to_f(src[coff[k]]);
#pragma unroll
          for (int ii = 0; ii < kPer; ++ii)
            h[t][ii] = wa[ii] * v[ii] + wb[ii] * v[ii + 1];
        }
#pragma unroll
        for (int j = 0; j < kMaxK; ++j) {
          const bool own = j >= jlo && j <= jhi;
#pragma unroll
          for (int ii = 0; ii < kPer; ++ii) {
            const float val = wy0[j] * h[j][ii] + wy1[j] * h[j + 1][ii];
            acc[ii][j] = own ? val : acc[ii][j];
          }
        }
      }
      __syncwarp();
      if ((tid & 31) == 0) mma_util::mbar_arrive(empty(stage));
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
      if (e == hi) break;
      s = e;
    }

    if (active) {
      T* o = outs + ql * ncols + l * KK + kPer * g * K;
      if (K == kMaxK) {
        store_run(o, acc);
      } else {
#pragma unroll
        for (int ii = 0; ii < kPer; ++ii) {
          if (kPer * g + ii >= K) break;
#pragma unroll
          for (int j = 0; j < kMaxK; ++j)
            if (j < K) o[ii * K + j] = from_f<T>(acc[ii][j]);
        }
      }
    }
  }

  // every level's outputs are staged: the block's region of out, in one go
  mma_util::fence_proxy_async_shared();
  mma_util::named_barrier(1, kGroups * lanes);
  if (c == 0) {
    T* dst = static_cast<T*>(p.out) +
             (static_cast<long long>(pair) * p.Q + q0) * ncols;
    mma_util::bulk_store(dst, base, nq * ncols * esize);
    mma_util::bulk_wait_read();
  }
}

// Check a launch's arguments; cudaSuccess where the tile body takes them.
inline cudaError_t check(const void* const* levels, const Params& p,
                         int esize) {
  if (p.n_levels <= 0 || p.n_levels > kMaxLevels || p.P <= 0 ||
      p.P > 65535 || p.Q <= 0 || p.radius < 0 || 2 * p.radius + 1 > kMaxK ||
      p.qb < 32 || p.qb > kMaxQB || p.qb % 32 != 0 || p.stage_bytes <= 0 ||
      p.stage_bytes % kAlign != 0)
    return cudaErrorInvalidValue;
  // TMA: 16-byte aligned levels, a row pitch of whole 16 bytes
  if ((static_cast<long long>(p.Q) * esize) % 16 != 0)
    return cudaErrorInvalidValue;
  for (int l = 0; l < p.n_levels; ++l) {
    if (reinterpret_cast<uintptr_t>(levels[l]) % 16 != 0 || p.hl[l] <= 0 ||
        p.wl[l] <= 0 || p.wl[l] > 256 ||
        static_cast<long long>(p.P) * p.hl[l] * p.wl[l] > 0x7fffffffLL ||
        p.stage_bytes < 2 * row_bytes(p.wl[l], p.qb, esize))
      return cudaErrorInvalidValue;
  }
  const int K = 2 * p.radius + 1;
  if (smem_bytes(p.qb, p.n_levels * K * K, esize, p.stage_bytes) >
      kSmemPerBlock)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// Encode the levels' tensor maps and launch. Returns a cudaError_t, or
// mma_util::kEncodeError + the CUresult of a failed encode; the kernel does
// not synchronise. encode_ns (may be null) receives the encodes' host time.
// Static: each library that includes this header (kernels B and E) keeps its
// own record of the share allowed to its own kernel; a static local of an
// inline function would be one object across every library in the process.
template <typename T>
static int launch(const void* const* levels, const Params& p, long long* encode_ns,
           cudaStream_t stream) {
  constexpr int esize = static_cast<int>(sizeof(T));
  const cudaError_t bad = check(levels, p, esize);
  if (bad != cudaSuccess) return static_cast<int>(bad);
  const mma_util::EncodeTiled fn = mma_util::encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  const auto t0 = std::chrono::steady_clock::now();
  CUresult r = CUDA_SUCCESS;
  for (int l = 0; l < p.n_levels && r == CUDA_SUCCESS; ++l) {
    // (positions, queries) of every pair; a box is one scanline of qb
    // queries; zeros past Q
    const cuuint64_t dims[2] = {
        static_cast<cuuint64_t>(p.Q),
        static_cast<cuuint64_t>(p.P) * p.hl[l] * p.wl[l]};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(p.Q) * esize};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(p.qb),
                               static_cast<cuuint32_t>(p.wl[l])};
    const cuuint32_t steps[2] = {1, 1};
    r = fn(&maps.level[l],
           esize == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
           2, const_cast<void*>(levels[l]), dims, strides, box, steps,
           CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
           CU_TENSOR_MAP_L2_PROMOTION_NONE,
           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
  if (encode_ns != nullptr)
    *encode_ns = std::chrono::duration_cast<std::chrono::nanoseconds>(
                     std::chrono::steady_clock::now() - t0)
                     .count();
  if (r != CUDA_SUCCESS) return mma_util::kEncodeError + static_cast<int>(r);

  const int K = 2 * p.radius + 1;
  const int smem = smem_bytes(p.qb, p.n_levels * K * K, esize, p.stage_bytes);
  // the largest dynamic share allowed so far on each device: the attribute
  // is set where a launch needs more, not on every call
  static std::atomic<int> allowed[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  int seen = allowed[dev].load();
  if (smem > seen) {
    err = cudaFuncSetAttribute(
        tile_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    while (smem > seen && !allowed[dev].compare_exchange_weak(seen, smem)) {
    }
  }
  const dim3 grid((p.Q + p.qb - 1) / p.qb, p.P);
  tile_kernel<T><<<grid, kProducer + kGroups * round_up(p.qb, 32), smem,
                   stream>>>(maps, p);
  return static_cast<int>(cudaGetLastError());
}

// The shared entry of both C functions: levels, hl, wl are host arrays of
// n_levels; dtype 0 = float32, 1 = bfloat16.
static int run(const void* const* levels, const int* hl, const int* wl,
               int n_levels, const void* coords, void* out, int P, int Q,
               int radius, int qb, int skip, int stage_bytes,
               int dtype, long long* encode_ns, cudaStream_t stream) {
  if (n_levels <= 0 || n_levels > kMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  for (int l = 0; l < kMaxLevels; ++l) {
    p.hl[l] = l < n_levels ? hl[l] : 0;
    p.wl[l] = l < n_levels ? wl[l] : 0;
  }
  p.n_levels = n_levels;
  p.coords = static_cast<const float*>(coords);
  p.out = out;
  p.P = P;
  p.Q = Q;
  p.radius = radius;
  p.qb = qb;
  p.stage_bytes = stage_bytes;
  p.skip = skip != 0;
  if (dtype == 0) return launch<float>(levels, p, encode_ns, stream);
  if (dtype == 1) return launch<__nv_bfloat16>(levels, p, encode_ns, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace corr_tile
