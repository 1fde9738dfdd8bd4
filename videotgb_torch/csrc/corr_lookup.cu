// RAFT correlation-pyramid lookup for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel
// videotgb_tpu/ops/correlation_pallas.py::_lookup_kernel (driven by
// _lookup_pallas). Same function: for pair p, query q at (cx, cy), level l
// and window offsets i (x) and j (y) in [-r, r], sample the level-l map at
// (cx / 2^l + i, cy / 2^l + j) bilinearly with zero padding and write it to
// channel l*(2r+1)^2 + (i+r)*(2r+1) + (j+r). Levels are query-minor,
// (P, Hl*Wl, Q); the output is (P, Q, L*(2r+1)^2) in the pyramid's dtype;
// sums are f32.
//
// Bound on the H100: memory. At the main-path shape (16 pairs, 28x28
// queries, 4 levels, r = 4) the pyramid is ~26 MB in bf16 and the output
// ~8 MB, ~10 us at 3.35 TB/s; the arithmetic is negligible. The TPU kernel
// evaluated the hat weights max(0, 1-|d|) densely over every row and column
// of each level (no gathers on the TPU's vector unit), ~14x redundant work;
// on the GPU gathers are cheap, so this kernel uses the 2-tap bilinear form:
// four reads and three lerps per output. One thread per (pair, query,
// level, x offset) writes the 2r+1 consecutive y-offset channels, so a warp
// stores a contiguous run of the output. The reads are gathers (a query's
// taps are Q elements apart in the query-minor layout); a level-0 map of a
// pair is 1.2 MB in bf16, so the pyramid of a batch stays in the 50 MB L2.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 8;

struct Params {
  const void* level[kMaxLevels];
  int hl[kMaxLevels];
  int wl[kMaxLevels];
  int n_levels;
  const float* coords;  // (P, Q, 2) as (x, y)
  void* out;            // (P, Q, n_levels * K * K)
  int P, Q, radius;
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

template <typename T>
__global__ void corr_lookup_kernel(const Params p) {
  const int K = 2 * p.radius + 1;
  const long long total =
      static_cast<long long>(p.P) * p.Q * p.n_levels * K;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int i = static_cast<int>(idx % K);
  long long rest = idx / K;
  const int lvl = static_cast<int>(rest % p.n_levels);
  rest /= p.n_levels;
  const int q = static_cast<int>(rest % p.Q);
  const int pair = static_cast<int>(rest / p.Q);

  const int hl = p.hl[lvl];
  const int wl = p.wl[lvl];
  const T* map = static_cast<const T*>(p.level[lvl]) +
                 static_cast<long long>(pair) * hl * wl * p.Q + q;
  const float cx = p.coords[(static_cast<long long>(pair) * p.Q + q) * 2];
  const float cy = p.coords[(static_cast<long long>(pair) * p.Q + q) * 2 + 1];
  const float sc = 1.0f / static_cast<float>(1 << lvl);

  // tap at integral (xc, yc); outside the map -> 0 (grid_sample zeros)
  auto tap = [&](float xc, float yc) -> float {
    if (xc >= 0.f && xc <= static_cast<float>(wl - 1) && yc >= 0.f &&
        yc <= static_cast<float>(hl - 1)) {
      const int xi = static_cast<int>(xc);
      const int yi = static_cast<int>(yc);
      return to_f(map[static_cast<long long>(yi * wl + xi) * p.Q]);
    }
    return 0.f;
  };

  const float x = cx * sc + static_cast<float>(i - p.radius);
  const float x0 = floorf(x);
  const float tx = x - x0;
  T* out = static_cast<T*>(p.out) +
           (static_cast<long long>(pair) * p.Q + q) * (p.n_levels * K * K) +
           lvl * K * K + i * K;
  for (int j = 0; j < K; ++j) {
    const float y = cy * sc + static_cast<float>(j - p.radius);
    const float y0 = floorf(y);
    const float ty = y - y0;
    const float v00 = tap(x0, y0);
    const float v01 = tap(x0 + 1.f, y0);
    const float v10 = tap(x0, y0 + 1.f);
    const float v11 = tap(x0 + 1.f, y0 + 1.f);
    const float val = v00 * (1.f - tx) * (1.f - ty) + v01 * tx * (1.f - ty) +
                      v10 * (1.f - tx) * ty + v11 * tx * ty;
    out[j] = from_f<T>(val);
  }
}

}  // namespace

// levels: host array of n_levels device pointers, each (P, hl*wl, Q);
// hl / wl: host arrays of the level sizes; coords: device (P, Q, 2) f32;
// out: device (P, Q, n_levels*(2r+1)^2). dtype: 0 = float32, 1 = bfloat16.
// Returns the launch's cudaError_t; the kernel does not synchronise.
extern "C" int corr_lookup(const void* const* levels, const int* hl,
                           const int* wl, int n_levels, const void* coords,
                           void* out, int P, int Q, int radius, int dtype,
                           void* stream) {
  if (n_levels <= 0 || n_levels > kMaxLevels || P <= 0 || Q <= 0 ||
      radius < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  for (int l = 0; l < n_levels; ++l) {
    p.level[l] = levels[l];
    p.hl[l] = hl[l];
    p.wl[l] = wl[l];
  }
  for (int l = n_levels; l < kMaxLevels; ++l) {
    p.level[l] = nullptr;
    p.hl[l] = 0;
    p.wl[l] = 0;
  }
  p.n_levels = n_levels;
  p.coords = static_cast<const float*>(coords);
  p.out = out;
  p.P = P;
  p.Q = Q;
  p.radius = radius;
  const int K = 2 * radius + 1;
  const long long total = static_cast<long long>(P) * Q * n_levels * K;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    corr_lookup_kernel<float><<<static_cast<unsigned>(blocks), threads, 0, s>>>(p);
  } else if (dtype == 1) {
    corr_lookup_kernel<__nv_bfloat16>
        <<<static_cast<unsigned>(blocks), threads, 0, s>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
