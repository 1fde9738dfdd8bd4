// RAFT correlation-pyramid lookup for Hopper (sm_90a), plain C interface:
// kernel B.
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
// Two bodies, picked by ops/correlation_pallas.py::lookup_body and passed
// in as `body`:
//   * 1, the tile body (corr_lookup_tile.cuh, shared with kernel E): a block
//     per run of qb queries stages the scanlines its queries reach by TMA
//     and writes its outputs by one bulk store. It takes f32 and bf16 with
//     Q a multiple of 16 bytes of queries, 16-byte aligned levels and
//     r <= 4: the RAFT path's pyramids.
//   * 0, the gather body below, for everything else: one thread per (pair,
//     query, level, x offset) writes the 2r+1 consecutive y-offset channels
//     from four gathered taps per output (a query's taps lie Q elements
//     apart in the query-minor layout, so each two-byte load fills a sector
//     of its own).
//
// Bound on the H100: memory. The TPU kernel evaluated the hat weights
// max(0, 1-|d|) densely over every row and column of each level (no gathers
// on the TPU's vector unit), ~14x redundant work; both bodies here use the
// 2-tap bilinear form, four taps and three lerps per output.
#include "corr_lookup_tile.cuh"

namespace {

using corr_tile::from_f;
using corr_tile::kMaxLevels;
using corr_tile::to_f;

struct Params {
  const void* level[kMaxLevels];
  int hl[kMaxLevels];
  int wl[kMaxLevels];
  int n_levels;
  const float* coords;  // (P, Q, 2) as (x, y)
  void* out;            // (P, Q, n_levels * K * K)
  int P, Q, radius;
};

template <typename T>
__global__ void corr_gather_kernel(const Params p) {
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
// out: device (P, Q, n_levels*(2r+1)^2). body: 0 = gather, 1 = tile; qb
// and stage_bytes are the tile body's (queries per block, bytes of each of
// its two ring stages; ops/correlation_pallas.py::lookup_tile), unread by
// the gather body. dtype: 0 = float32, 1 = bfloat16. encode_ns (may be
// null): where the tile body's TMA descriptor encodes write their host
// time. Returns the launch's cudaError_t, or 10000 + the CUresult of a
// failed encode; the kernel does not synchronise.
extern "C" int corr_lookup(const void* const* levels, const int* hl,
                           const int* wl, int n_levels, const void* coords,
                           void* out, int P, int Q, int radius, int body,
                           int qb, int stage_bytes, int dtype,
                           long long* encode_ns, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == 1)
    return corr_tile::run(levels, hl, wl, n_levels, coords, out, P, Q, radius,
                          qb, /*skip=*/1, stage_bytes, dtype,
                          encode_ns, s);
  if (body != 0 || n_levels <= 0 || n_levels > kMaxLevels || P <= 0 ||
      Q <= 0 || radius < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (encode_ns != nullptr) *encode_ns = 0;
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
  if (dtype == 0) {
    corr_gather_kernel<float>
        <<<static_cast<unsigned>(blocks), threads, 0, s>>>(p);
  } else if (dtype == 1) {
    corr_gather_kernel<__nv_bfloat16>
        <<<static_cast<unsigned>(blocks), threads, 0, s>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
