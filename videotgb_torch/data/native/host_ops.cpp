// Native host-side video preprocessing for videotgb_torch (the port's copy
// of the JAX package's videotgb_tpu/data/native/host_ops.cpp; same code).
//
// The reference's data path is pure-python/numpy (SURVEY.md section 2.6 —
// its only native hook, alt_cuda_corr, is dead code); the pipeline is
// host-decode-bound (BASELINE.md: 19.3 s/video in the reference), so the
// per-frame CPU work between decode and device transfer is implemented here:
//
//   vtgb_resize_normalize : uint8 HWC frames -> bilinear resize -> float32
//                           CLIP-normalized, multithreaded over frames
//   vtgb_normalize_flow   : per-clip max-radius flow normalization
//   vtgb_flow_to_rgb      : Middlebury colorwheel visualization
//
// Exposed with a plain C ABI for ctypes (no pybind11 in this image).
// Build: g++ -O3 -march=native -shared -fPIC -std=c++17 -pthread
//            host_ops.cpp -o libvtgb_host.so

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

int hardware_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n ? static_cast<int>(n) : 4;
}

// parallel-for over [0, n) with a shared atomic counter (cheap work stealing)
template <typename F>
void parallel_for(int n, int num_threads, F&& fn) {
  if (n <= 1 || num_threads <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int> next{0};
  auto worker = [&] {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      fn(i);
    }
  };
  std::vector<std::thread> pool;
  int k = std::min(num_threads, n);
  pool.reserve(k);
  for (int t = 0; t < k; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// frames: (T, H, W, 3) uint8 -> out: (T, OH, OW, 3) float32 normalized.
// Bilinear resize with half-pixel centers (cv2.INTER_LINEAR semantics).
void vtgb_resize_normalize(const uint8_t* frames, int t, int h, int w,
                           float* out, int oh, int ow,
                           const float* mean, const float* std_,
                           int num_threads) {
  if (num_threads <= 0) num_threads = hardware_threads();
  const float sy = static_cast<float>(h) / oh;
  const float sx = static_cast<float>(w) / ow;
  const float inv255 = 1.0f / 255.0f;
  float inv_std[3] = {1.0f / std_[0], 1.0f / std_[1], 1.0f / std_[2]};

  parallel_for(t, num_threads, [&](int ti) {
    const uint8_t* src = frames + static_cast<int64_t>(ti) * h * w * 3;
    float* dst = out + static_cast<int64_t>(ti) * oh * ow * 3;
    for (int y = 0; y < oh; ++y) {
      float fy = (y + 0.5f) * sy - 0.5f;
      int y0 = static_cast<int>(std::floor(fy));
      float ty = fy - y0;
      int y0c = std::clamp(y0, 0, h - 1);
      int y1c = std::clamp(y0 + 1, 0, h - 1);
      const uint8_t* row0 = src + static_cast<int64_t>(y0c) * w * 3;
      const uint8_t* row1 = src + static_cast<int64_t>(y1c) * w * 3;
      float* orow = dst + static_cast<int64_t>(y) * ow * 3;
      for (int x = 0; x < ow; ++x) {
        float fx = (x + 0.5f) * sx - 0.5f;
        int x0 = static_cast<int>(std::floor(fx));
        float tx = fx - x0;
        int x0c = std::clamp(x0, 0, w - 1);
        int x1c = std::clamp(x0 + 1, 0, w - 1);
        for (int c = 0; c < 3; ++c) {
          float v00 = row0[x0c * 3 + c], v01 = row0[x1c * 3 + c];
          float v10 = row1[x0c * 3 + c], v11 = row1[x1c * 3 + c];
          float top = v00 + (v01 - v00) * tx;
          float bot = v10 + (v11 - v10) * tx;
          float val = (top + (bot - top) * ty) * inv255;
          orow[x * 3 + c] = (val - mean[c]) * inv_std[c];
        }
      }
    }
  });
}

// flow: (T, H, W, 2) float32, normalized in place by the clip's max radius
// (reference: videoinstruct_dataset.py:211-226)
void vtgb_normalize_flow(float* flow, int t, int h, int w, int num_threads) {
  if (num_threads <= 0) num_threads = hardware_threads();
  const int64_t n = static_cast<int64_t>(t) * h * w;
  std::vector<float> maxima(std::min(num_threads, std::max(t, 1)), 0.0f);
  int k = static_cast<int>(maxima.size());
  parallel_for(k, k, [&](int part) {
    int64_t lo = n * part / k, hi = n * (part + 1) / k;
    float m = 0.0f;
    for (int64_t i = lo; i < hi; ++i) {
      float u = flow[2 * i], v = flow[2 * i + 1];
      m = std::max(m, u * u + v * v);
    }
    maxima[part] = m;
  });
  float rad_max = 0.0f;
  for (float m : maxima) rad_max = std::max(rad_max, m);
  rad_max = std::sqrt(rad_max);
  const float scale = 1.0f / (rad_max + 1e-5f);
  parallel_for(k, k, [&](int part) {
    int64_t lo = 2 * (n * part / k), hi = 2 * (n * (part + 1) / k);
    for (int64_t i = lo; i < hi; ++i) flow[i] *= scale;
  });
}

// Middlebury colorwheel: 55 x 3 ramp (matches data/flow_viz.py)
static void make_wheel(float wheel[55][3]) {
  const int RY = 15, YG = 6, GC = 4, CB = 11, BM = 13, MR = 6;
  int col = 0;
  for (int i = 0; i < RY; ++i) { wheel[col + i][0] = 255; wheel[col + i][1] = std::floor(255.0f * i / RY); wheel[col + i][2] = 0; }
  col += RY;
  for (int i = 0; i < YG; ++i) { wheel[col + i][0] = 255 - std::floor(255.0f * i / YG); wheel[col + i][1] = 255; wheel[col + i][2] = 0; }
  col += YG;
  for (int i = 0; i < GC; ++i) { wheel[col + i][0] = 0; wheel[col + i][1] = 255; wheel[col + i][2] = std::floor(255.0f * i / GC); }
  col += GC;
  for (int i = 0; i < CB; ++i) { wheel[col + i][0] = 0; wheel[col + i][1] = 255 - std::floor(255.0f * i / CB); wheel[col + i][2] = 255; }
  col += CB;
  for (int i = 0; i < BM; ++i) { wheel[col + i][0] = std::floor(255.0f * i / BM); wheel[col + i][1] = 0; wheel[col + i][2] = 255; }
  col += BM;
  for (int i = 0; i < MR; ++i) { wheel[col + i][0] = 255; wheel[col + i][1] = 0; wheel[col + i][2] = 255 - std::floor(255.0f * i / MR); }
}

// flow (T, H, W, 2) float32 -> rgb (T, H, W, 3) uint8, normalized by the
// clip max radius (reference flow_to_image chain, util.py:185-297)
void vtgb_flow_to_rgb(const float* flow, int t, int h, int w, uint8_t* rgb,
                      int num_threads) {
  if (num_threads <= 0) num_threads = hardware_threads();
  static float wheel[55][3];
  static std::atomic<bool> wheel_ready{false};
  if (!wheel_ready.exchange(true)) make_wheel(wheel);

  const int64_t n = static_cast<int64_t>(t) * h * w;
  float rad_max = 0.0f;
  for (int64_t i = 0; i < n; ++i) {
    float u = flow[2 * i], v = flow[2 * i + 1];
    rad_max = std::max(rad_max, u * u + v * v);
  }
  rad_max = std::sqrt(rad_max);
  const float scale = 1.0f / (rad_max + 1e-5f);
  const int ncols = 55;

  parallel_for(t, num_threads, [&](int ti) {
    const float* f = flow + static_cast<int64_t>(ti) * h * w * 2;
    uint8_t* o = rgb + static_cast<int64_t>(ti) * h * w * 3;
    for (int64_t i = 0; i < static_cast<int64_t>(h) * w; ++i) {
      float u = f[2 * i] * scale, v = f[2 * i + 1] * scale;
      float rad = std::sqrt(u * u + v * v);
      float a = std::atan2(-v, -u) / static_cast<float>(M_PI);
      float fk = (a + 1.0f) / 2.0f * (ncols - 1);
      int k0 = static_cast<int>(std::floor(fk));
      int k1 = (k0 + 1) % ncols;
      float frac = fk - k0;
      for (int c = 0; c < 3; ++c) {
        float col0 = wheel[k0][c] / 255.0f;
        float col1 = wheel[k1][c] / 255.0f;
        float col = (1 - frac) * col0 + frac * col1;
        col = rad <= 1.0f ? 1.0f - rad * (1.0f - col) : col * 0.75f;
        o[3 * i + c] = static_cast<uint8_t>(std::floor(255.0f * col));
      }
    }
  });
}

}  // extern "C"
