// Fused frame selection for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel
// videotgb_tpu/ops/select_pallas.py::_select_kernel (driven by
// select_frames_pallas). Same function: from the TGB's span logits (B, L)
// f32 and the flow lengths (B,) draw top_k (start, end) pairs by
// perturbed argmax (Gumbel noise times noise_scale; none at 0), sanitize
// each pair (beyond the length, or (0, 0), falls back to the whole span),
// rescale it to the F <= 128 candidate frames ("minus1":
// (c*(F-1)) // max(len-1, 1); "ratio": floor(f32(c) / f32(len) * F)),
// take the union of the frame ranges ([s, e) or [s, e]), fall back to
// every frame when the union is empty, and re-sample the m selected frames
// to nframe slots (double d times until m*2^d >= nframe, slot x takes
// selected[((x*md)//n + ((x+1)*md)//n - 1) // 2 >> d]). Output (B, nframe)
// int32.
//
// The TPU kernel is one VMEM program over the whole batch and works around
// what Mosaic lacks: the prefix sum of the mask is a triangular matmul and
// the gather a masked reduction over (B, nframe, F). Neither is needed
// here:
//   * one warp per batch row; the argmax is a strided loop plus a
//     warp-shuffle reduction that orders NaN above every number and keeps
//     the first index on ties, as torch.argmax and jnp.argmax do;
//   * the union mask is four 32-bit words in registers; m is a sum of
//     __popc, and slot x finds its set bit by walking the words;
//   * the noise is Philox4x32-10 keyed by the seed, with the counter
//     (position, row, 2*draw + start/end); u = bits * 2^-32 clipped to
//     [1e-7, 1 - 1e-7] as in the TPU kernel, g = -log(-log(u)). It matches
//     the TPU's hardware generator and torch's only in distribution.
//   * IEEE division and rounding throughout (no --use_fast_math; __fdiv_rn
//     and __fmul_rn where the reference's f32 operation order matters).
//
// Bound on the H100: the kernel moves 8*B*L + 4*B + 4*B*nframe bytes (208
// bytes at the serving path's (4, 4) logits, 18 kB at the TG recipe's
// (32, 66)), so it sits at the launch floor (a few microseconds); the plain
// PyTorch version is some 40 small kernels.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // batch rows per block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWords = 4;  // 128 frames of mask

struct Params {
  const float* start;
  const float* end;
  const int* length;
  int* out;
  int B, L, F, nframe, top_k;
  uint32_t seed;
  float noise_scale;
  int inclusive_end, rescale;
};

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

__device__ __forceinline__ float gumbel(uint32_t seed, int row, int draw,
                                        int which, int pos) {
  const uint4 r = philox4x32_10(
      make_uint4(static_cast<uint32_t>(pos), static_cast<uint32_t>(row),
                 static_cast<uint32_t>(2 * draw + which), 0u),
      make_uint2(seed, 0u));
  float u = static_cast<float>(r.x) * 2.3283064365386963e-10f;  // 2^-32
  u = fminf(fmaxf(u, 1e-7f), 1.0f - 1e-7f);
  return -logf(-logf(u));
}

// (av, ai) ranks before (bv, bi) in argmax order: NaN above every number,
// then the larger value, then the smaller index; index -1 is "none yet".
__device__ __forceinline__ bool before(float av, int ai, float bv, int bi) {
  if (ai < 0) return false;
  if (bi < 0) return true;
  const bool an = isnan(av), bn = isnan(bv);
  if (an != bn) return an;
  if (!an && av != bv) return av > bv;
  return ai < bi;
}

// argmax over one row of L logits (plus noise), the same in every lane
__device__ int warp_argmax(const float* row, const Params& p, int b,
                           int draw, int which, int lane) {
  float bv = 0.f;
  int bi = -1;
  for (int j = lane; j < p.L; j += 32) {
    float v = row[j];
    if (p.noise_scale != 0.f)
      v = __fadd_rn(v, __fmul_rn(p.noise_scale,
                                 gumbel(p.seed, b, draw, which, j)));
    if (before(v, j, bv, bi)) {
      bv = v;
      bi = j;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, bv, off);
    const int oi = __shfl_xor_sync(kFull, bi, off);
    if (before(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  return bi;
}

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int rescale_index(int c, int len, int denom,
                                             const Params& p) {
  if (p.rescale == 0) return floor_div(c * (p.F - 1), denom);
  const float r = __fdiv_rn(static_cast<float>(c), static_cast<float>(len));
  return static_cast<int>(floorf(__fmul_rn(r, static_cast<float>(p.F))));
}

// set frames [lo, hi) of [0, F) in the mask
__device__ __forceinline__ void add_range(unsigned (&mask)[kWords], int lo,
                                          int hi, int F) {
  lo = max(lo, 0);
  hi = min(hi, F);
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    const int a = max(lo, 32 * w);
    const int z = min(hi, 32 * w + 32);
    if (a < z) {
      const int n = z - a;
      const unsigned bits = n == 32 ? kFull : ((1u << n) - 1u);
      mask[w] |= bits << (a - 32 * w);
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
select_frames_kernel(const Params p) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= p.B) return;  // the whole warp leaves together
  const float* srow = p.start + static_cast<long long>(b) * p.L;
  const float* erow = p.end + static_cast<long long>(b) * p.L;
  const int len = p.length[b];
  const int denom = max(len - 1, 1);

  unsigned mask[kWords] = {0u, 0u, 0u, 0u};
  for (int k = 0; k < p.top_k; ++k) {
    int cs = warp_argmax(srow, p, b, k, 0, lane);
    int ce = warp_argmax(erow, p, b, k, 1, lane);
    if (cs >= len || ce >= len || (cs == 0 && ce == 0)) {
      cs = 0;
      ce = len - 1;
    }
    const int s = rescale_index(cs, len, denom, p);
    const int e = rescale_index(ce, len, denom, p);
    add_range(mask, s, p.inclusive_end ? e + 1 : e, p.F);
  }
  int m = 0;
#pragma unroll
  for (int w = 0; w < kWords; ++w) m += __popc(mask[w]);
  if (m == 0) {
    add_range(mask, 0, p.F, p.F);
    m = p.F;
  }

  // double every selected frame until there are at least nframe; the TPU
  // kernel runs nframe.bit_length() rounds, which always suffice
  int d = 0, md = m;
  const int rounds = max(32 - __clz(p.nframe), 1);
  for (int i = 0; i < rounds; ++i) {
    if (md < p.nframe) {
      ++d;
      md *= 2;
    }
  }

  for (int x = lane; x < p.nframe; x += 32) {
    const int lo = floor_div(x * md, p.nframe);
    const int hi = floor_div((x + 1) * md, p.nframe);
    int rank = floor_div(lo + hi - 1, 2) >> d;
    int frame = 0;  // a rank past the last selected frame reads 0
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      const int c = __popc(mask[w]);
      if (rank >= 0 && rank < c) {
        unsigned bits = mask[w];
        for (int t = 0; t < rank; ++t) bits &= bits - 1u;
        frame = 32 * w + __ffs(bits) - 1;
        rank = -1;
      } else if (rank >= 0) {
        rank -= c;
      }
    }
    p.out[static_cast<long long>(b) * p.nframe + x] = frame;
  }
}

}  // namespace

// start / end: device (B, L) f32; video_length: device (B,) int32; out:
// device (B, nframe) int32. rescale: 0 = "minus1", 1 = "ratio". Returns the
// launch's cudaError_t; the kernel does not synchronise.
extern "C" int select_frames(const void* start, const void* end,
                             const void* video_length, void* out, int B,
                             int L, int num_frames, int nframe, int top_k,
                             uint32_t seed, float noise_scale,
                             int inclusive_end, int rescale, void* stream) {
  if (B <= 0 || L <= 0 || num_frames <= 0 || num_frames > 32 * kWords ||
      nframe <= 0 || nframe > 1024 || top_k <= 0 ||
      (rescale != 0 && rescale != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.start = static_cast<const float*>(start);
  p.end = static_cast<const float*>(end);
  p.length = static_cast<const int*>(video_length);
  p.out = static_cast<int*>(out);
  p.B = B;
  p.L = L;
  p.F = num_frames;
  p.nframe = nframe;
  p.top_k = top_k;
  p.seed = seed;
  p.noise_scale = noise_scale;
  p.inclusive_end = inclusive_end;
  p.rescale = rescale;
  const int blocks = (B + kWarps - 1) / kWarps;
  select_frames_kernel<<<blocks, kWarps * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
