// Fused frame selection for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel
// videotgb_tpu/ops/select_pallas.py::_select_kernel (driven by
// select_frames_pallas), and on the card it is the whole of
// VideoTGB.select_frames: the select phase, generate_blip2 and the E2E
// recipe's "tgb" selection launch it once a call. Same function: from the
// TGB's span logits (B, L) and the flow lengths (B,) draw top_k (start, end)
// pairs by perturbed argmax (noise_scale times Gumbel noise; none at 0),
// sanitize each pair (beyond the length, or (0, 0), falls back to the whole
// span), rescale it to the F candidate frames ("minus1":
// (c*(F-1)) // max(len-1, 1); "ratio": floor(f32(c) / f32(len) * F)), take
// the union of the frame ranges ([s, e) or [s, e]), fall back to every
// frame when the union is empty, and re-sample the m selected frames to
// nframe slots (double d times until m*2^d >= nframe, slot x takes
// selected[((x*md)//n + ((x+1)*md)//n - 1) // 2 >> d]).
//
// Bound on the H100: it moves 8*B*L + 4*B + (4 or 8)*B*nframe bytes (208
// bytes at the serving path's (4, 4) logits) and does a few operations a
// logit, so it sits at the launch floor. What costs time is the work
// around it, and the interface takes that away:
//   * the logits are read where they lie: the TGB head's (B, L, 2) f32
//     output, handed over as its [..., 0] and [..., 1] views, with a row
//     and an element stride each (no copy);
//   * the lengths are read as int32 or int64 (no cast);
//   * the seed is read from a device int32 (the TPU kernel's SMEM seed),
//     drawn there from the caller's generator, or passed by value;
//   * the indices are written as int32 or int64, whichever the caller
//     returns (no cast);
//   * handed-in noise (top_k, 2, B, L) f32 replaces the Philox draw, so
//     the kernel gives the plain version's bits on the same noise.
// A selection call is then the seed draw and this launch.
//
// Design, one warp per batch row, no shared memory:
//   * the argmax is a strided loop plus a warp-shuffle reduction that
//     orders NaN above every number and keeps the first index on ties, as
//     torch.argmax and jnp.argmax do;
//   * the union mask has ceil(F/32) words spread over the lanes, kPer
//     words a lane in registers (1 up to F = 1024, the long-video width;
//     32 up to kMaxFrames = 32768); a lane sets the bits of its own
//     words;
//   * m is a warp scan of the lanes' __popc counts; slot x finds the lane
//     that holds its rank by binary lifting over that scan (shuffles),
//     then the bit among that lane's words;
//   * the TPU kernel's prefix sum (a triangular matmul) and gather (a
//     masked reduction over (B, nframe, F)), there for what Mosaic lacks,
//     are not needed;
//   * the noise is Philox4x32-10 keyed by the seed, with the counter
//     (position, row_offset + row, 2*draw + start/end), row_offset being
//     the global index of the call's first row: a data-parallel rank that
//     holds rows [o, o + B) of a global batch draws what one process draws
//     for those rows; u = bits * 2^-32 clipped to
//     [1e-7, 1 - 1e-7] as in the TPU kernel, g = -log(-log(u)). It matches
//     the TPU's hardware generator and torch's only in distribution;
//   * IEEE division and rounding throughout (no --use_fast_math; __fdiv_rn,
//     __fmul_rn and __fadd_rn where the reference's f32 operation order
//     matters).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // batch rows per block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxFrames = 32 * 32 * 32;  // 32 lanes x 32 words x 32 bits
constexpr int kMaxSlots = 1024;           // nframe

struct Params {
  const float* start;
  const float* end;
  long long start_row, start_col, end_row, end_col;  // element strides
  const void* length;
  int length_dtype;  // 0 int32, 1 int64
  const float* noise;  // (top_k, 2, B, L) or null: Philox
  const int* seed;     // device int32, or null: seed_value
  uint32_t seed_value;
  void* out;  // int32 or int64: the kernel's template type
  int B, row_offset, L, F, nframe, top_k;
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
__device__ int warp_argmax(const float* row, long long col, const Params& p,
                           uint32_t seed, int b, int draw, int which,
                           int lane) {
  const float* noise =
      p.noise ? p.noise + ((2LL * draw + which) * p.B + b) * p.L : nullptr;
  float bv = 0.f;
  int bi = -1;
  for (int j = lane; j < p.L; j += 32) {
    float v = row[j * col];
    if (p.noise_scale != 0.f) {
      const float g =
          noise ? noise[j] : gumbel(seed, p.row_offset + b, draw, which, j);
      v = __fadd_rn(v, __fmul_rn(p.noise_scale, g));
    }
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

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  const long long q = a / b;  // b > 0
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ long long rescale_index(long long c, long long len,
                                                   const Params& p) {
  if (p.rescale == 0) return floor_div(c * (p.F - 1), max(len - 1, 1LL));
  const float r = __fdiv_rn(static_cast<float>(c), static_cast<float>(len));
  return static_cast<long long>(floorf(__fmul_rn(r, static_cast<float>(p.F))));
}

__device__ __forceinline__ long long read_length(const Params& p, int b) {
  if (p.length_dtype == 0) return static_cast<const int*>(p.length)[b];
  return static_cast<const long long*>(p.length)[b];
}

// set frames [lo, hi) of [0, F) in this lane's kPer words, which hold
// frames [32 * kPer * lane, 32 * kPer * (lane + 1))
template <int kPer>
__device__ __forceinline__ void add_range(unsigned (&own)[kPer],
                                          long long lo, long long hi, int F,
                                          int lane) {
  lo = max(lo, 0LL);
  hi = min(hi, static_cast<long long>(F));
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const long long first = 32LL * (lane * kPer + j);
    const long long a = max(lo, first);
    const long long z = min(hi, first + 32);
    if (a < z) {
      const int n = static_cast<int>(z - a);
      const unsigned bits = n == 32 ? kFull : ((1u << n) - 1u);
      own[j] |= bits << static_cast<int>(a - first);
    }
  }
}

// this lane's count of set bits and the inclusive scan of the counts
template <int kPer>
__device__ __forceinline__ int scan_counts(const unsigned (&own)[kPer],
                                           int lane, int& count) {
  count = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) count += __popc(own[j]);
  int incl = count;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += v;
  }
  return incl;
}

template <typename T, int kPer>
__global__ void __launch_bounds__(kWarps * 32)
select_frames_kernel(const Params p) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= p.B) return;  // the whole warp leaves together
  const uint32_t seed =
      p.seed ? static_cast<uint32_t>(*p.seed) : p.seed_value;
  const float* srow = p.start + b * p.start_row;
  const float* erow = p.end + b * p.end_row;
  const long long len = read_length(p, b);

  unsigned own[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) own[j] = 0u;
  for (int k = 0; k < p.top_k; ++k) {
    long long cs = warp_argmax(srow, p.start_col, p, seed, b, k, 0, lane);
    long long ce = warp_argmax(erow, p.end_col, p, seed, b, k, 1, lane);
    if (cs >= len || ce >= len || (cs == 0 && ce == 0)) {
      cs = 0;
      ce = len - 1;
    }
    const long long s = rescale_index(cs, len, p);
    const long long e = rescale_index(ce, len, p);
    add_range<kPer>(own, s, p.inclusive_end ? e + 1 : e, p.F, lane);
  }
  int count;
  int incl = scan_counts<kPer>(own, lane, count);
  int m = __shfl_sync(kFull, incl, 31);
  if (m == 0) {  // an empty union selects every frame
    add_range<kPer>(own, 0, p.F, p.F, lane);
    incl = scan_counts<kPer>(own, lane, count);
    m = p.F;
  }

  // double every selected frame until there are at least nframe; the TPU
  // kernel runs nframe.bit_length() rounds, which always suffice
  int d = 0;
  long long md = m;
  const int rounds = max(32 - __clz(p.nframe), 1);
  for (int i = 0; i < rounds; ++i) {
    if (md < p.nframe) {
      ++d;
      md *= 2;
    }
  }

  // every lane takes part in the shuffles, so the loop is warp-uniform
  for (int base = 0; base < p.nframe; base += 32) {
    const int x = base + lane;
    long long rank = 0;
    if (x < p.nframe) {
      const long long lo = floor_div(x * md, p.nframe);
      const long long hi = floor_div((x + 1) * md, p.nframe);
      rank = floor_div(lo + hi - 1, 2) >> d;
    }
    // the owner: the first lane whose inclusive count exceeds the rank
    int o = 0;
#pragma unroll
    for (int step = 16; step > 0; step >>= 1) {
      if (__shfl_sync(kFull, incl, o + step - 1) <= rank) o += step;
    }
    long long r = rank - __shfl_sync(kFull, incl - count, o);
    int frame = 0;  // a rank past the last selected frame reads 0
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      unsigned bits = __shfl_sync(kFull, own[j], o);
      const int c = __popc(bits);
      if (r >= 0 && r < c) {
        for (int t = 0; t < r; ++t) bits &= bits - 1u;
        frame = 32 * (o * kPer + j) + __ffs(bits) - 1;
        r = -1;
      } else if (r >= 0) {
        r -= c;
      }
    }
    if (x < p.nframe)
      static_cast<T*>(p.out)[static_cast<long long>(b) * p.nframe + x] =
          static_cast<T>(frame);
  }
}

template <typename T>
void launch(const Params& p, int blocks, cudaStream_t stream) {
  if (p.F <= 32 * 32)
    select_frames_kernel<T, 1><<<blocks, kWarps * 32, 0, stream>>>(p);
  else
    select_frames_kernel<T, 32><<<blocks, kWarps * 32, 0, stream>>>(p);
}

}  // namespace

// start / end: device f32 logits, element (b, j) at ptr[b * row + j * col];
// video_length: device (B,) of length_dtype (0 int32, 1 int64);
// noise: device (top_k, 2, B, L) f32, contiguous, or null for the Philox
// draw; seed: device int32, or null to take seed_value; out: device
// (B, nframe) of out_dtype (0 int32, 1 int64). rescale: 0 = "minus1",
// 1 = "ratio". Returns the launch's cudaError_t; the kernel does not
// synchronise.
extern "C" int select_frames(const void* start, const void* end,
                             long long start_row, long long start_col,
                             long long end_row, long long end_col,
                             const void* video_length, int length_dtype,
                             const void* noise, const void* seed,
                             uint32_t seed_value, void* out, int out_dtype,
                             int B, int row_offset, int L, int num_frames,
                             int nframe,
                             int top_k, float noise_scale, int inclusive_end,
                             int rescale, void* stream) {
  if (B <= 0 || row_offset < 0 || L <= 0 || num_frames <= 0 || num_frames > kMaxFrames ||
      nframe <= 0 || nframe > kMaxSlots || top_k <= 0 ||
      (rescale != 0 && rescale != 1) || (length_dtype != 0 &&
      length_dtype != 1) || (out_dtype != 0 && out_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.start = static_cast<const float*>(start);
  p.end = static_cast<const float*>(end);
  p.start_row = start_row;
  p.start_col = start_col;
  p.end_row = end_row;
  p.end_col = end_col;
  p.length = video_length;
  p.length_dtype = length_dtype;
  p.noise = static_cast<const float*>(noise);
  p.seed = static_cast<const int*>(seed);
  p.seed_value = seed_value;
  p.out = out;
  p.B = B;
  p.row_offset = row_offset;
  p.L = L;
  p.F = num_frames;
  p.nframe = nframe;
  p.top_k = top_k;
  p.noise_scale = noise_scale;
  p.inclusive_end = inclusive_end;
  p.rescale = rescale;
  const int blocks = (B + kWarps - 1) / kWarps;
  const auto s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    launch<int>(p, blocks, s);
  else
    launch<long long>(p, blocks, s);
  return static_cast<int>(cudaGetLastError());
}
