// Flash-attention forward on (B, S, H, D) tensors for Hopper (sm_90a),
// plain C interface.
//
// Replaces the Pallas TPU kernel tools/attnlayoutprobe.py::_kern (driven by
// flash_bshd). Same function: out = softmax(q k^T * scale) v per (frame,
// head), no bias, keys over the whole sequence; products of bf16 (or f32)
// operands accumulated in f32, the online softmax in f32, P rounded to v's
// dtype before the PV product, out = acc / max(l, 1e-30) in q's dtype. q, k,
// v and out are (B, S, H, D), addressed by (batch, seq, head) strides with
// the last dim contiguous: there is no transpose before or after.
//
// The TPU kernel's point was to read (B, S, H, D) blocks without the XLA
// transposes around a (B, H, S, D) kernel. On the card kernel A
// (flash_fwd.cu) already reads through strides; this kernel keeps G's own
// blocking:
//   * one block per (frame, group of HB heads, 32 queries); HB = 8 in bf16
//     (4 in f32, or for D > 96, to stay inside 227 KB of shared memory);
//     two warps per head, 16 query rows each;
//   * each key row of a group is HB*D contiguous values (8 x 88 bf16 =
//     1408 bytes), so the q, k and v tiles load coalesced across the heads;
//   * q, k and v tiles stay in shared memory in their own dtype, D
//     zero-padded to a multiple of 32 (88 -> 96), rows of k and q padded by
//     4 more values so that lanes reading different keys hit distinct banks;
//   * a loop over 32-key tiles: lane j scores key j for the warp's 16 rows,
//     the online-softmax max is a warp reduction, P goes through shared
//     memory, and in PV lane d owns output dims d, d+32, ...; the ragged
//     sequence tail is masked in the kernel;
//   * CUDA-core FMAs (no mma/wgmma yet), as kernel A.
//
// Bound on the H100: at the probe's shape (128 frames x 264 x 16 x 88,
// bf16) q, k, v and out are 4 x 95 MB (~0.11 ms at 3.35 TB/s) against ~50
// GFLOP of products (~0.05 ms at 989 TFLOP/s): memory. On CUDA cores the
// FMA issue rate is this version's own limit.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kBlockQ = 32;
constexpr int kBlockK = 32;               // keys per tile: one per lane
constexpr int kRows = 16;                 // query rows per warp
constexpr int kWarpsPerHead = kBlockQ / kRows;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int S, H, D;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
      o_sb, o_ss, o_sh;
  float scale;
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

// four consecutive values from shared memory as f32 (8-byte loads in bf16,
// 16-byte loads in f32)
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  const float2 fa = __bfloat1622float2(a);
  const float2 fb = __bfloat1622float2(b);
  return make_float4(fa.x, fa.y, fb.x, fb.y);
}
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <typename T, int NC>
struct Tile {
  static constexpr int HB = (sizeof(T) == 2 && NC <= 3) ? 8 : 4;
  static constexpr int DP = NC * 32;  // padded head dim
  static constexpr int RS = DP + 4;   // row stride of the q and k tiles
  static constexpr int kWarps = HB * kWarpsPerHead;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kBytes =
      (HB * kBlockQ * RS + HB * kBlockK * RS + HB * kBlockK * DP) *
          static_cast<int>(sizeof(T)) +
      kWarps * kRows * kBlockK * 4;
};

// copy rows [r0, r0 + 32) of heads [h0, h0 + HB) of one frame into a
// [HB][32][stride] tile; the head-dim pad, rows past S and heads past H are
// zero. Consecutive threads take consecutive (head, dim) of one row, which
// are contiguous in memory when the head stride is D; each thread keeps
// kBatch loads in flight.
template <typename T, int NC>
__device__ __forceinline__ void load_tile(T* dst, int stride, const T* src,
                                          long long s_s, long long s_h,
                                          int r0, int h0, const Params& p) {
  using TL = Tile<T, NC>;
  constexpr int kPer = 32 * TL::HB * TL::DP / TL::kThreads;  // DP / 2
  constexpr int kBatch = 8;
  static_assert(kPer % kBatch == 0, "whole batches per thread");
  for (int k0 = 0; k0 < kPer; k0 += kBatch) {
    T x[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = threadIdx.x + (k0 + u) * TL::kThreads;
      const int d = i % TL::DP;
      const int row = r0 + i / (TL::DP * TL::HB);
      const int h = h0 + (i / TL::DP) % TL::HB;
      x[u] = (d < p.D && row < p.S && h < p.H) ? src[row * s_s + h * s_h + d]
                                                : from_f<T>(0.f);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = threadIdx.x + (k0 + u) * TL::kThreads;
      const int d = i % TL::DP;
      const int r = i / (TL::DP * TL::HB);
      const int hh = (i / TL::DP) % TL::HB;
      dst[(hh * 32 + r) * stride + d] = x[u];
    }
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(Tile<T, NC>::kThreads)
flash_bshd_kernel(const Params p) {
  using TL = Tile<T, NC>;
  constexpr int DP = TL::DP;
  constexpr int RS = TL::RS;
  extern __shared__ float4 smem4[];
  T* Qs = reinterpret_cast<T*>(smem4);          // [HB][32][RS]
  T* Ks = Qs + TL::HB * kBlockQ * RS;           // [HB][32][RS]
  T* Vs = Ks + TL::HB * kBlockK * RS;           // [HB][32][DP]
  float* Ps = reinterpret_cast<float*>(Vs + TL::HB * kBlockK * DP);

  const int q0 = blockIdx.x * kBlockQ;
  const int h0 = blockIdx.y * TL::HB;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int hh = warp / kWarpsPerHead;                 // head in the group
  const int r0 = (warp % kWarpsPerHead) * kRows;       // first row in tile
  float* Pw = Ps + warp * kRows * kBlockK;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb;
  T* og = static_cast<T*>(p.o) + b * p.o_sb;

  load_tile<T, NC>(Qs, RS, qg, p.q_ss, p.q_sh, q0, h0, p);
  const T* Qw = Qs + (hh * kBlockQ + r0) * RS;

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  const int n_tiles = (p.S + kBlockK - 1) / kBlockK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the previous tile is consumed (and Q is staged)
    load_tile<T, NC>(Ks, RS, kg, p.k_ss, p.k_sh, k0, h0, p);
    load_tile<T, NC>(Vs, DP, vg, p.v_ss, p.v_sh, k0, h0, p);
    __syncthreads();

    // scores of this lane's key for the warp's rows
    const int kj = k0 + lane;
    const bool kvalid = kj < p.S;
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const T* krow = Ks + (hh * kBlockK + lane) * RS;
#pragma unroll 4
    for (int d4 = 0; d4 < DP / 4; ++d4) {
      const float4 kv = load4(krow + 4 * d4);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = load4(Qw + r * RS + 4 * d4);
        s[r] = fmaf(qv.x, kv.x, s[r]);
        s[r] = fmaf(qv.y, kv.y, s[r]);
        s[r] = fmaf(qv.z, kv.z, s[r]);
        s[r] = fmaf(qv.w, kv.w, s[r]);
      }
    }

    // online softmax; keys past S get p = 0 exactly
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float sr = kvalid ? s[r] * p.scale : -INFINITY;
      float mt = sr;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, off));
      // every tile holds at least one key in range, so mt is finite
      const float mn = fmaxf(m[r], mt);
      const float alpha = expf(m[r] - mn);  // 0 on the first tile
      const float pr = kvalid ? expf(sr - mn) : 0.f;
      m[r] = mn;
      l[r] = l[r] * alpha + pr;
      Pw[r * kBlockK + lane] = to_f(from_f<T>(pr));  // P in v's dtype
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
    }
    __syncwarp();

    const T* Vh = Vs + hh * kBlockK * DP;
#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = to_f(Vh[j * DP + c * 32 + lane]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = Pw[r * kBlockK + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(pj, vv[c], acc[r][c]);
      }
    }
  }

  const int h = h0 + hh;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float lt = l[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      lt += __shfl_xor_sync(kFull, lt, off);
    const int qi = q0 + r0 + r;
    if (qi >= p.S || h >= p.H) continue;
    const float inv = 1.f / fmaxf(lt, 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = c * 32 + lane;
      if (d < p.D)
        og[qi * p.o_ss + h * p.o_sh + d] = from_f<T>(acc[r][c] * inv);
    }
  }
}

template <typename T, int NC>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  using TL = Tile<T, NC>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bshd_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      TL::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + kBlockQ - 1) / kBlockQ, (p.H + TL::HB - 1) / TL::HB,
                  B);
  flash_bshd_kernel<T, NC><<<grid, TL::kThreads, TL::kBytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int B, cudaStream_t stream) {
  switch ((p.D + 31) / 32) {
    case 1: return launch<T, 1>(p, B, stream);
    case 2: return launch<T, 2>(p, B, stream);
    case 3: return launch<T, 3>(p, B, stream);
    case 4: return launch<T, 4>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: device (B, S, H, D) with (batch, seq, head) strides in
// elements and the last dim contiguous. dtype: 0 = float32, 1 = bfloat16.
// Returns the launch's cudaError_t; the kernel does not synchronise.
extern "C" int flash_bshd(const void* q, const void* k, const void* v,
                          void* out, int B, int S, int H, int D,
                          long long q_sb, long long q_ss, long long q_sh,
                          long long k_sb, long long k_ss, long long k_sh,
                          long long v_sb, long long v_ss, long long v_sh,
                          long long o_sb, long long o_ss, long long o_sh,
                          float scale, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || H <= 0 || D <= 0 || D > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = out;
  p.S = S;
  p.H = H;
  p.D = D;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch<float>(p, B, s);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(p, B, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
