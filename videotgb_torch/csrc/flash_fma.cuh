// The flash-attention forward's launch description (Params) and its
// CUDA-core body, shared by kernels A (flash_fwd.cu) and G (flash_bshd.cu).
//
// out = softmax(q k^T * scale + bias) v per (batch, head): products of bf16
// (or f32) operands accumulated in f32, the bias added in f32 after scaling,
// running max / sum / acc in f32, P rounded to v's dtype before the PV
// product, out = acc / max(l, 1e-30) in q's dtype. A row whose keys all carry
// NEG_INF (-1e30) bias gives the uniform average that the plain softmax
// gives, never NaN.
//
// This body takes what the tensor-core body (flash_mma.cuh) does not: f32
// inputs (a tensor-core f32 product would be TF32, which the port rules out)
// and bf16 inputs whose rows are not 16-byte aligned. It computes on the
// CUDA cores with plain FMAs:
//   * one block per (batch*head, 32-row q tile), 8 warps x 4 rows;
//   * a loop over 32-key K/V tiles staged in shared memory as f32, the head
//     dim zero-padded to a multiple of 32 (D = 88 -> 96, 64 -> 64);
//   * lane j of a warp scores key j of the tile for the warp's 4 rows; the
//     online-softmax max is a warp reduction, the per-lane sums are reduced
//     once at the end; P goes through shared memory, and in PV lane d owns
//     output dims d, d+32, ...;
//   * the ragged sequence tail is masked in the kernel (no padding in HBM).
// Its own limit is the FMA and shared-memory issue rate.
//
// Both bodies address q/k/v/out through (batch, head, seq) strides, so
// (B, S, H, D) projections are read without a transpose copy, and the bias
// through 4 strides, 0 on broadcast dims, so shared (1,1,S,S), per-batch
// (B,1,S,S), per-row (B,H,S,S) and (1,H,S,S) / (B,1,1,S) biases are read
// without materialising the head broadcast.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace flash {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;  // null: no bias (its strides are then ignored)
  void* o;
  int H, Sq, Skv, D;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
      o_sb, o_sh, o_ss;
  long long b_sb, b_sh, b_sq, b_sk;
  float scale;
};

namespace fma_body {

constexpr int kWarps = 8;
constexpr int kRows = 4;                    // query rows per warp
constexpr int kBlockQ = kWarps * kRows;     // 32 query rows per block
constexpr int kBlockK = 32;                 // keys per tile: one per lane
constexpr unsigned kFull = 0xffffffffu;

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

template <int NC>
constexpr int smem_floats() {
  // Q tile [32][DP], K tile [32][DP+4], V tile [32][DP], P [32][32]
  return kBlockQ * (NC * 32) + kBlockK * (NC * 32 + 4) + kBlockK * (NC * 32) +
         kBlockQ * kBlockK;
}

template <typename T, int NC>
__global__ void __launch_bounds__(kWarps * 32)
flash_fma_kernel(const Params p) {
  constexpr int DP = NC * 32;   // padded head dim
  constexpr int KS = DP + 4;    // K row stride: lane-strided float4 reads
                                // stay free of bank conflicts
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBlockQ * DP;
  float* Vs = Ks + kBlockK * KS;
  float* Ps = Vs + kBlockK * DP;

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const float* bg = p.bias ? p.bias + b * p.b_sb + h * p.b_sh : nullptr;

  for (int i = tid; i < kBlockQ * DP; i += kWarps * 32) {
    const int r = i / DP;
    const int d = i - r * DP;
    const int qi = q0 + r;
    float x = 0.f;
    if (qi < p.Sq && d < p.D) x = to_f(qg[qi * p.q_ss + d]);
    Qs[i] = x;
  }

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  const int n_tiles = (p.Skv + kBlockK - 1) / kBlockK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the previous tile is consumed (and Q is staged)
    for (int i = tid; i < kBlockK * DP; i += kWarps * 32) {
      const int j = i / DP;
      const int d = i - j * DP;
      const int kj = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (kj < p.Skv && d < p.D) {
        kx = to_f(kg[kj * p.k_ss + d]);
        vx = to_f(vg[kj * p.v_ss + d]);
      }
      Ks[j * KS + d] = kx;
      Vs[j * DP + d] = vx;
    }
    __syncthreads();

    // scores of this lane's key for the warp's rows
    const int kj = k0 + lane;
    const bool kvalid = kj < p.Skv;
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float4* krow = reinterpret_cast<const float4*>(Ks + lane * KS);
#pragma unroll
    for (int d4 = 0; d4 < DP / 4; ++d4) {
      const float4 kv = krow[d4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv =
            reinterpret_cast<const float4*>(Qs + (warp * kRows + r) * DP)[d4];
        s[r] = fmaf(qv.x, kv.x, s[r]);
        s[r] = fmaf(qv.y, kv.y, s[r]);
        s[r] = fmaf(qv.z, kv.z, s[r]);
        s[r] = fmaf(qv.w, kv.w, s[r]);
      }
    }

    // online softmax; masked (out-of-range) keys get p = 0 exactly
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = warp * kRows + r;
      const int qi = q0 + row;
      float sr = -INFINITY;
      if (kvalid) {
        sr = s[r] * p.scale;
        if (bg != nullptr && qi < p.Sq) sr += bg[qi * p.b_sq + kj * p.b_sk];
      }
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
      Ps[row * kBlockK + lane] = to_f(from_f<T>(pr));  // P in v's dtype
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
    }
    __syncwarp();

#pragma unroll 8
    for (int j = 0; j < kBlockK; ++j) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = Vs[j * DP + c * 32 + lane];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = Ps[(warp * kRows + r) * kBlockK + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(pj, vv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float lt = l[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      lt += __shfl_xor_sync(kFull, lt, off);
    const int qi = q0 + warp * kRows + r;
    if (qi >= p.Sq) continue;
    const float inv = 1.f / fmaxf(lt, 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = c * 32 + lane;
      if (d < p.D) og[qi * p.o_ss + d] = from_f<T>(acc[r][c] * inv);
    }
  }
}

template <typename T, int NC>
cudaError_t launch(const Params& p, int bh, cudaStream_t stream) {
  const int smem = smem_floats<NC>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fma_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (p.Sq + kBlockQ - 1) / kBlockQ);
  flash_fma_kernel<T, NC><<<grid, kWarps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int bh, cudaStream_t stream) {
  switch ((p.D + 31) / 32) {
    case 1: return launch<T, 1>(p, bh, stream);
    case 2: return launch<T, 2>(p, bh, stream);
    case 3: return launch<T, 3>(p, bh, stream);
    case 4: return launch<T, 4>(p, bh, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace fma_body
}  // namespace flash
