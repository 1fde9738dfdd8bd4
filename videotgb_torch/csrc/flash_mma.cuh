// The flash-attention forward on Hopper's tensor cores (mma.sync), shared by
// kernels A (flash_fwd.cu) and G (flash_bshd.cu), and the rule that picks
// between it and the CUDA-core body (flash_fma.cuh).
//
// The same function as the CUDA-core body, for bf16 q/k/v/out: the products
// of bf16 operands accumulate in f32 in the tensor cores, the bias is added
// in f32 after scaling, the online softmax runs in f32 with m starting at
// NEG_INF (-1e30) as in the TPU kernel, P is rounded to bf16 for the PV
// product, out = acc / max(l, 1e-30) in bf16. Only the order of the f32 sums
// differs. Keys past Skv are masked with -inf, not with the -1e30 bias, so a
// row whose real keys all carry -1e30 averages its Skv keys uniformly, as
// the plain softmax does, and never the padding.
//
// Bound on the H100: at the ViT-g serving shape (16 images x 16 heads x 264
// x 88) the work is ~6.3 GFLOP (6 us at 989 TFLOP/s) against ~48 MB of
// q/k/v/out (14 us at 3.35 TB/s): memory, at ~130 FLOP per byte. The
// CUDA-core body ran 36x that bound on FMA issue and shared-memory reads, so
// this body moves both products to the tensor cores and keeps every
// intermediate in registers (FlashAttention-2's layout):
//   * a block of 4 warps per (batch*head, 128 query rows), each warp two
//     16-row m-tiles, so that every K and V fragment read from shared memory
//     feeds two products; with a bias row per query (a (B,H,S,S) bias) or
//     at DP = 128 the registers allow one m-tile, and a block takes 64 rows;
//   * Q is copied once by cp.async, its fragments read by ldmatrix per
//     tile; 64-key K/V tiles are double-buffered in shared memory by
//     cp.async, the next tile's copy in flight under this tile's products;
//     cp.async's zero fill pads the ragged key and query tails and the head
//     dim up to DP (88 -> 96) in Q, K and V alike, so padding never carries
//     garbage (or NaN) into a product;
//   * S = Q K^T by mma.sync m16n8k16 (bf16 -> f32) with K fragments from
//     ldmatrix; scale, bias (read through its four strides into registers
//     while the tile's barrier waits; one row for all queries where the
//     bias has none of its own, as ViT-g's (1,1,1,S) pad bias) and the -inf
//     key mask applied in registers; the row max and sum stay within the
//     four lanes of a row (__shfl_xor), the sum reduced once at the end;
//   * P is rounded to bf16 in registers: the m16n8k16 C fragments of two
//     neighbouring key tiles are the A fragment of the PV mma, so P never
//     touches shared memory; V fragments come from ldmatrix.trans;
//   * shared rows are padded by 16 bytes (an odd number of 16-byte chunks),
//     so the eight rows an ldmatrix phase reads fall on distinct banks;
//   * a warp whose rows all lie past Sq skips the tile's work; keys past
//     Skv are masked, not skipped: a second code path for the partial last
//     tile raised the register count and cost more than the products it
//     saved;
//   * only the D real columns and Sq real rows are stored, two bf16 values
//     per store, through the output strides.
// What bounds it now: mma.sync issue on the padded tiles together with the
// exp / max work between the two products, at two blocks of 4 warps per SM
// (the registers: 250-255 a thread). wgmma on TMA-fed tiles, with a
// producer warp, is the next step.
// The bodies are templated on the padded head dim DP: 16, 32, 64, 96, 128.
// Inputs must have 16-byte rows: D % 8 == 0, base pointers 16-byte aligned
// and every (batch, head, seq) stride a multiple of 8 elements (forward()
// refuses the rest, which the CUDA-core body takes).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "flash_fma.cuh"
#include "mma_util.cuh"

namespace flash {

// the bodies, as the C entries' `body` argument names them
constexpr int kBodyFma = 0;
constexpr int kBodyMma = 1;

namespace mma_body {

using namespace mma_util;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockK = 64;           // keys per tile
constexpr float kNegInf = -1e30f;     // the TPU kernel's NEG_INF

// A block of 4 warps, each with MT 16-row m-tiles of queries. Shared memory:
// the block's Q rows, then K and V of two stages of 64 keys, every row DP
// bf16 padded by 16 bytes.
template <int DP, int MT>
struct Tile {
  static constexpr int kRow = 2 * DP + 16;
  static constexpr int kBlockQ = kWarps * 16 * MT;
  static constexpr int kKV = kBlockK * kRow;
  static constexpr int kBytes = kBlockQ * kRow + 4 * kKV;
};

// copy rows [r0, r0 + ROWS) of a (rows, D) bf16 matrix with row stride
// s_seq into a [ROWS][2 DP + 16 bytes] shared tile by 16-byte cp.async;
// rows past `rows` and columns past D are zero-filled
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile(uint8_t* dst,
                                          const __nv_bfloat16* src,
                                          long long s_seq, int r0, int rows,
                                          int D) {
  constexpr int kChunks = DP / 8;
  constexpr int kRow = 2 * DP + 16;
  static_assert((ROWS * kChunks) % kThreads == 0, "whole copies per thread");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / kChunks;
    const int cc = c - r * kChunks;
    const bool valid = r0 + r < rows && cc * 8 < D;
    const __nv_bfloat16* g = valid ? src + (r0 + r) * s_seq + cc * 8 : src;
    cp_async16(smem_addr(dst + r * kRow + cc * 16), g, valid);
  }
}

// the bias as a kernel reads it
constexpr int kNoBias = 0;
constexpr int kRowBias = 1;   // one row for every query (b_sq == 0)
constexpr int kFullBias = 2;  // a row per query

// one 64-key tile for a warp's MT m-tiles: S = Q K^T, scale and the bias bv
// (keys 8j + 2t and + 1 of the lane's rows g and g + 8, the same for every
// m-tile), the key mask (keys past Skv, nvalid on, get -inf), the online
// softmax, and O += P V. Every K and V fragment feeds MT products.
template <int DP, int MT>
__device__ __forceinline__ void tile_step(
    const uint8_t* qs, const uint8_t* kt, const uint8_t* vt,
    const float (&bv)[8][4], float scale, int nvalid, int lane,
    float (&o)[MT][DP / 8][4], float (&m)[MT][2], float (&l)[MT][2]) {
  constexpr int kRow = 2 * DP + 16;
  constexpr int KT = DP / 16;
  constexpr int NT = DP / 8;
  const int t = lane & 3;
  // ldmatrix row addresses: A (Q) tiles take rows lane % 16 at byte 16 *
  // (lane / 16); a pair of K tiles takes keys (lane % 8) + 8 * (lane / 16)
  // at byte 16 * ((lane / 8) % 2); a pair of V tiles (transposed) takes
  // keys (lane % 8) + 8 * ((lane / 8) % 2) at byte 16 * (lane / 16)
  const int a_row = lane & 15, a_col = (lane >> 4) * 16;
  const int k_row = (lane & 7) + ((lane >> 4) << 3);
  const int k_col = ((lane >> 3) & 1) * 16;
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int v_col = (lane >> 4) * 16;

  float s[MT][8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    uint32_t qa[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldmatrix_x4(qa[mt], smem_addr(qs + (mt * 16 + a_row) * kRow + kk * 32 +
                                    a_col));
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      uint32_t r[4];
      ldmatrix_x4(r, smem_addr(kt + (j * 8 + k_row) * kRow + kk * 32 +
                               k_col));
      const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16_16816(s[mt][j], qa[mt], b0);
        mma_bf16_16816(s[mt][j + 1], qa[mt], b1);
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = j * 8 + 2 * t + (e & 1);
        s[mt][j][e] =
            kj < nvalid ? s[mt][j][e] * scale + bv[j][e] : -INFINITY;
      }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {  // rows g and g + 8
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[mt][j][2 * rr], s[mt][j][2 * rr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // every tile holds a key in range, so mx is finite
      const float mn = fmaxf(m[mt][rr], mx);
      const float alpha = __expf(m[mt][rr] - mn);
      m[mt][rr] = mn;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * rr; e < 2 * rr + 2; ++e) {
          const float pe = __expf(s[mt][j][e] - mn);  // 0 at masked keys
          s[mt][j][e] = pe;
          sum += pe;
        }
      l[mt][rr] = l[mt][rr] * alpha + sum;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[mt][n][2 * rr] *= alpha;
        o[mt][n][2 * rr + 1] *= alpha;
      }
    }
  }

  // O += P V, P rounded to bf16 in registers
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      a[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
      a[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
      a[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
      a[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
    }
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, smem_addr(vt + (kk * 16 + v_row) * kRow + n * 16 +
                                     v_col));
      const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16_16816(o[mt][n], a[mt], b0);
        mma_bf16_16816(o[mt][n + 1], a[mt], b1);
      }
    }
  }
}

template <int DP, int MT, int kBias>
__global__ void __launch_bounds__(kThreads)
flash_mma_kernel(const Params p) {
  static_assert(kBias != kFullBias || MT == 1, "a bias row per m-tile row");
  using TL = Tile<DP, MT>;
  constexpr int NT = DP / 8;  // 8-column tiles of the output
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* Qs = smem;
  uint8_t* kv = smem + TL::kBlockQ * TL::kRow;
  auto Ks = [&](int s) { return kv + (2 * s) * TL::kKV; };
  auto Vs = [&](int s) { return kv + (2 * s + 1) * TL::kKV; };

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = blockIdx.y * TL::kBlockQ;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int w0 = q0 + warp * 16 * MT;  // the warp's first row
  // a warp whose rows all lie past Sq only copies and waits
  const bool active = w0 < p.Sq;

  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  __nv_bfloat16* og =
      static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;

  // the bias rows of this lane's rows w0 + g and w0 + g + 8, read at a row
  // in range (one row for all with a row bias)
  const float* brow[2] = {nullptr, nullptr};
  if (kBias != kNoBias) {
    const float* bg = p.bias + b * p.b_sb + h * p.b_sh;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      brow[rr] = kBias == kRowBias
                     ? bg
                     : bg + min(w0 + g + 8 * rr, p.Sq - 1) * p.b_sq;
  }

  // group 0: Q; group 1: the first K/V tile
  load_tile<DP, TL::kBlockQ>(Qs, qg, p.q_ss, q0, p.Sq, p.D);
  cp_async_commit();
  load_tile<DP, kBlockK>(Ks(0), kg, p.k_ss, 0, p.Skv, p.D);
  load_tile<DP, kBlockK>(Vs(0), vg, p.v_ss, 0, p.Skv, p.D);
  cp_async_commit();

  float o[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][n][e] = 0.f;
  float m[MT][2], l[MT][2];  // l: this lane's share of the row sums
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      m[mt][rr] = kNegInf;
      l[mt][rr] = 0.f;
    }

  const int n_tiles = (p.Skv + kBlockK - 1) / kBlockK;
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < n_tiles) {
      const int k1 = (it + 1) * kBlockK;
      load_tile<DP, kBlockK>(Ks(st ^ 1), kg, p.k_ss, k1, p.Skv, p.D);
      load_tile<DP, kBlockK>(Vs(st ^ 1), vg, p.v_ss, k1, p.Skv, p.D);
    }
    cp_async_commit();
    const int k0 = it * kBlockK;
    const int nvalid = min(kBlockK, p.Skv - k0);  // keys in range
    // this tile's bias, loaded while the barrier waits
    float bv[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = j * 8 + 2 * t + (e & 1);
        if (kBias == kRowBias && e >= 2)
          bv[j][e] = bv[j][e - 2];
        else
          bv[j][e] = kBias != kNoBias && active && kj < nvalid
                         ? __ldg(brow[e >> 1] + (k0 + kj) * p.b_sk)
                         : 0.f;
      }
    cp_async_wait<1>();  // every group but the newest: tile it has landed
    __syncthreads();
    if (active)
      tile_step<DP, MT>(Qs + warp * 16 * MT * TL::kRow, Ks(st), Vs(st), bv,
                        p.scale, nvalid, lane, o, m, l);
    __syncthreads();  // stage st is consumed before it is refilled
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float lt = l[mt][rr];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const int qi = w0 + 16 * mt + g + 8 * rr;
      if (qi >= p.Sq) continue;
      const float inv = 1.f / fmaxf(lt, 1e-30f);
      __nv_bfloat16* orow = og + qi * p.o_ss;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = n * 8 + 2 * t;
        if (col < p.D)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o[mt][n][2 * rr] * inv,
                                    o[mt][n][2 * rr + 1] * inv);
      }
    }
}

template <int DP, int MT, int kBias>
cudaError_t launch(const Params& p, int bh, cudaStream_t stream) {
  using TL = Tile<DP, MT>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<DP, MT, kBias>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, TL::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (p.Sq + TL::kBlockQ - 1) / TL::kBlockQ);
  flash_mma_kernel<DP, MT, kBias><<<grid, kThreads, TL::kBytes, stream>>>(p);
  return cudaGetLastError();
}

// Two m-tiles per warp (128-row blocks) halve the ldmatrix reads per
// product; they fit the registers without a bias or with a row bias up to
// DP = 96. A bias row per query, or DP = 128, takes one m-tile per warp.
template <int kBias>
cudaError_t dispatch_dim(const Params& p, int bh, cudaStream_t stream) {
  constexpr int MT = kBias == kFullBias ? 1 : 2;
  if (p.D <= 16) return launch<16, MT, kBias>(p, bh, stream);
  if (p.D <= 32) return launch<32, MT, kBias>(p, bh, stream);
  if (p.D <= 64) return launch<64, MT, kBias>(p, bh, stream);
  if (p.D <= 96) return launch<96, MT, kBias>(p, bh, stream);
  return launch<128, 1, kBias>(p, bh, stream);
}

inline cudaError_t dispatch(const Params& p, int bh, cudaStream_t stream) {
  if (p.bias == nullptr) return dispatch_dim<kNoBias>(p, bh, stream);
  if (p.b_sq == 0) return dispatch_dim<kRowBias>(p, bh, stream);
  return dispatch_dim<kFullBias>(p, bh, stream);
}

}  // namespace mma_body

// 16-byte rows everywhere: what the tensor-core body's copies need
inline bool mma_aligned(const Params& p) {
  const long long strides[] = {p.q_sb, p.q_sh, p.q_ss, p.k_sb, p.k_sh,
                               p.k_ss, p.v_sb, p.v_sh, p.v_ss, p.o_sb,
                               p.o_sh, p.o_ss};
  for (long long s : strides)
    if (s % 8 != 0) return false;
  const void* ptrs[] = {p.q, p.k, p.v, p.o};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return false;
  return p.D % 8 == 0;
}

// dtype: 0 = float32, 1 = bfloat16; body: kBodyFma or kBodyMma (bf16 with
// 16-byte rows only). Returns the launch's cudaError_t.
inline cudaError_t forward(const Params& p, int bh, int dtype, int body,
                           cudaStream_t stream) {
  if (p.H <= 0 || bh <= 0 || p.Sq <= 0 || p.Skv <= 0 || p.D <= 0 ||
      p.D > 128)
    return cudaErrorInvalidValue;
  if (body == kBodyMma) {
    if (dtype != 1 || !mma_aligned(p)) return cudaErrorInvalidValue;
    return mma_body::dispatch(p, bh, stream);
  }
  if (body != kBodyFma) return cudaErrorInvalidValue;
  if (dtype == 0) return fma_body::dispatch<float>(p, bh, stream);
  if (dtype == 1) return fma_body::dispatch<__nv_bfloat16>(p, bh, stream);
  return cudaErrorInvalidValue;
}

}  // namespace flash
