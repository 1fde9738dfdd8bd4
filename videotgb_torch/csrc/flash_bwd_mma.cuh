// Kernel C's tensor-core body: the flash-attention backward on Hopper's
// tensor cores (mma.sync), for bf16 q/k/v/dO with 16-byte rows, and the
// launch description (Params) that both bodies of flash_bwd.cu take.
//
// Replaces the Pallas TPU kernel videotgb_tpu/ops/attention.py::
// _flash_bwd_kernel (driven by _flash_backward_pallas), whose design it
// keeps: a whole key range per row slab, so that each score's S and dP are
// computed once. Same function as the CUDA-core body: the f32 softmax is
// recomputed from q/k/v/bias (scale, then the f32 bias), then
//   dv = p^T dO,  dp = dO v^T,  ds = p (dp - rowsum(dp p)),
//   dq = ds k * scale,  dk = ds^T q * scale,
// every product bf16 x bf16 accumulated in f32 by mma.sync m16n8k16; p is
// rounded to bf16 only for the dv product and ds only for the dq and dk
// products; rowsum(dp p) is taken from the f32 p of the recompute. Keys past
// Skv are masked with -inf, so a row whose real keys all carry NEG_INF
// (-1e30) averages them uniformly and never returns NaN. The f32 ds is
// written only where the bias's gradient is asked for.
//
// Bound on the H100 at the main path's shape (T5-xl encoder, 8 x 32 heads x
// 160 x 64, a (8,32,160,160) f32 bias, no ds): 5 products of 2 x 160 x 160
// x 64 per head, 4.19 GFLOP (4.2 us at 989 TFLOP/s), against 7 x 5.24 MB of
// q/k/v/dO/dq/dk/dv and 26.2 MB of bias (18.8 us at 3.35 TB/s): memory.
//
// Design:
//   * one pass where a head's whole key range fits (Skv <= 160 keys, and
//     Q, dO, K, V and the bf16 P and dS of the head within a block's 227
//     KB of shared memory: the rule one_pass() below, mirrored by
//     ops/attention.py::flash_bwd_passes). One block of 10 warps per
//     (batch*head), so the sums over queries (dk, dv) and over keys (dq)
//     stay inside the block: no atomics, no second launch, the same bits
//     on every run. At the main shape the block holds 195 KB: Q, dO, K, V
//     (160 rows of 144 bytes each) and P, dS (160 rows of 336 bytes).
//       - Q, K, dO and V are copied once by cp.async (zero fill pads the
//         ragged rows and the head dim; nothing is padded in HBM), Q and K
//         first, so that S = Q K^T starts while dO and V land;
//       - rows phase, a warp per 16 query rows over every key: S and dP =
//         dO V^T by mma.sync into registers (80 f32 a thread each at 160
//         keys), the bias read through its four strides, softmax and delta
//         = rowsum(dP P) within the four lanes of a row, dS = P (dP -
//         delta) in place of dP; P and dS go to shared memory as bf16, and
//         the C fragments of dS are the A fragments of dq = dS K (K by
//         ldmatrix.trans), so dq needs no shared memory of its own;
//       - columns phase, a warp per 16 keys over every query: dv = P^T dO
//         and dk = dS^T Q, P and dS read as transposed A operands by
//         ldmatrix.trans, dO and Q as B operands by ldmatrix.trans.
//   * two launches where it does not fit (longer sequences, or D = 128 at
//     160 x 160), built from the same tile routines, the split of the
//     CUDA-core body on the tensor cores:
//       - rows pass, a block of 4 warps per (batch*head, 64 query rows)
//         over double-buffered 64-key K/V tiles, twice: first the online
//         row max m, sum l and rowsum(exp(s - m) dP), which give delta;
//         then S and dP again, dS, ds where asked, and dq += dS K; m, l and
//         delta go to an f32 scratch (3, B*H, Sq);
//       - columns pass, a block of 4 warps per (batch*head, 64 keys) over
//         double-buffered Q/dO tiles (64 queries, 32 at D = 128): S^T = K Q^T and dP^T = V dO^T, so the
//         C fragments of P^T and dS^T are the A fragments of dv += P^T dO
//         and dk += dS^T Q, with m, l and delta read per query.
//   * shared rows are padded by 16 bytes (an odd number of 16-byte chunks),
//     so the eight rows an ldmatrix phase reads fall on distinct banks.
//   * a bias with a contiguous row per query is staged by coalesced
//     cp.async into the warp's own rows of P and dS before it writes them;
//     read straight from HBM in fragment order (8 rows x 32 bytes a load)
//     it cost more than the rest of the rows phase (0.078 -> 0.050 ms).
// Inputs must have 16-byte rows: D % 8 == 0, base pointers 16-byte aligned
// and every (batch, head, seq) stride of q/k/v/dO/dq/dk/dv a multiple of 8
// elements (flash_bwd() refuses the rest, which the CUDA-core body takes).
//
// Read on an H100 80GB HBM3 at 700 W (chip_smoke.py, phase 5): 0.050 ms a
// call at the main shape, 2.7x its bound, against 0.67 ms for the CUDA-core
// body and 0.073 ms for SDPA's backward. What bounds it now is latency, not
// bytes or products: one 195 KB block per SM, so a block's copies and its
// products do not overlap, and 256 blocks take two rounds; the rows phase,
// the columns phase and the copies run one after another; at 10 warps a
// thread has 168 registers, and the 160 f32 of S and dP spill ~160 bytes.
// Next: a persistent block that copies the next head's K and V during the
// columns phase (which reads neither), or wgmma on TMA-fed tiles.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_util.cuh"

namespace flash_grad {

// the bodies, as the C entry's `body` argument names them (the codes of the
// forward's entries, flash_mma.cuh)
constexpr int kBodyFma = 0;
constexpr int kBodyMma = 1;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* g;       // dO
  const float* bias;   // null: no bias (its strides are then ignored)
  void* dq;
  void* dk;
  void* dv;
  float* ds;           // (B*H, Sq, Skv) f32, or null
  float* stats;        // (3, B*H, Sq) f32: m, l, delta of the two passes
  int H, Sq, Skv, D, BH;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
      g_sb, g_sh, g_ss, dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss,
      dv_sb, dv_sh, dv_ss;
  long long b_sb, b_sh, b_sq, b_sk;
  float scale;
};

namespace mma_body {

using namespace mma_util;
using bf16 = __nv_bfloat16;

constexpr int kMaxKeys = 160;        // one pass: a head's keys in registers
constexpr int kMaxSmem = 232448;     // a block's shared memory on sm_90
constexpr int kOneWarps = 10;        // one-pass block
constexpr int kTwoWarps = 4;         // two-pass blocks: 64 rows or keys
constexpr int kTile = kTwoWarps * 16;

// the head dim as the bodies pad it: 16, 32, 64, 96 or 128
inline int pad_dim(int d) {
  return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : d <= 96 ? 96 : 128;
}

// shared bytes of the one-pass block: Q, dO (Sq rows), K, V (Skv rows) of
// 2 DP + 16 bytes, and P, dS (Sq rows of 2 Skv + 16 bytes), rows rounded up
// to 16
inline int one_pass_bytes(int sq, int skv, int dp) {
  const int qp = (sq + 15) / 16 * 16, kp = (skv + 15) / 16 * 16;
  return 2 * (qp + kp) * (2 * dp + 16) + 2 * qp * (2 * kp + 16);
}

inline bool one_pass(int sq, int skv, int d) {
  return skv <= kMaxKeys && one_pass_bytes(sq, skv, pad_dim(d)) <= kMaxSmem;
}

// copy rows [r0, r0 + n) of a (rows, D) bf16 matrix with row stride s_seq
// into a shared tile of rows 2 DP + 16 bytes by 16-byte cp.async, every
// thread of the block taking a share; rows past `rows` and columns past D
// are zero-filled
template <int DP>
__device__ __forceinline__ void copy_rows(uint8_t* dst, const bf16* src,
                                          long long s_seq, int r0, int n,
                                          int rows, int D) {
  constexpr int kChunks = DP / 8;
  constexpr int kRow = 2 * DP + 16;
  for (int c = threadIdx.x; c < n * kChunks; c += blockDim.x) {
    const int r = c / kChunks;
    const int cc = c - r * kChunks;
    const bool valid = r0 + r < rows && cc * 8 < D;
    const bf16* g = valid ? src + (r0 + r) * s_seq + cc * 8 : src;
    cp_async16(smem_addr(dst + r * kRow + cc * 16), g, valid);
  }
}

// ldmatrix row addresses of a warp's lane (the patterns of flash_mma.cuh):
// an A tile from a row-major [m][k] matrix; a pair of B tiles from an
// [n][k] matrix (keys by rows: S = Q K^T); a pair of B tiles from a [k][n]
// matrix, transposed (V in P V); an A tile from a [k][m] matrix, transposed
// (P^T), which takes the same rows and columns as the [n][k] pair
struct Lanes {
  int a_row, a_col, n_row, n_col, t_row, t_col;
  __device__ __forceinline__ explicit Lanes(int lane)
      : a_row(lane & 15), a_col((lane >> 4) * 16),
        n_row((lane & 7) + ((lane >> 4) << 3)),
        n_col(((lane >> 3) & 1) * 16),
        t_row((lane & 7) + (((lane >> 3) & 1) << 3)),
        t_col((lane >> 4) * 16) {}
};

// acc[j] += A B^T for NJ 8-column tiles: A the 16 rows at `a` (DP columns),
// B the rows of `b` (one per output column); tiles at or past `ncols` (a
// multiple of 16) are skipped
template <int DP, int NJ>
__device__ __forceinline__ void mma_abt(float (&acc)[NJ][4], const uint8_t* a,
                                        const uint8_t* b, int ncols,
                                        const Lanes& ln) {
  constexpr int kRow = 2 * DP + 16;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t af[4];
    ldmatrix_x4(af, smem_addr(a + ln.a_row * kRow + kk * 32 + ln.a_col));
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      if (j * 8 >= ncols) break;
      uint32_t r[4];
      ldmatrix_x4(r, smem_addr(b + (j * 8 + ln.n_row) * kRow + kk * 32 +
                               ln.n_col));
      const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      mma_bf16_16816(acc[j], af, b0);
      mma_bf16_16816(acc[j + 1], af, b1);
    }
  }
}

// acc += A B for one 16-deep k step: A from registers, B the 16 rows at `b`
// of a row-major [k][n] tile (DP columns), read transposed
template <int DP>
__device__ __forceinline__ void mma_ab_step(float (&acc)[DP / 8][4],
                                            const uint32_t (&af)[4],
                                            const uint8_t* b,
                                            const Lanes& ln) {
  constexpr int kRow = 2 * DP + 16;
#pragma unroll
  for (int n = 0; n < DP / 8; n += 2) {
    uint32_t r[4];
    ldmatrix_x4_trans(r, smem_addr(b + ln.t_row * kRow + n * 16 + ln.t_col));
    const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
    mma_bf16_16816(acc[n], af, b0);
    mma_bf16_16816(acc[n + 1], af, b1);
  }
}

// the A fragment of k step kk from the C fragments of 16-column pairs
template <int NJ>
__device__ __forceinline__ void a_from_c(uint32_t (&af)[4],
                                         const float (&c)[NJ][4], int kk) {
  af[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  af[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  af[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  af[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// store a warp's 16 x DP f32 accumulators times `mul` as bf16 rows r0 ..
// r0 + 15 of out (row stride ss), rows below `rows` and columns below D
template <int DP>
__device__ __forceinline__ void store_rows(bf16* out, long long ss,
                                           const float (&acc)[DP / 8][4],
                                           float mul, int r0, int rows, int D,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = r0 + g + 8 * rr;
    if (r >= rows) continue;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(out + r * ss + col) =
            __floats2bfloat162_rn(acc[n][2 * rr] * mul,
                                  acc[n][2 * rr + 1] * mul);
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <typename T>
__device__ __forceinline__ const T* head(const void* base, long long sb,
                                         long long sh, int b, int h) {
  return static_cast<const T*>(base) + b * sb + h * sh;
}

// scale, bias and the -inf key mask of a warp's NJ x 8 key tiles at keys
// k0 + 8 j + 2 t (+1) of query rows qi[0] and qi[1] (clamped into range)
template <int NJ>
__device__ __forceinline__ void scores(float (&s)[NJ][4], const Params& p,
                                       const float* bg, const int (&qi)[2],
                                       int k0, int t) {
  const float* brow[2] = {nullptr, nullptr};
  if (bg != nullptr) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      brow[rr] = bg + min(qi[rr], p.Sq - 1) * p.b_sq;
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kj = k0 + j * 8 + 2 * t + (e & 1);
      float x = -INFINITY;
      if (kj < p.Skv) {
        x = s[j][e] * p.scale;
        if (bg != nullptr) x += __ldg(brow[e >> 1] + kj * p.b_sk);
      }
      s[j][e] = x;
    }
}

// ------------------------------------------------------------ one pass
template <int DP>
__global__ void __launch_bounds__(kOneWarps * 32, 1)
bwd_one_pass(const Params p) {
  constexpr int kRow = 2 * DP + 16;
  constexpr int NJ = kMaxKeys / 8;  // 8-key tiles of S and dP
  constexpr int NT = DP / 8;        // 8-column tiles of dq, dk, dv
  extern __shared__ __align__(16) uint8_t smem[];
  const int qp = (p.Sq + 15) & ~15;
  const int kp = (p.Skv + 15) & ~15;
  const int sp = 2 * kp + 16;       // P and dS row pitch, bytes
  uint8_t* Qs = smem;
  uint8_t* Gs = Qs + qp * kRow;
  uint8_t* Ks = Gs + qp * kRow;
  uint8_t* Vs = Ks + kp * kRow;
  uint8_t* Ps = Vs + kp * kRow;
  uint8_t* Ds = Ps + qp * sp;

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const Lanes ln(lane);

  const bf16* qg = head<bf16>(p.q, p.q_sb, p.q_sh, b, h);
  const bf16* kg = head<bf16>(p.k, p.k_sb, p.k_sh, b, h);
  const bf16* vg = head<bf16>(p.v, p.v_sb, p.v_sh, b, h);
  const bf16* gg = head<bf16>(p.g, p.g_sb, p.g_sh, b, h);
  const float* bg =
      p.bias ? head<float>(p.bias, p.b_sb, p.b_sh, b, h) : nullptr;

  // group 0: Q and K, for S; group 1: dO and V, for dP
  copy_rows<DP>(Qs, qg, p.q_ss, 0, qp, p.Sq, p.D);
  copy_rows<DP>(Ks, kg, p.k_ss, 0, kp, p.Skv, p.D);
  cp_async_commit();
  copy_rows<DP>(Gs, gg, p.g_ss, 0, qp, p.Sq, p.D);
  copy_rows<DP>(Vs, vg, p.v_ss, 0, kp, p.Skv, p.D);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // A bias with a contiguous, 16-byte aligned row per query (the T5
  // encoder's (B,H,S,S)) is staged: a warp copies its 16 rows by coalesced
  // cp.async into its own rows of P and dS, free until it writes them,
  // while S is computed. Read in fragment order straight from HBM, its
  // rows cost more than the rest of the rows phase.
  const bool stage = bg != nullptr && p.b_sk == 1 && p.b_sq % 4 == 0 &&
                     p.b_sq != 0 && p.Skv % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(bg) % 16 == 0;
  const int stage_row = 4 * kp + 16;  // bytes: rows g fall on banks 4 g

  // rows phase: warp w takes query rows 16 (w + 10 i), i = 0, 1, ...
  const int n_iter = (qp / 16 + kOneWarps - 1) / kOneWarps;
  for (int it = 0; it < n_iter; ++it) {
    const int r0 = (warp + it * kOneWarps) * 16;
    const bool active = r0 < qp;
    // bias rows r0 .. r0 + 7 in P's rows, r0 + 8 .. r0 + 15 in dS's
    uint8_t* const staged[2] = {Ps + r0 * sp, Ds + r0 * sp};
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    if (active) {
      if (stage) {
        const int chunks = p.Skv / 4;
        for (int c = lane; c < 16 * chunks; c += 32) {
          const int i = c / chunks;
          const int cc = c - i * chunks;
          const float* src = bg + min(r0 + i, p.Sq - 1) * p.b_sq + cc * 4;
          cp_async16(smem_addr(staged[i >> 3] + (i & 7) * stage_row +
                               cc * 16), src, true);
        }
        cp_async_commit();
      }
      mma_abt<DP, NJ>(s, Qs + r0 * kRow, Ks, kp, ln);
    }
    if (it == 0) {  // block-uniform: dO and V have landed
      cp_async_wait<0>();
      __syncthreads();
    }
    if (!active) continue;

    const int qi[2] = {r0 + g, r0 + g + 8};
    if (stage) {
      cp_async_wait<0>();
      __syncwarp();  // every lane's rows have landed
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const float* brow =
            reinterpret_cast<const float*>(staged[rr] + g * stage_row);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int kj = j * 8 + 2 * t;  // kj and kj + 1: both in or out
          if (kj < p.Skv) {
            const float2 bv = *reinterpret_cast<const float2*>(brow + kj);
            s[j][2 * rr] = s[j][2 * rr] * p.scale + bv.x;
            s[j][2 * rr + 1] = s[j][2 * rr + 1] * p.scale + bv.y;
          } else {
            s[j][2 * rr] = s[j][2 * rr + 1] = -INFINITY;
          }
        }
      }
    } else {
      scores<NJ>(s, p, bg, qi, 0, t);
    }
    // P = softmax in f32, rows past Sq zeroed
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * rr], s[j][2 * rr + 1]));
      mx = quad_max(mx);  // finite: every row has a key in range
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 2 * rr; e < 2 * rr + 2; ++e) {
          const float pe = __expf(s[j][e] - mx);  // 0 at masked keys
          s[j][e] = pe;
          sum += pe;
        }
      sum = quad_sum(sum);
      const float inv = qi[rr] < p.Sq ? 1.f / sum : 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        s[j][2 * rr] *= inv;
        s[j][2 * rr + 1] *= inv;
      }
    }

    float dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
    mma_abt<DP, NJ>(dp, Gs + r0 * kRow, Vs, kp, ln);
    // dS = P (dP - delta), delta = rowsum(dP P), in place of dP
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float dl = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        dl += s[j][2 * rr] * dp[j][2 * rr] +
              s[j][2 * rr + 1] * dp[j][2 * rr + 1];
      const float delta = quad_sum(dl);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 2 * rr; e < 2 * rr + 2; ++e)
          dp[j][e] = s[j][e] * (dp[j][e] - delta);
    }

    // P and dS to shared memory as bf16 (over the staged bias, read by
    // every lane by now); ds to HBM where asked
    __syncwarp();
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j * 8 >= kp) break;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int at = (r0 + g + 8 * rr) * sp + (j * 8 + 2 * t) * 2;
        *reinterpret_cast<uint32_t*>(Ps + at) =
            pack_bf16(s[j][2 * rr], s[j][2 * rr + 1]);
        *reinterpret_cast<uint32_t*>(Ds + at) =
            pack_bf16(dp[j][2 * rr], dp[j][2 * rr + 1]);
      }
    }
    if (p.ds != nullptr) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        if (qi[rr] >= p.Sq) continue;
        float* row = p.ds + (static_cast<long long>(bh) * p.Sq + qi[rr]) *
                                p.Skv;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kj = j * 8 + 2 * t + e;
            if (kj < p.Skv) row[kj] = dp[j][2 * rr + e];
          }
      }
    }

    // dq = dS K * scale: the C fragments of dS are the A fragments
    float dq[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NJ / 2; ++kk) {
      if (kk * 16 >= kp) break;
      uint32_t af[4];
      a_from_c<NJ>(af, dp, kk);
      mma_ab_step<DP>(dq, af, Ks + kk * 16 * kRow, ln);
    }
    bf16* dqg = static_cast<bf16*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
    store_rows<DP>(dqg, p.dq_ss, dq, p.scale, r0, p.Sq, p.D, lane);
  }
  __syncthreads();  // every P and dS row is in shared memory

  // columns phase: warp w takes keys 16 (w + 10 i): dv = P^T dO, dk = dS^T Q
  bf16* dkg = static_cast<bf16*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  bf16* dvg = static_cast<bf16*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  for (int c0 = warp * 16; c0 < kp; c0 += kOneWarps * 16) {
    float dv[NT][4], dk[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dv[n][e] = dk[n][e] = 0.f;
    for (int kk = 0; kk < qp; kk += 16) {
      uint32_t af[4];
      ldmatrix_x4_trans(af, smem_addr(Ps + (kk + ln.n_row) * sp + c0 * 2 +
                                      ln.n_col));
      mma_ab_step<DP>(dv, af, Gs + kk * kRow, ln);
      ldmatrix_x4_trans(af, smem_addr(Ds + (kk + ln.n_row) * sp + c0 * 2 +
                                      ln.n_col));
      mma_ab_step<DP>(dk, af, Qs + kk * kRow, ln);
    }
    store_rows<DP>(dvg, p.dv_ss, dv, 1.f, c0, p.Skv, p.D, lane);
    store_rows<DP>(dkg, p.dk_ss, dk, p.scale, c0, p.Skv, p.D, lane);
  }
}

// ------------------------------------------------------------ two passes
// queries per tile of the columns pass: 32 at DP = 128, where dk and dv
// take 128 registers a thread, else 64
template <int DP>
__host__ __device__ constexpr int cols_tile() {
  return DP >= 128 ? 32 : 64;
}

// shared memory of a pass: its 64 own rows of two matrices, and two stages
// of the two it streams (64 keys, or cols_tile() queries)
template <int DP>
constexpr int rows_bytes() {
  return 6 * kTile * (2 * DP + 16);
}

template <int DP>
constexpr int cols_bytes() {
  return (2 * kTile + 4 * cols_tile<DP>()) * (2 * DP + 16);
}

// rows pass: a block per (batch*head, 64 query rows); two sweeps over the
// keys (m, l, delta; then dS and dq)
template <int DP>
__global__ void __launch_bounds__(kTwoWarps * 32)
bwd_rows(const Params p) {
  constexpr int kRow = 2 * DP + 16;
  constexpr int NJ = kTile / 8;
  constexpr int NT = DP / 8;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* Qs = smem;
  uint8_t* Gs = Qs + kTile * kRow;
  auto Ks = [&](int st) { return Gs + (1 + 2 * st) * kTile * kRow; };
  auto Vs = [&](int st) { return Gs + (2 + 2 * st) * kTile * kRow; };

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = blockIdx.y * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;              // the warp's rows in the tile
  const bool active = q0 + r0 < p.Sq;
  const Lanes ln(lane);

  const bf16* qg = head<bf16>(p.q, p.q_sb, p.q_sh, b, h);
  const bf16* kg = head<bf16>(p.k, p.k_sb, p.k_sh, b, h);
  const bf16* vg = head<bf16>(p.v, p.v_sb, p.v_sh, b, h);
  const bf16* gg = head<bf16>(p.g, p.g_sb, p.g_sh, b, h);
  const float* bg =
      p.bias ? head<float>(p.bias, p.b_sb, p.b_sh, b, h) : nullptr;
  const int qi[2] = {q0 + r0 + g, q0 + r0 + g + 8};

  copy_rows<DP>(Qs, qg, p.q_ss, q0, kTile, p.Sq, p.D);
  copy_rows<DP>(Gs, gg, p.g_ss, q0, kTile, p.Sq, p.D);
  cp_async_commit();
  copy_rows<DP>(Ks(0), kg, p.k_ss, 0, kTile, p.Skv, p.D);
  copy_rows<DP>(Vs(0), vg, p.v_ss, 0, kTile, p.Skv, p.D);
  cp_async_commit();

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
  float inv_l[2], delta[2];
  float dq[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  // iterations 0 .. n-1 sweep the keys for the statistics, n .. 2n-1 for
  // dS and dq; the next tile's copy is in flight under each tile's work
  const int n_tiles = (p.Skv + kTile - 1) / kTile;
  for (int it = 0; it < 2 * n_tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < 2 * n_tiles) {
      const int k1 = ((it + 1) % n_tiles) * kTile;
      copy_rows<DP>(Ks(st ^ 1), kg, p.k_ss, k1, kTile, p.Skv, p.D);
      copy_rows<DP>(Vs(st ^ 1), vg, p.v_ss, k1, kTile, p.Skv, p.D);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == n_tiles) {  // the statistics are complete
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const float lt = quad_sum(l[rr]);
        inv_l[rr] = 1.f / lt;
        delta[rr] = quad_sum(dl[rr]) / lt;
        if (t == 0 && active && qi[rr] < p.Sq) {
          const long long n_stats = static_cast<long long>(p.BH) * p.Sq;
          const long long at = static_cast<long long>(bh) * p.Sq + qi[rr];
          p.stats[at] = m[rr];
          p.stats[n_stats + at] = lt;
          p.stats[2 * n_stats + at] = delta[rr];
        }
      }
    }
    if (active) {
      const int k0 = (it % n_tiles) * kTile;
      float s[NJ][4], dp[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      mma_abt<DP, NJ>(s, Qs + r0 * kRow, Ks(st), kTile, ln);
      mma_abt<DP, NJ>(dp, Gs + r0 * kRow, Vs(st), kTile, ln);
      scores<NJ>(s, p, bg, qi, k0, t);
      if (it < n_tiles) {
        // online max, sum and rowsum(exp(s - m) dP)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            mx = fmaxf(mx, fmaxf(s[j][2 * rr], s[j][2 * rr + 1]));
          // every tile holds a key in range, so mn is finite
          const float mn = fmaxf(m[rr], quad_max(mx));
          const float alpha = __expf(m[rr] - mn);  // 0 on the first tile
          float sum = 0.f, dsum = 0.f;
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 2 * rr; e < 2 * rr + 2; ++e) {
              const float pe = __expf(s[j][e] - mn);
              sum += pe;
              dsum += pe * dp[j][e];
            }
          m[rr] = mn;
          l[rr] = l[rr] * alpha + sum;
          dl[rr] = dl[rr] * alpha + dsum;
        }
      } else {
        // dS = P (dP - delta); ds where asked; dq += dS K
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const bool row_in = qi[rr] < p.Sq;
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 2 * rr; e < 2 * rr + 2; ++e) {
              const float pe =
                  row_in ? __expf(s[j][e] - m[rr]) * inv_l[rr] : 0.f;
              dp[j][e] = pe * (dp[j][e] - delta[rr]);
            }
          if (p.ds != nullptr && row_in) {
            float* row = p.ds +
                (static_cast<long long>(bh) * p.Sq + qi[rr]) * p.Skv;
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int kj = k0 + j * 8 + 2 * t + e;
                if (kj < p.Skv) row[kj] = dp[j][2 * rr + e];
              }
          }
        }
#pragma unroll
        for (int kk = 0; kk < NJ / 2; ++kk) {
          uint32_t af[4];
          a_from_c<NJ>(af, dp, kk);
          mma_ab_step<DP>(dq, af, Ks(st) + kk * 16 * kRow, ln);
        }
      }
    }
    __syncthreads();  // stage st is consumed before it is refilled
  }
  bf16* dqg = static_cast<bf16*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  if (active)
    store_rows<DP>(dqg, p.dq_ss, dq, p.scale, q0 + r0, p.Sq, p.D, lane);
}

// columns pass: a block per (batch*head, 64 keys) over the query tiles:
// S^T = K Q^T and dP^T = V dO^T, P^T and dS^T from the rows pass's m, l and
// delta, dv += P^T dO and dk += dS^T Q
template <int DP>
__global__ void __launch_bounds__(kTwoWarps * 32)
bwd_cols(const Params p) {
  constexpr int kRow = 2 * DP + 16;
  constexpr int NQ = cols_tile<DP>();
  constexpr int NJ = NQ / 8;
  constexpr int NT = DP / 8;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* Ks = smem;
  uint8_t* Vs = Ks + kTile * kRow;
  auto Qs = [&](int st) { return Vs + kTile * kRow + 2 * st * NQ * kRow; };
  auto Gs = [&](int st) { return Qs(st) + NQ * kRow; };

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int k0 = blockIdx.y * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = warp * 16;              // the warp's keys in the tile
  const bool active = k0 + c0 < p.Skv;
  const Lanes ln(lane);

  const bf16* qg = head<bf16>(p.q, p.q_sb, p.q_sh, b, h);
  const bf16* kg = head<bf16>(p.k, p.k_sb, p.k_sh, b, h);
  const bf16* vg = head<bf16>(p.v, p.v_sb, p.v_sh, b, h);
  const bf16* gg = head<bf16>(p.g, p.g_sb, p.g_sh, b, h);
  const float* bg =
      p.bias ? head<float>(p.bias, p.b_sb, p.b_sh, b, h) : nullptr;
  const long long n_stats = static_cast<long long>(p.BH) * p.Sq;
  const float* stats = p.stats + static_cast<long long>(bh) * p.Sq;
  const int kj[2] = {k0 + c0 + g, k0 + c0 + g + 8};

  copy_rows<DP>(Ks, kg, p.k_ss, k0, kTile, p.Skv, p.D);
  copy_rows<DP>(Vs, vg, p.v_ss, k0, kTile, p.Skv, p.D);
  cp_async_commit();
  copy_rows<DP>(Qs(0), qg, p.q_ss, 0, NQ, p.Sq, p.D);
  copy_rows<DP>(Gs(0), gg, p.g_ss, 0, NQ, p.Sq, p.D);
  cp_async_commit();

  float dv[NT][4], dk[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[n][e] = dk[n][e] = 0.f;

  const float* brow[2] = {nullptr, nullptr};
  if (bg != nullptr) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      brow[rr] = bg + min(kj[rr], p.Skv - 1) * p.b_sk;
  }

  const int n_tiles = (p.Sq + NQ - 1) / NQ;
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < n_tiles) {
      const int i1 = (it + 1) * NQ;
      copy_rows<DP>(Qs(st ^ 1), qg, p.q_ss, i1, NQ, p.Sq, p.D);
      copy_rows<DP>(Gs(st ^ 1), gg, p.g_ss, i1, NQ, p.Sq, p.D);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (active) {
      const int i0 = it * NQ;
      float s[NJ][4], dp[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      mma_abt<DP, NJ>(s, Ks + c0 * kRow, Qs(st), NQ, ln);
      mma_abt<DP, NJ>(dp, Vs + c0 * kRow, Gs(st), NQ, ln);
      // P^T and dS^T: rows are keys, columns queries i0 + 8 j + 2 t (+1)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int qi = i0 + j * 8 + 2 * t + e1;
          float mi = 0.f, li = 1.f, di = 0.f;
          const bool q_in = qi < p.Sq;
          if (q_in) {
            mi = __ldg(stats + qi);
            li = __ldg(stats + n_stats + qi);
            di = __ldg(stats + 2 * n_stats + qi);
          }
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int e = 2 * rr + e1;
            float pe = 0.f;
            if (q_in && kj[rr] < p.Skv) {
              float x = s[j][e] * p.scale;
              if (bg != nullptr) x += __ldg(brow[rr] + qi * p.b_sq);
              pe = __expf(x - mi) / li;
            }
            s[j][e] = pe;
            dp[j][e] = pe * (dp[j][e] - di);
          }
        }
#pragma unroll
      for (int kk = 0; kk < NJ / 2; ++kk) {
        uint32_t af[4];
        a_from_c<NJ>(af, s, kk);
        mma_ab_step<DP>(dv, af, Gs(st) + kk * 16 * kRow, ln);
        a_from_c<NJ>(af, dp, kk);
        mma_ab_step<DP>(dk, af, Qs(st) + kk * 16 * kRow, ln);
      }
    }
    __syncthreads();  // stage st is consumed before it is refilled
  }
  if (!active) return;
  bf16* dkg = static_cast<bf16*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  bf16* dvg = static_cast<bf16*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  store_rows<DP>(dvg, p.dv_ss, dv, 1.f, k0 + c0, p.Skv, p.D, lane);
  store_rows<DP>(dkg, p.dk_ss, dk, p.scale, k0 + c0, p.Skv, p.D, lane);
}

template <int DP>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  if (one_pass(p.Sq, p.Skv, p.D)) {
    const int bytes = one_pass_bytes(p.Sq, p.Skv, DP);
    cudaError_t err = cudaFuncSetAttribute(
        bwd_one_pass<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return err;
    bwd_one_pass<DP><<<p.BH, kOneWarps * 32, bytes, stream>>>(p);
    return cudaGetLastError();
  }
  cudaError_t err = cudaFuncSetAttribute(
      bwd_rows<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      rows_bytes<DP>());
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      bwd_cols<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      cols_bytes<DP>());
  if (err != cudaSuccess) return err;
  const dim3 grid_rows(p.BH, (p.Sq + kTile - 1) / kTile);
  bwd_rows<DP><<<grid_rows, kTwoWarps * 32, rows_bytes<DP>(), stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_cols(p.BH, (p.Skv + kTile - 1) / kTile);
  bwd_cols<DP><<<grid_cols, kTwoWarps * 32, cols_bytes<DP>(), stream>>>(p);
  return cudaGetLastError();
}

inline cudaError_t dispatch(const Params& p, cudaStream_t stream) {
  switch (pad_dim(p.D)) {
    case 16: return launch<16>(p, stream);
    case 32: return launch<32>(p, stream);
    case 64: return launch<64>(p, stream);
    case 96: return launch<96>(p, stream);
    default: return launch<128>(p, stream);
  }
}

}  // namespace mma_body

// 16-byte rows everywhere: what the tensor-core body's copies need
inline bool mma_aligned(const Params& p) {
  const long long strides[] = {
      p.q_sb, p.q_sh, p.q_ss, p.k_sb, p.k_sh, p.k_ss, p.v_sb, p.v_sh,
      p.v_ss, p.g_sb, p.g_sh, p.g_ss, p.dq_sb, p.dq_sh, p.dq_ss, p.dk_sb,
      p.dk_sh, p.dk_ss, p.dv_sb, p.dv_sh, p.dv_ss};
  for (long long s : strides)
    if (s % 8 != 0) return false;
  const void* ptrs[] = {p.q, p.k, p.v, p.g, p.dq, p.dk, p.dv};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return false;
  return p.D % 8 == 0;
}

}  // namespace flash_grad
