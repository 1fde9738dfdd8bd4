// Kernel C: the flash-attention backward for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel videotgb_tpu/ops/attention.py::
// _flash_bwd_kernel (driven by _flash_backward_pallas). Same function: the
// softmax is recomputed in f32 from q/k/v/bias (the forward saves neither
// probabilities nor the log-sum-exp), then
//   dv = p^T dO,  dp = dO v^T,  ds = p (dp - rowsum(dp p)),
//   dq = ds k * scale,  dk = ds^T q * scale,
// with products of bf16 (or f32) operands accumulated in f32, p rounded to
// v's dtype before the dv product and ds rounded to q's dtype before the dq
// and dk products, as the TPU kernel rounds them. rowsum(dp p) is taken from
// the f32 p of the recompute, not from the forward's rounded output. A
// learned bias gets the f32 ds (B*H, Sq, Skv); the caller reduces it over
// the bias's broadcast dims. A row whose keys all carry NEG_INF (-1e30) bias
// gets the gradients of the plain softmax's uniform average, never NaN.
//
// Bound on the H100: on the main path (T5-xl encoder, 8 x 32 heads x 160 x
// 64, bf16, (8,32,160,160) f32 bias, no ds) the five products are ~4.2 GFLOP
// (~4 us at 989 TFLOP/s) against ~63 MB of q/k/v/dO/dq/dk/dv and bias (~19 us
// at 3.35 TB/s), so the card's limit is memory.
//
// Two bodies, chosen by the caller (videotgb_torch/ops/attention.py::
// flash_body, the rule of kernel A, on q, k, v and dO) and passed as `body`:
//   * the tensor-core body (flash_bwd_mma.cuh), for bf16 inputs with 16-byte
//     rows, every shape the port's paths hand this kernel: mma.sync for all
//     five products; one launch of one block per (batch*head) where the
//     head's keys and its P and dS fit a block (Skv <= 160 and the shared
//     memory rule of flash_bwd_mma.cuh::one_pass, mirrored by ops/
//     attention.py::flash_bwd_passes: the T5 encoder's 160 x 160 at D = 64),
//     else a rows pass and a columns pass on the same tile routines;
//   * the CUDA-core body (below), for f32 inputs (a tensor-core f32 product
//     would be TF32) and bf16 rows that are not 16-byte aligned: two passes
//     of plain FMAs, 9 products per score where 5 are needed:
//       - pass 1, one block per (batch*head, 32-row q tile), 8 warps x 4
//         rows: a sweep over 32-key K/V tiles keeps the online row max m,
//         sum l and sum of exp(s - m) dp (lane j scores key j, as in
//         flash_fma.cuh), which give delta = rowsum(dp p); a second sweep
//         recomputes p and dp, forms ds, writes it where the bias needs its
//         gradient, and accumulates dq (lane d owns dims d, d+32, ...); m,
//         l and delta go to a small f32 scratch (3, B*H, Sq);
//       - pass 2, one block per (batch*head, 32-key k tile), 8 warps x 4
//         keys: a loop over 32-row Q/dO tiles recomputes p from m and l
//         (lane i scores query i) and ds from delta, and accumulates dk and
//         dv in registers; the bias tile is staged in shared memory so that
//         its reads stay coalesced along the keys.
// Neither body uses atomics: the sums that cross tiles (dq over the keys,
// dk and dv over the queries) stay in one block or go through the two
// passes, so two runs on the same inputs give the same bits. Both address
// q/k/v/dO/dq/dk/dv through (batch, head, seq) strides, so the (B, S, H, D)
// projections are read and the gradients written without transpose copies,
// and the bias through 4 strides, 0 on broadcast dims, so the shared
// (1,1,S,S), per-batch (B,1,S,S), (B,1,1,S) padding, per-query (B,1,S,1),
// (1,H,S,S) and (B,H,S,S) layouts are read without materialising a
// broadcast. Ragged sequence tails are masked in the kernel; nothing is
// padded in HBM.
#include "flash_bwd_mma.cuh"

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 4;                  // rows (queries or keys) per warp
constexpr int kTile = kWarps * kRows;     // 32 rows per block
constexpr int kCols = 32;                 // inner tile: one per lane
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

using flash_grad::Params;

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
// x rounded to T's precision and back
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// rows [row0, row0 + kTile) of a (seq, D) slice into dst[kTile][ld], the
// head dim zero-padded to DP and rows past n_rows zeroed
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long ss, int row0, int n_rows,
                                          int D, int DP) {
  for (int i = threadIdx.x; i < kTile * DP; i += kThreads) {
    const int r = i / DP;
    const int d = i - r * DP;
    float x = 0.f;
    if (row0 + r < n_rows && d < D) x = to_f(src[(row0 + r) * ss + d]);
    dst[r * ld + d] = x;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

template <int NC>
constexpr int rows_smem_floats() {
  // Q, dO [32][DP] (row-broadcast reads), K, V [32][DP+4] (lane-strided),
  // ds [32][32]
  return 2 * kTile * (NC * 32) + 2 * kCols * (NC * 32 + 4) + kTile * kCols;
}

template <int NC>
constexpr int cols_smem_floats() {
  // K, V [32][DP] (row-broadcast), Q, dO [32][DP+4] (lane-strided),
  // bias [32][33], p and ds [32][32] each
  return 2 * kTile * (NC * 32) + 2 * kCols * (NC * 32 + 4) +
         kCols * (kTile + 1) + 2 * kTile * kCols;
}

// ---------------------------------------------------------------- pass 1
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_rows(const Params p) {
  constexpr int DP = NC * 32;
  constexpr int KS = DP + 4;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Gs = Qs + kTile * DP;
  float* Ks = Gs + kTile * DP;
  float* Vs = Ks + kCols * KS;
  float* DSs = Vs + kCols * KS;

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = blockIdx.y * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* gg = static_cast<const T*>(p.g) + b * p.g_sb + h * p.g_sh;
  T* dqg = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  const float* bg = p.bias ? p.bias + b * p.b_sb + h * p.b_sh : nullptr;

  load_tile<T>(Qs, DP, qg, p.q_ss, q0, p.Sq, p.D, DP);
  load_tile<T>(Gs, DP, gg, p.g_ss, q0, p.Sq, p.D, DP);

  const int n_tiles = (p.Skv + kCols - 1) / kCols;

  // s = q.k and dp = dO.v of this lane's key for the warp's rows
  auto products = [&](float (&s)[kRows], float (&dp)[kRows]) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = dp[r] = 0.f;
    const float4* krow = reinterpret_cast<const float4*>(Ks + lane * KS);
    const float4* vrow = reinterpret_cast<const float4*>(Vs + lane * KS);
#pragma unroll
    for (int d4 = 0; d4 < DP / 4; ++d4) {
      const float4 kv = krow[d4];
      const float4 vv = vrow[d4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int row = warp * kRows + r;
        const float4 qv = reinterpret_cast<const float4*>(Qs + row * DP)[d4];
        const float4 gv = reinterpret_cast<const float4*>(Gs + row * DP)[d4];
        s[r] = fmaf(qv.x, kv.x, s[r]);
        s[r] = fmaf(qv.y, kv.y, s[r]);
        s[r] = fmaf(qv.z, kv.z, s[r]);
        s[r] = fmaf(qv.w, kv.w, s[r]);
        dp[r] = fmaf(gv.x, vv.x, dp[r]);
        dp[r] = fmaf(gv.y, vv.y, dp[r]);
        dp[r] = fmaf(gv.z, vv.z, dp[r]);
        dp[r] = fmaf(gv.w, vv.w, dp[r]);
      }
    }
  };
  auto score = [&](float s, int qi, int kj) {
    float sr = s * p.scale;
    if (bg != nullptr && qi < p.Sq) sr += bg[qi * p.b_sq + kj * p.b_sk];
    return sr;
  };

  // sweep 1: online row max m, sum l and sum of exp(s - m) * dp
  float m[kRows], l[kRows], dl[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
    dl[r] = 0.f;
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kCols;
    __syncthreads();  // the previous tile is consumed (and Q/dO are staged)
    load_tile<T>(Ks, KS, kg, p.k_ss, k0, p.Skv, p.D, DP);
    load_tile<T>(Vs, KS, vg, p.v_ss, k0, p.Skv, p.D, DP);
    __syncthreads();
    const int kj = k0 + lane;
    const bool kvalid = kj < p.Skv;
    float s[kRows], dp[kRows];
    products(s, dp);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qi = q0 + warp * kRows + r;
      const float sr = kvalid ? score(s[r], qi, kj) : -INFINITY;
      // every tile holds at least one key in range, so the max is finite
      const float mn = fmaxf(m[r], warp_max(sr));
      const float alpha = expf(m[r] - mn);  // 0 on the first tile
      const float pr = kvalid ? expf(sr - mn) : 0.f;
      m[r] = mn;
      l[r] = l[r] * alpha + pr;
      dl[r] = dl[r] * alpha + pr * dp[r];
    }
  }
  float delta[kRows];
  const long long n_stats = static_cast<long long>(p.BH) * p.Sq;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    l[r] = warp_sum(l[r]);
    delta[r] = warp_sum(dl[r]) / l[r];
    const int qi = q0 + warp * kRows + r;
    if (lane == 0 && qi < p.Sq) {
      const long long at = static_cast<long long>(bh) * p.Sq + qi;
      p.stats[at] = m[r];
      p.stats[n_stats + at] = l[r];
      p.stats[2 * n_stats + at] = delta[r];
    }
  }

  // sweep 2: ds = p (dp - delta) and dq = sum_j ds_j k_j
  float acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kCols;
    __syncthreads();
    load_tile<T>(Ks, KS, kg, p.k_ss, k0, p.Skv, p.D, DP);
    load_tile<T>(Vs, KS, vg, p.v_ss, k0, p.Skv, p.D, DP);
    __syncthreads();
    const int kj = k0 + lane;
    const bool kvalid = kj < p.Skv;
    float s[kRows], dp[kRows];
    products(s, dp);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = warp * kRows + r;
      const int qi = q0 + row;
      float dsr = 0.f;
      if (kvalid) {
        const float pr = expf(score(s[r], qi, kj) - m[r]) / l[r];
        dsr = pr * (dp[r] - delta[r]);
        if (p.ds != nullptr && qi < p.Sq)
          p.ds[(static_cast<long long>(bh) * p.Sq + qi) * p.Skv + kj] = dsr;
      }
      DSs[row * kCols + lane] = round_to<T>(dsr);
    }
    __syncwarp();
#pragma unroll 8
    for (int j = 0; j < kCols; ++j) {
      float kk[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) kk[c] = Ks[j * KS + c * 32 + lane];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float dsj = DSs[(warp * kRows + r) * kCols + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(dsj, kk[c], acc[r][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + warp * kRows + r;
    if (qi >= p.Sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = c * 32 + lane;
      if (d < p.D) dqg[qi * p.dq_ss + d] = from_f<T>(acc[r][c] * p.scale);
    }
  }
}

// ---------------------------------------------------------------- pass 2
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_cols(const Params p) {
  constexpr int DP = NC * 32;
  constexpr int QS = DP + 4;
  constexpr int BS = kCols + 1;   // bias tile row stride: conflict-free
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kTile * DP;
  float* Qs = Vs + kTile * DP;
  float* Gs = Qs + kCols * QS;
  float* Bs = Gs + kCols * QS;    // [query][key]
  float* Ps = Bs + kCols * BS;    // [key][query]
  float* DSs = Ps + kTile * kCols;

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int k0 = blockIdx.y * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* gg = static_cast<const T*>(p.g) + b * p.g_sb + h * p.g_sh;
  T* dkg = static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  T* dvg = static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  const float* bg = p.bias ? p.bias + b * p.b_sb + h * p.b_sh : nullptr;
  const long long n_stats = static_cast<long long>(p.BH) * p.Sq;
  const float* stats = p.stats + static_cast<long long>(bh) * p.Sq;

  load_tile<T>(Ks, DP, kg, p.k_ss, k0, p.Skv, p.D, DP);
  load_tile<T>(Vs, DP, vg, p.v_ss, k0, p.Skv, p.D, DP);

  float dk[kRows][NC], dv[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[r][c] = dv[r][c] = 0.f;

  const int n_tiles = (p.Sq + kCols - 1) / kCols;
  for (int t = 0; t < n_tiles; ++t) {
    const int i0 = t * kCols;
    __syncthreads();  // the previous tile is consumed (and K/V are staged)
    load_tile<T>(Qs, QS, qg, p.q_ss, i0, p.Sq, p.D, DP);
    load_tile<T>(Gs, QS, gg, p.g_ss, i0, p.Sq, p.D, DP);
    if (bg != nullptr) {
      for (int i = threadIdx.x; i < kCols * kTile; i += kThreads) {
        const int qr = i / kTile;
        const int kc = i - qr * kTile;
        const int qi = i0 + qr;
        const int kj = k0 + kc;
        Bs[qr * BS + kc] = (qi < p.Sq && kj < p.Skv)
                               ? bg[qi * p.b_sq + kj * p.b_sk] : 0.f;
      }
    }
    __syncthreads();

    const int qi = i0 + lane;
    const bool qvalid = qi < p.Sq;
    float mi = 0.f, li = 1.f, di = 0.f;
    if (qvalid) {
      mi = stats[qi];
      li = stats[n_stats + qi];
      di = stats[2 * n_stats + qi];
    }
    float s[kRows], dp[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = dp[r] = 0.f;
    const float4* qrow = reinterpret_cast<const float4*>(Qs + lane * QS);
    const float4* grow = reinterpret_cast<const float4*>(Gs + lane * QS);
#pragma unroll
    for (int d4 = 0; d4 < DP / 4; ++d4) {
      const float4 qv = qrow[d4];
      const float4 gv = grow[d4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int key = warp * kRows + r;
        const float4 kv = reinterpret_cast<const float4*>(Ks + key * DP)[d4];
        const float4 vv = reinterpret_cast<const float4*>(Vs + key * DP)[d4];
        s[r] = fmaf(qv.x, kv.x, s[r]);
        s[r] = fmaf(qv.y, kv.y, s[r]);
        s[r] = fmaf(qv.z, kv.z, s[r]);
        s[r] = fmaf(qv.w, kv.w, s[r]);
        dp[r] = fmaf(gv.x, vv.x, dp[r]);
        dp[r] = fmaf(gv.y, vv.y, dp[r]);
        dp[r] = fmaf(gv.z, vv.z, dp[r]);
        dp[r] = fmaf(gv.w, vv.w, dp[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int key = warp * kRows + r;
      float pr = 0.f, dsr = 0.f;  // out-of-range queries contribute nothing
      if (qvalid && k0 + key < p.Skv) {
        float sr = s[r] * p.scale;
        if (bg != nullptr) sr += Bs[lane * BS + key];
        pr = expf(sr - mi) / li;
        dsr = pr * (dp[r] - di);
      }
      Ps[key * kCols + lane] = round_to<T>(pr);
      DSs[key * kCols + lane] = round_to<T>(dsr);
    }
    __syncwarp();
#pragma unroll 8
    for (int i = 0; i < kCols; ++i) {
      float gi[NC], qq[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        gi[c] = Gs[i * QS + c * 32 + lane];
        qq[c] = Qs[i * QS + c * 32 + lane];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int key = warp * kRows + r;
        const float pi = Ps[key * kCols + i];
        const float dsi = DSs[key * kCols + i];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dv[r][c] = fmaf(pi, gi[c], dv[r][c]);
          dk[r][c] = fmaf(dsi, qq[c], dk[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int kj = k0 + warp * kRows + r;
    if (kj >= p.Skv) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = c * 32 + lane;
      if (d < p.D) {
        dkg[kj * p.dk_ss + d] = from_f<T>(dk[r][c] * p.scale);
        dvg[kj * p.dv_ss + d] = from_f<T>(dv[r][c]);
      }
    }
  }
}

template <typename T, int NC>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int smem_rows = rows_smem_floats<NC>() * static_cast<int>(sizeof(float));
  const int smem_cols = cols_smem_floats<NC>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_rows<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_rows);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_cols<T, NC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_cols);
  if (err != cudaSuccess) return err;
  const dim3 grid_rows(p.BH, (p.Sq + kTile - 1) / kTile);
  flash_bwd_rows<T, NC><<<grid_rows, kThreads, smem_rows, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_cols(p.BH, (p.Skv + kTile - 1) / kTile);
  flash_bwd_cols<T, NC><<<grid_cols, kThreads, smem_cols, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, cudaStream_t stream) {
  switch ((p.D + 31) / 32) {
    case 1: return launch<T, 1>(p, stream);
    case 2: return launch<T, 2>(p, stream);
    case 3: return launch<T, 3>(p, stream);
    case 4: return launch<T, 4>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; body: 0 = CUDA cores, 1 = tensor cores
// (bf16 with D % 8 == 0, 16-byte aligned pointers and strides that are
// multiples of 8 elements; anything else is refused with
// cudaErrorInvalidValue). bias and ds may be null (then the bias strides are
// ignored). stats is f32 scratch of 3 * B * H * Sq floats, written and read
// by the two-pass launches (every CUDA-core launch; a tensor-core launch
// where flash_grad::mma_body::one_pass is false). Returns the first launch's
// failing cudaError_t, or 0; the kernels do not synchronise.
extern "C" int flash_bwd(
    const void* q, const void* k, const void* v, const void* bias,
    const void* g, void* dq, void* dk, void* dv, void* ds, void* stats,
    int B, int H, int Sq, int Skv, int D,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long g_sb, long long g_sh, long long g_ss,
    long long dq_sb, long long dq_sh, long long dq_ss,
    long long dk_sb, long long dk_sh, long long dk_ss,
    long long dv_sb, long long dv_sh, long long dv_ss,
    long long b_sb, long long b_sh, long long b_sq, long long b_sk,
    float scale, int dtype, int body, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || D <= 0 || D > 128 ||
      stats == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.g = g;
  p.bias = static_cast<const float*>(bias);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.ds = static_cast<float*>(ds);
  p.stats = static_cast<float*>(stats);
  p.H = H;
  p.Sq = Sq;
  p.Skv = Skv;
  p.D = D;
  p.BH = B * H;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.g_sb = g_sb; p.g_sh = g_sh; p.g_ss = g_ss;
  p.dq_sb = dq_sb; p.dq_sh = dq_sh; p.dq_ss = dq_ss;
  p.dk_sb = dk_sb; p.dk_sh = dk_sh; p.dk_ss = dk_ss;
  p.dv_sb = dv_sb; p.dv_sh = dv_sh; p.dv_ss = dv_ss;
  p.b_sb = b_sb; p.b_sh = b_sh; p.b_sq = b_sq; p.b_sk = b_sk;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (body == flash_grad::kBodyMma) {
    if (dtype == 1 && flash_grad::mma_aligned(p))
      err = flash_grad::mma_body::dispatch(p, s);
  } else if (body == flash_grad::kBodyFma) {
    if (dtype == 0) err = dispatch<float>(p, s);
    if (dtype == 1) err = dispatch<__nv_bfloat16>(p, s);
  }
  return static_cast<int>(err);
}
