// The main loop shared by kernel H's two bodies (int8_mm.cu, bf16_mm.cu):
// C (M, N) = A (M, K) . B^T for row-major A (M, K) and B (N, K), both with K
// contiguous, on the tensor cores through mma.sync.
//
// The loop works in bytes of K. Both mma shapes it is instantiated with,
// m16n8k32 on s8 and m16n8k16 on bf16, take 32 bytes of K per step with the
// same register layout (four 32-bit A registers: rows g and g + 8, bytes 4t
// and 16 + 4t; two B registers: column g, bytes 4t and 16 + 4t; g = lane / 4,
// t = lane % 4), so one ldmatrix-fed loop serves both:
//   * a block owns a BM x BN tile of C; its warps split it into WM x WN
//     tiles, each a grid of 16 x 8 mma tiles with its accumulators in
//     registers;
//   * K is walked in 128-byte slices: each slice of A and B is copied into
//     shared memory by 16-byte cp.async (rows past M or N and chunks past K
//     are zero-filled), two slices in flight (the next slice's copies run
//     under this slice's products), rows padded to 144 bytes so that the
//     eight rows an ldmatrix phase reads fall on distinct banks;
//   * fragments come out of shared memory by ldmatrix.x4 (b16 8 x 8
//     matrices: a 16 x 32-byte A tile, or two 8 x 32-byte B tiles; the PTX
//     helpers are in mma_util.cuh);
//   * the epilogue converts each accumulator and stores it with bounds
//     checks (two neighbouring columns in one store where N is even).
// wgmma, TMA and deeper pipelines are later work.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_util.cuh"

namespace mma_gemm {

constexpr int kSliceBytes = 128;              // bytes of K per slice
constexpr int kRowBytes = kSliceBytes + 16;   // padded shared-memory row
constexpr int kChunks = kSliceBytes / 16;     // 16-byte copies per row slice

using mma_util::cp_async16;
using mma_util::cp_async_commit;
using mma_util::cp_async_wait;
using mma_util::ldmatrix_x4;
using mma_util::smem_addr;

// Warp tiles of WM x WN in a block tile of BM x BN.
template <int BM_, int BN_, int WM_, int WN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int kWarpsN = BN / WN;
  static constexpr int kThreads = (BM / WM) * kWarpsN * 32;
  static constexpr int MI = WM / 16;  // mma tiles per warp, down
  static constexpr int NI = WN / 8;   // and across
  static constexpr int kStageBytes = (BM + BN) * kRowBytes;
  static constexpr int kSmemBytes = 2 * kStageBytes;
  static_assert(WM % 16 == 0 && WN % 16 == 0, "whole ldmatrix.x4 tiles");
  static_assert((BM * kChunks) % kThreads == 0 &&
                    (BN * kChunks) % kThreads == 0,
                "whole copies per thread");
};

// copy bytes [k0, k0 + 128) of rows [r0, r0 + ROWS) of a row-major (rows,
// kbytes) matrix into a [ROWS][kRowBytes] shared tile
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_slice(uint8_t* dst, const uint8_t* src,
                                           int rows, int kbytes, int r0,
                                           int k0) {
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / THREADS; ++i) {
    const int c = threadIdx.x + i * THREADS;
    const int r = c / kChunks;
    const int kc = k0 + (c % kChunks) * 16;
    const bool valid = r0 + r < rows && kc < kbytes;
    const uint8_t* g =
        valid ? src + static_cast<size_t>(r0 + r) * kbytes + kc : src;
    cp_async16(smem_addr(dst + r * kRowBytes + (c % kChunks) * 16), g, valid);
  }
}

// Op supplies: Acc (the accumulator's type), mma(acc[4], a[4], b[2]) and
// store(C, row, col, x, y, M, N, out_kind) of two neighbouring columns.
template <class Op, class T>
__global__ void __launch_bounds__(T::kThreads)
gemm_kernel(const uint8_t* __restrict__ A, const uint8_t* __restrict__ B,
            void* __restrict__ C, int M, int N, int kbytes, int out_kind) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm0 = (warp / T::kWarpsN) * T::WM;
  const int wn0 = (warp % T::kWarpsN) * T::WN;
  const int m0 = blockIdx.y * T::BM;
  const int n0 = blockIdx.x * T::BN;

  typename Op::Acc acc[T::MI][T::NI][4];
#pragma unroll
  for (int i = 0; i < T::MI; ++i)
#pragma unroll
    for (int j = 0; j < T::NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  auto stage = [&](int s) { return smem + s * T::kStageBytes; };
  auto load = [&](int s, int slice) {
    uint8_t* sa = stage(s);
    load_slice<T::BM, T::kThreads>(sa, A, M, kbytes, m0, slice * kSliceBytes);
    load_slice<T::BN, T::kThreads>(sa + T::BM * kRowBytes, B, N, kbytes, n0,
                                   slice * kSliceBytes);
  };

  // ldmatrix row addresses: A tiles take rows lane % 16 at byte 16 *
  // (lane / 16); a pair of B tiles takes rows (lane % 8) + 8 * (lane / 16)
  // at byte 16 * ((lane / 8) % 2)
  const int a_row = lane & 15, a_col = (lane >> 4) * 16;
  const int b_row = (lane & 7) + ((lane >> 4) << 3);
  const int b_col = ((lane >> 3) & 1) * 16;

  const int slices = (kbytes + kSliceBytes - 1) / kSliceBytes;
  load(0, 0);
  cp_async_commit();
  for (int s = 0; s < slices; ++s) {
    if (s + 1 < slices) load((s + 1) & 1, s + 1);
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: slice s has landed
    __syncthreads();
    const uint8_t* sa = stage(s & 1);
    const uint8_t* sb = sa + T::BM * kRowBytes;
#pragma unroll
    for (int kk = 0; kk < kSliceBytes; kk += 32) {
      uint32_t a[T::MI][4], b[T::NI][2];
#pragma unroll
      for (int i = 0; i < T::MI; ++i)
        ldmatrix_x4(a[i], smem_addr(sa + (wm0 + i * 16 + a_row) * kRowBytes +
                                    kk + a_col));
#pragma unroll
      for (int j = 0; j < T::NI; j += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, smem_addr(sb + (wn0 + j * 8 + b_row) * kRowBytes +
                                 kk + b_col));
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < T::MI; ++i)
#pragma unroll
        for (int j = 0; j < T::NI; ++j) Op::mma(acc[i][j], a[i], b[j]);
    }
    __syncthreads();  // slice s is consumed before its buffer is refilled
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < T::MI; ++i)
#pragma unroll
    for (int j = 0; j < T::NI; ++j) {
      const int row = m0 + wm0 + i * 16 + g;
      const int col = n0 + wn0 + j * 8 + 2 * t;
      Op::store(C, row, col, acc[i][j][0], acc[i][j][1], M, N, out_kind);
      Op::store(C, row + 8, col, acc[i][j][2], acc[i][j][3], M, N, out_kind);
    }
}

// C[row, col] = x and C[row, col + 1] = y, where in bounds; one store for
// the pair where N is even (then row * N + col is even: the pair is aligned)
__device__ __forceinline__ void store_pair(void* C, int row, int col, int x,
                                           int y, int M, int N) {
  if (row >= M || col >= N) return;
  int* p = static_cast<int*>(C) + static_cast<size_t>(row) * N + col;
  if (col + 1 < N && (N & 1) == 0) {
    *reinterpret_cast<int2*>(p) = make_int2(x, y);
  } else {
    p[0] = x;
    if (col + 1 < N) p[1] = y;
  }
}

__device__ __forceinline__ void store_pair(void* C, int row, int col,
                                           __nv_bfloat16 x, __nv_bfloat16 y,
                                           int M, int N) {
  if (row >= M || col >= N) return;
  __nv_bfloat16* p =
      static_cast<__nv_bfloat16*>(C) + static_cast<size_t>(row) * N + col;
  if (col + 1 < N && (N & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(x, y);
  } else {
    p[0] = x;
    if (col + 1 < N) p[1] = y;
  }
}

template <class Op, class T>
cudaError_t launch(const void* a, const void* b, void* c, int M, int N,
                   int kbytes, int out_kind, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<Op, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM);
  gemm_kernel<Op, T><<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b), c, M, N,
      kbytes, out_kind);
  return cudaGetLastError();
}

// The block tilings every body instantiates, by index:
//   0: 128 x 128, 8 warps of 64 x 32 (the default);
//   1: 128 x 256, 8 warps of 64 x 64 (more reuse of each loaded byte);
//   2: 64 x 64, 4 warps of 32 x 32 (more blocks for small problems).
template <class Op>
cudaError_t dispatch(int tile, const void* a, const void* b, void* c, int M,
                     int N, int kbytes, int out_kind, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || kbytes <= 0 || kbytes % 16 != 0 ||
      (M + 63) / 64 > 65535)
    return cudaErrorInvalidValue;
  switch (tile) {
    case 0:
      return launch<Op, Tile<128, 128, 64, 32>>(a, b, c, M, N, kbytes,
                                                out_kind, stream);
    case 1:
      return launch<Op, Tile<128, 256, 64, 64>>(a, b, c, M, N, kbytes,
                                                out_kind, stream);
    case 2:
      return launch<Op, Tile<64, 64, 32, 32>>(a, b, c, M, N, kbytes,
                                              out_kind, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace mma_gemm
