// The main loop shared by kernel H's two bodies (int8_mm.cu, bf16_mm.cu):
// C (M, N) = A (M, K) . B^T for row-major A (M, K) and B (N, K), both with K
// contiguous, on Hopper's tensor cores through wgmma, for sm_90a.
//
// What held the earlier mma.sync design back: each warp fed
// mma.sync.m16n8k{16,32} from shared memory by ldmatrix, one ldmatrix for
// every 2-4 products, every thread issued cp.async copies and waited on
// them, and a __syncthreads closed each of the two 128-byte K slices in
// flight. Shared-memory reads and mma issue bound it at a quarter of the
// dense peak (248 TF/s bf16, 523 TOP/s int8 at 8192^3 on an H100).
//
// This design:
//   * wgmma.mma_async reads both operands straight from shared memory (for
//     8-bit types wgmma takes both from there, both K-major: the (N, K)
//     layout of B is what it wants, nothing is transposed), 64 rows of A by
//     BN = 128 or 256 columns of B per instruction, the sums in registers;
//   * a block is one producer warpgroup and BM / 64 consumer warpgroups.
//     One thread of the producer issues TMA loads of each stage's A (BM x
//     128 bytes) and B (BN x 128 bytes) tiles: 128 bytes of K a stage (64
//     bf16 or 128 int8), in the 128-byte swizzle that the wgmma
//     descriptors name (mma_util.cuh::wgmma_desc_sw128), stage bases
//     1024-byte aligned;
//   * a ring of STAGES stages, each with a full and an empty mbarrier: the
//     producer waits on empty, arms full with the stage's bytes and starts
//     the two loads; each consumer waits on full, issues the stage's four
//     k-steps, commits them as one group and keeps one group in flight
//     (wait_group 1), then releases the previous stage (one arrival a
//     warp). With two consumers the producer gives registers up to them
//     (setmaxnreg 40 / 232);
//   * TMA zero-fills rows past M or N and bytes past K, so the main loop has
//     no bounds checks and K need only be a multiple of 16 bytes (TMA's
//     row pitch);
//   * the grid is persistent: min(tiles, SMs x blocks a SM) blocks walk the
//     output tiles in groups of kGroupM tile rows (so the tiles running at
//     one time share rows of A and B in L2), and the producer loads the
//     next tile's stages while the consumers store this one's;
//   * the epilogue converts each accumulator and stores it from registers
//     with bounds checks (two neighbouring columns in one store where N is
//     even): N = 999 or 257 leaves int32 rows off the 16-byte pitch a TMA
//     store needs.
//
// The host encodes two TMA descriptors (CUtensorMap, 2-D, bytes) per call
// with cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint so
// that the libraries need no -lcuda, and passes them as __grid_constant__
// parameters. The encodes' host time is returned to the caller.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <chrono>

#include "mma_util.cuh"

namespace wgmma_gemm {

constexpr int kSliceBytes = 128;  // bytes of K per stage: one swizzle row
constexpr int kKSteps = 4;        // 32-byte wgmma k-steps per stage
constexpr int kGroupM = 8;        // tile rows walked together (L2 reuse)
// a C entry's return code for a failed descriptor encode: this + CUresult
constexpr int kEncodeError = mma_util::kEncodeError;

using mma_util::smem_addr;

// A block tile of BM x BN, STAGES stages, at least MIN_BLOCKS blocks a SM.
template <int BM_, int BN_, int STAGES_, int MIN_BLOCKS_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, STAGES = STAGES_;
  static constexpr int kMinBlocks = MIN_BLOCKS_;
  static constexpr int kConsumers = BM / 64;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kABytes = BM * kSliceBytes;
  static constexpr int kStageBytes = (BM + BN) * kSliceBytes;
  // the stages, 1024 bytes of slack to align them, full and empty barriers
  static constexpr int kSmemBytes = STAGES * kStageBytes + 1024 + 16 * STAGES;
  // two consumers need more than an even share of the registers
  static constexpr bool kRebalance = kConsumers > 1;
  static constexpr int kProducerRegs = 40, kConsumerRegs = 232;
  static_assert(BM == 64 || BM == 128, "one or two consumer warpgroups");
  static_assert(BN == 128 || BN == 256, "an m64n128 or m64n256 wgmma");
  static_assert(kSmemBytes * kMinBlocks <= 232448, "shared memory");
};

// output tile t -> (tile row, tile column), kGroupM tile rows at a time
__device__ __forceinline__ void tile_coords(int t, int tiles_m, int tiles_n,
                                            int& mb, int& nb) {
  const int group = kGroupM * tiles_n;
  const int first = (t / group) * kGroupM;
  const int rows = min(tiles_m - first, kGroupM);
  mb = first + (t % group) % rows;
  nb = (t % group) / rows;
}

// Op supplies: Acc (the accumulator's type), mma<BN>(acc, desc_a, desc_b,
// accumulate) and store(C, row, col, x, y, M, N, out_kind) of two
// neighbouring columns.
template <class Op, class T>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
gemm_kernel(const __grid_constant__ CUtensorMap tma_a,
            const __grid_constant__ CUtensorMap tma_b, void* __restrict__ C,
            int M, int N, int kbytes, int out_kind) {
  extern __shared__ uint8_t smem[];
  const uint32_t base = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t bars = base + T::STAGES * T::kStageBytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (T::STAGES + s); };
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mma_util::mbar_init(full(s), 1);
      mma_util::mbar_init(empty(s), 4 * T::kConsumers);  // one a warp
    }
    mma_util::mbar_init_fence();
  }
  __syncthreads();

  const int tiles_m = (M + T::BM - 1) / T::BM;
  const int tiles_n = (N + T::BN - 1) / T::BN;
  const int tiles = tiles_m * tiles_n;
  const int slices = (kbytes + kSliceBytes - 1) / kSliceBytes;
  const int wg = threadIdx.x / 128;

  if (wg == 0) {  // the producer
    if constexpr (T::kRebalance)
      mma_util::setmaxnreg_dec<T::kProducerRegs>();
    if (threadIdx.x != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int mb, nb;
      tile_coords(t, tiles_m, tiles_n, mb, nb);
      for (int s = 0; s < slices; ++s) {
        mma_util::mbar_wait(empty(stage), phase ^ 1);  // round 0 passes
        mma_util::mbar_arrive_expect_tx(full(stage), T::kStageBytes);
        const uint32_t sa = base + stage * T::kStageBytes;
        mma_util::tma_load_2d(sa, &tma_a, full(stage), s * kSliceBytes,
                              mb * T::BM);
        mma_util::tma_load_2d(sa + T::kABytes, &tma_b, full(stage),
                              s * kSliceBytes, nb * T::BN);
        if (++stage == T::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {  // a consumer: rows [64 * cw, 64 * cw + 64) of each tile
    if constexpr (T::kRebalance)
      mma_util::setmaxnreg_inc<T::kConsumerRegs>();
    const int cw = wg - 1;
    const int lane = threadIdx.x & 31;
    typename Op::Acc acc[T::BN / 2];
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int prev = 0;
      for (int s = 0; s < slices; ++s) {
        mma_util::mbar_wait(full(stage), phase);
        const uint32_t sa = base + stage * T::kStageBytes;
        const uint64_t da = mma_util::wgmma_desc_sw128(sa + cw * 64 * 128);
        const uint64_t db = mma_util::wgmma_desc_sw128(sa + T::kABytes);
        mma_util::wgmma_fence();
#pragma unroll
        for (int k = 0; k < kKSteps; ++k)
          Op::template mma<T::BN>(acc, da + 2 * k, db + 2 * k, s | k);
        mma_util::wgmma_commit();
        // Keep this stage's group in flight and wait for the previous one,
        // except on the tile's last stage: there wait for all, inside the
        // loop (with that wait after the loop, ptxas moved conversions of
        // the accumulators above it, and the bf16 results were wrong).
        if (s + 1 < slices) {
          mma_util::wgmma_wait<1>();
        } else {
          mma_util::wgmma_wait<0>();
        }
        if (s > 0 && lane == 0) mma_util::mbar_arrive(empty(prev));
        prev = stage;
        if (++stage == T::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      mma_util::fence_regs(acc);
      if (lane == 0) mma_util::mbar_arrive(empty(prev));

      int mb, nb;
      tile_coords(t, tiles_m, tiles_n, mb, nb);
      // accumulator i of lane (g, q) = (lane / 4, lane % 4) of warp w:
      // row 16 w + g + 8 ((i / 2) % 2), column 8 (i / 4) + 2 q + i % 2
      const int row = mb * T::BM + cw * 64 + ((threadIdx.x / 32) & 3) * 16 +
                      (lane >> 2);
      const int col = nb * T::BN + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < T::BN / 8; ++j) {
        Op::store(C, row, col + 8 * j, acc[4 * j], acc[4 * j + 1], M, N,
                  out_kind);
        Op::store(C, row + 8, col + 8 * j, acc[4 * j + 2], acc[4 * j + 3], M,
                  N, out_kind);
      }
      mma_util::fence_regs(acc);  // the next tile's products come after
    }
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

// ------------------------------------------------------------------ host
using mma_util::EncodeTiled;
using mma_util::encode_tiled;

// a row-major (rows, kbytes) byte matrix in boxes of box_rows x 128 bytes,
// 128-byte swizzle, zeros past its edges; no L2 promotion (promoting the
// 128-byte box rows to 256-byte L2 fetches made the int8 products 5-10%
// slower on an H100, bf16 no faster)
inline CUresult encode(CUtensorMap* map, EncodeTiled fn, const void* ptr,
                       int rows, int kbytes, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kbytes),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kbytes)};
  const cuuint32_t box[2] = {kSliceBytes, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr),
            dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

template <class Op, class T>
int launch(const void* a, const void* b, void* c, int M, int N, int kbytes,
           int out_kind, long long* encode_ns, cudaStream_t stream) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap ta, tb;
  const auto t0 = std::chrono::steady_clock::now();
  CUresult r = encode(&ta, fn, a, M, kbytes, T::BM);
  if (r == CUDA_SUCCESS) r = encode(&tb, fn, b, N, kbytes, T::BN);
  if (encode_ns != nullptr)
    *encode_ns = std::chrono::duration_cast<std::chrono::nanoseconds>(
                     std::chrono::steady_clock::now() - t0)
                     .count();
  if (r != CUDA_SUCCESS) return kEncodeError + static_cast<int>(r);

  auto kernel = gemm_kernel<Op, T>;
  if constexpr (T::kRebalance) {
    // setmaxnreg moves registers within the block's allocation: refuse a
    // build whose allocation cannot hold the rebalanced counts (the
    // consumers would wait for registers forever)
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (attr.numRegs * T::kThreads <
        128 * (T::kProducerRegs + T::kConsumers * T::kConsumerRegs))
      return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = static_cast<long long>((M + T::BM - 1) / T::BM) *
                          ((N + T::BN - 1) / T::BN);
  const long long slots = static_cast<long long>(sm_count()) * T::kMinBlocks;
  if (tiles > (1ll << 31) - 1 || slots <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(tiles < slots ? tiles : slots);
  kernel<<<grid, T::kThreads, T::kSmemBytes, stream>>>(ta, tb, c, M, N,
                                                      kbytes, out_kind);
  return static_cast<int>(cudaGetLastError());
}

// The block tilings every body instantiates, by index (ops/quant.py::TILES):
//   0: 128 x 128, two consumers, 6 stages (192 KB), one block a SM;
//   1: 128 x 256, two consumers, 4 stages (192 KB), one block a SM;
//   2: 64 x 128, one consumer, 4 stages (96 KB), two blocks a SM (one
//      block's stores run under the other's products; for small M).
// Returns a cudaError_t, or kEncodeError + the CUresult of a failed encode.
template <class Op>
int dispatch(int tile, const void* a, const void* b, void* c, int M, int N,
             int kbytes, int out_kind, long long* encode_ns,
             cudaStream_t stream) {
  if (M <= 0 || N <= 0 || kbytes <= 0 || kbytes % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (tile) {
    case 0:
      return launch<Op, Tile<128, 128, 6, 1>>(a, b, c, M, N, kbytes,
                                              out_kind, encode_ns, stream);
    case 1:
      return launch<Op, Tile<128, 256, 4, 1>>(a, b, c, M, N, kbytes,
                                              out_kind, encode_ns, stream);
    case 2:
      return launch<Op, Tile<64, 128, 4, 2>>(a, b, c, M, N, kbytes, out_kind,
                                             encode_ns, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace wgmma_gemm
