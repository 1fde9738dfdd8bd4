// Kernel H, int8 body: C (M, N) = A (M, K) int8 . B (N, K)^T int8 with an
// int32 accumulator, for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel tools/int8pallas_probe.py::mm_kernel
// (driven by pallas_int8_mm): x (M, K) int8 times w (K, N) int8, summed in
// int32 over K blocks, written as bf16. On the card it also carries the
// W8A8 serving path's products (videotgb_torch/ops/quant.py::int8_matmul,
// the counterpart of videotgb_tpu/ops/quant.py), which need the int32
// accumulator itself. Two epilogues over one main loop:
//   * out_kind 0: the int32 accumulator (the serving path dequantizes it);
//   * out_kind 1: bf16, rounded int32 -> f32 -> bf16 (round to nearest even
//     twice), as the probe's .astype(jnp.bfloat16) and torch's cast round
//     it: accumulators reach 127^2 * 8192 > 2^24, where one direct rounding
//     would differ.
//
// The products run on the tensor cores through
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 (mma_gemm.cuh: 128-byte
// K slices by cp.async, two in flight, ldmatrix fragments). The s8 mma
// exists only as .row.col and ldmatrix has no transpose for 8-bit values, so
// B comes as (N, K) with K contiguous: the port's dense weights are stored
// so (out, in), and the tools transpose the probe's (K, N) w once. K must be
// a multiple of 16 (16-byte copies).
//
// Bound on the H100: at 8192^3 the work is 1.1e12 integer operations
// (0.556 ms at 1979 TOP/s dense) against 256 MB of operands and output
// (0.076 ms at 3.35 TB/s): operations. mma.sync issues at a fraction of the
// wgmma rate, so this version's own limit is the issue of mma.sync and of
// its ldmatrix loads.
#include "mma_gemm.cuh"

namespace {

struct S8 {
  using Acc = int;

  static __device__ __forceinline__ void mma(int (&c)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }

  static __device__ __forceinline__ void store(void* C, int row, int col,
                                               int x, int y, int M, int N,
                                               int out_kind) {
    if (out_kind == 0) {
      mma_gemm::store_pair(C, row, col, x, y, M, N);
    } else {
      mma_gemm::store_pair(C, row, col,
                           __float2bfloat16_rn(__int2float_rn(x)),
                           __float2bfloat16_rn(__int2float_rn(y)), M, N);
    }
  }
};

}  // namespace

// a: device (M, K) int8, b: device (N, K) int8, both row-major and
// contiguous; c: device (M, N), int32 (out_kind 0) or bf16 (out_kind 1).
// tile: the block tiling (mma_gemm.cuh::dispatch). Returns the launch's
// cudaError_t; the kernel does not synchronise.
extern "C" int int8_mm(const void* a, const void* b, void* c, int M, int N,
                       int K, int out_kind, int tile, void* stream) {
  if (out_kind != 0 && out_kind != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(mma_gemm::dispatch<S8>(
      tile, a, b, c, M, N, K, out_kind, static_cast<cudaStream_t>(stream)));
}
