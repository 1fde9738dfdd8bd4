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
// Integer sums are exact in any order, so every tiling is bit for bit the
// plain version.
//
// The products run on the tensor cores through
// wgmma.mma_async.sync.aligned.m64n{128,256}k32.s32.s8.s8 over the shared
// warp-specialised main loop (wgmma_gemm.cuh: TMA-fed 128-byte K stages in
// an mbarrier ring, one producer and one or two consumer warpgroups, a
// persistent grid). For 8-bit types wgmma takes both operands K-major from
// shared memory, so B comes as (N, K) with K contiguous: the port's dense
// weights are stored so (out, in), and the tools transpose the probe's
// (K, N) w once. K must be a multiple of 16 (TMA's 16-byte row pitch).
//
// Bound on the H100: at 8192^3 the work is 1.1e12 integer operations
// (0.556 ms at 1979 TOP/s dense) against 256 MB of operands and output
// (0.076 ms at 3.35 TB/s); at the W8A8 path's 4224 x 1408 x 6144 it is
// 73 GOP (0.0369 ms) against 118 MB (0.0353 ms): operations, with the
// int32 output's bytes close behind, so the epilogue's stores of one tile
// run while the producer already loads the next.
#include "wgmma_gemm.cuh"

namespace {

struct S8 {
  using Acc = int;

  template <int BN>
  static __device__ __forceinline__ void mma(int (&c)[BN / 2], uint64_t a,
                                             uint64_t b, int accumulate) {
    mma_util::Wgmma<BN>::s8(c, a, b, accumulate);
  }

  static __device__ __forceinline__ void store(void* C, int row, int col,
                                               int x, int y, int M, int N,
                                               int out_kind) {
    if (out_kind == 0) {
      wgmma_gemm::store_pair(C, row, col, x, y, M, N);
    } else {
      wgmma_gemm::store_pair(C, row, col,
                             __float2bfloat16_rn(__int2float_rn(x)),
                             __float2bfloat16_rn(__int2float_rn(y)), M, N);
    }
  }
};

}  // namespace

// a: device (M, K) int8, b: device (N, K) int8, both row-major and
// contiguous, 16-byte aligned; c: device (M, N), int32 (out_kind 0) or bf16
// (out_kind 1). tile: the block tiling (wgmma_gemm.cuh::dispatch).
// encode_ns: where the host time of the two TMA descriptor encodes is
// written (may be null). Returns the launch's cudaError_t, or 10000 + the
// CUresult of a failed encode; the kernel does not synchronise.
extern "C" int int8_mm(const void* a, const void* b, void* c, int M, int N,
                       int K, int out_kind, int tile, long long* encode_ns,
                       void* stream) {
  if (out_kind != 0 && out_kind != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return wgmma_gemm::dispatch<S8>(tile, a, b, c, M, N, K, out_kind,
                                  encode_ns,
                                  static_cast<cudaStream_t>(stream));
}
